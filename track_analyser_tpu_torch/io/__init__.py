"""Host I/O tier: the codec ladder (WAV/AIFF, FLAC, Ogg, MP3, ffmpeg) and
the loader."""

from .codecs import DECODE_ERRORS, AudioDecodeError, decode_file, decode_wav, write_wav
from .flac import decode_flac, encode_flac
from .loader import load_audio

__all__ = [
    "decode_file",
    "decode_wav",
    "write_wav",
    "decode_flac",
    "encode_flac",
    "load_audio",
    "AudioDecodeError",
    "DECODE_ERRORS",
]
