"""Host I/O tier: WAV/AIFF codecs and the loader."""

from .codecs import AudioDecodeError, decode_file, decode_wav, write_wav
from .loader import load_audio

__all__ = ["decode_file", "decode_wav", "write_wav", "load_audio", "AudioDecodeError"]
