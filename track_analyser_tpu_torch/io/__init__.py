"""Host I/O tier: WAV/AIFF codecs."""

from .codecs import AudioDecodeError, decode_file, decode_wav, write_wav

__all__ = ["decode_file", "decode_wav", "write_wav", "AudioDecodeError"]
