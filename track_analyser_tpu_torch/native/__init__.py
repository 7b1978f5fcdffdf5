"""The native host library: WAV/FLAC decode, the transport quantisers and
the ffmpeg decode tier, in C++ built at first use (``native/build.py``)
and bound with ctypes (``native/binding.py``, ``io/ffmpeg.py``)."""
