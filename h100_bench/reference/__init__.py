"""The benchmark's plain reference: a written, independent account of what
the analysis must answer for one audio file.

It follows the semantics of the JAX package (the system's specification),
re-derived here in numpy, scipy and plain PyTorch; it imports nothing of
the JAX package or of the program under test, and takes nothing that the
program made: it reads the WAV file itself.

- ``audio``: the WAV decode, the 22.05 -> 44.1 kHz resample, the "ms"
  transport (the mid channel as blockwise int8, dequantised as the device
  sees it) and the host-exact stereo sums and band widths;
- ``graph``: the fused graph's STFT family in float64 (or, for the
  precision control, float32 with TF32 operands to every matmul and
  convolution): the mel onset envelope, MFCC
  self-similarity, HPSS by plain sliding medians, the novelty curve,
  long-term spectrum, centroid, spectral balance, the x8 true peak;
- ``finish``: BS.1770 loudness on the host, the tempo and beat grid, and
  the answer as a nested dict of the result's field names.

``analyse(path, device=..., control=False)`` returns that dict.
"""

from __future__ import annotations

from .finish import analyse

__all__ = ["analyse"]
