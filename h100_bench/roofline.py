"""The yardstick's own counts of the work a kernel must do, from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (80 GB HBM3, 700 W):
3.35 TB/s of HBM bandwidth. The counts never ask the program how its
kernels work: they follow from the track's length at the analysis rate
and the graph's STFT (n_fft 2048, hop 512, centred). They count the
track's own frames, not the padding a transport may add: work on padded
frames is work the bound does not owe.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
ANALYSIS_SR = 44_100
HOP = 512
BINS = 1025  # n_fft 2048 // 2 + 1


def analysis_samples(frames: int, sample_rate: int) -> int:
    """Samples of a track after resampling to the analysis rate (scipy's
    ``resample_poly`` output length)."""

    if sample_rate == ANALYSIS_SR:
        return int(frames)
    g = math.gcd(ANALYSIS_SR, int(sample_rate))
    up, down = ANALYSIS_SR // g, int(sample_rate) // g
    return -(-int(frames) * up // down)


def hpss_frames(samples: int) -> int:
    """Frames F of the track's own (1025, F) spectrogram that HPSS filters:
    its centred STFT, ``1 + samples // 512``."""

    return 1 + int(samples) // HOP


def median31_bytes(frames: int) -> int:
    """Bytes one sliding median of a (1025, F) float32 input must move:
    the input read once and the output written once."""

    return 2 * BINS * int(frames) * 4


def median31_bound_s(frames: int) -> float:
    """The least time one such median can take on the card: its bytes
    over the HBM bandwidth (its min/max bind later; PERF.md section 6)."""

    return median31_bytes(frames) / HBM_BYTES_PER_S
