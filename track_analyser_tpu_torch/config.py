"""Frozen configuration of the analysis pipeline.

The same tunables, names and defaults as ``track_analyser_tpu.config``
(the JAX reference), so a result from either package is computed with
the same constants. One typed, hashable object keeps every constant in
one place.
"""

from __future__ import annotations

import dataclasses

DEFAULT_SR = 44_100
DEFAULT_SEED = 13_370


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """All tunables of the analysis pipeline."""

    # Core signal handling
    target_sr: int = DEFAULT_SR
    seed: int = DEFAULT_SEED

    # Framing
    hop_length: int = 512
    n_fft: int = 2_048
    beats_per_bar: int = 4

    # Tempo search band
    bpm_min: float = 90.0
    bpm_max: float = 135.0

    # Mel / MFCC
    n_mels: int = 128
    n_mfcc: int = 13

    # Structure segmentation
    novelty_context_seconds: float = 2.0
    novelty_smooth_sigma: float = 1.5
    min_segment_spacing_seconds: float = 8.0
    boundary_refine_seconds: float = 3.0
    novelty_weights: tuple[float, float, float] = (0.5, 0.3, 0.2)
    hpss_kernel: int = 31
    hpss_power: float = 2.0

    # Loudness (EBU R128 / BS.1770)
    loudness_block_seconds: float = 0.400
    short_term_seconds: float = 3.0
    true_peak_oversample: int = 8
    gate_absolute_lufs: float = -70.0
    gate_relative_lu: float = -10.0

    # Harmony. Spectral balance rides the shared 2048/512 family
    # (fractional edge-bin weights, see ops/spectral.py).
    balance_n_fft: int = 2_048
    balance_hop: int = 512
    chord_window_frames: int = 2
    chord_change_threshold: float = 0.15
    chord_change_keep_fraction: float = 0.9

    # Spectral features
    rolloff_percent: float = 0.85

    # Chroma / key estimation: the three-resolution CQ filterbank
    # projection (ops/chroma.py cq_chroma_tribank).
    cq_n_fft: int = 8_192
    cq_bins_per_octave: int = 36
    cq_n_octaves: int = 7
    cq_fmin_midi: int = 24  # C1 = 32.703 Hz
    cq_low_n_fft: int = 4_096
    cq_mid_n_fft: int = 1_024
    cq_decim: int = 16
    cq_keep_hz: float = 1_050.0
    cq_low_octaves: int = 3
    cq_family_octave: int = 5
    # The long-window chroma is computed every cq_hop samples and repeated
    # up to hop_length resolution.
    cq_hop: int = 2_048

    # Fixed-capacity outputs
    max_beats: int = 4_096
    max_peaks: int = 256

    @property
    def frames_per_second(self) -> float:
        return self.target_sr / float(self.hop_length)


DEFAULT_CONFIG = AnalysisConfig()
