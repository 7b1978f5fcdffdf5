"""The port's per-module path, ``analyse_track(fused=False)``, against the
JAX package's, on the CPU.

Both packages get ``test_torch_pipeline``'s 20 s stereo fixture (made
with numpy, with a -50 dBFS noise floor); the port runs its plain PyTorch
path (``device="cpu"``) and the JAX package its CPU path. Each field group
is held by ``test_torch_pipeline``'s own check at its tolerances (BPM 1e-3,
beat and downbeat times 1e-4 s, tracked beats 12 ms, LUFS, true peak and
RMS 5e-3 dB, loudness curves 2e-2 dB, novelty 1e-3; key, chords, section
count and MIDI exact). Bar positions are exact, or an exact tie of the
bar-position Viterbi that float rounding decides, proven as there.

The port's per-module result is also held against its own fused result
(``chip_smoke.compare_results``, ``test_agreement.py``'s tolerances; bar
positions exact), and the progress callbacks must fire in the JAX order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import test_torch_pipeline as tp
import track_analyser_tpu.models.downbeat as jax_downbeat
from chip_smoke import compare_results
from track_analyser_tpu.pipeline import analyse_track as jax_analyse_track
from track_analyser_tpu.utils import AudioInput as JaxAudioInput
from track_analyser_tpu_torch import analyse_track
from track_analyser_tpu_torch.utils import AudioInput

torch.set_num_threads(2)

SR = tp.SR
STAGES = ["audio", "beats", "structure", "loudness", "harmonic", "features", "stereo"]


@pytest.fixture(scope="module")
def stereo() -> np.ndarray:
    return tp._rich_stereo()


@pytest.fixture(scope="module")
def reference(stereo):
    """(JAX per-module result, its stages, the accents its decoder scored)."""

    decode = jax_downbeat._viterbi_positions
    accents = []

    def recording(accent, meter):
        accents.append(np.array(accent, dtype=np.float64))
        return decode(accent, meter)

    stages: list = []
    jax_downbeat._viterbi_positions = recording
    try:
        ref = jax_analyse_track(
            JaxAudioInput(samples=stereo.mean(axis=0), sample_rate=SR, stereo_samples=stereo),
            fused=False,
            progress_callback=stages.append,
        )
    finally:
        jax_downbeat._viterbi_positions = decode
    return ref, stages, accents[-1]


@pytest.fixture(scope="module")
def port(stereo):
    stages: list = []
    result = analyse_track(
        AudioInput(samples=stereo.mean(axis=0), sample_rate=SR, stereo_samples=stereo),
        fused=False,
        device="cpu",
        progress_callback=stages.append,
    )
    return result, stages


@pytest.fixture(scope="module")
def both(port, reference):
    return port[0], reference[0]


def test_beat_fields_match_jax(both) -> None:
    tp.test_beat_fields_match_jax(both)


def test_downbeat_fields_match_jax(both, reference) -> None:
    got, ref = both
    assert got.downbeat.source == ref.downbeat.source == "rnn"
    np.testing.assert_allclose(got.downbeat.downbeat_times, ref.downbeat.downbeat_times, atol=1e-4)
    if got.downbeat.beat_positions != ref.downbeat.beat_positions:
        tp._assert_rounding_tie(got.downbeat.beat_positions, ref.downbeat.beat_positions, reference[2])


def test_structure_fields_match_jax(both) -> None:
    tp.test_structure_fields_match_jax(both)


def test_loudness_fields_match_jax(both) -> None:
    tp.test_loudness_fields_match_jax(both)


def test_harmony_fields_match_jax(both) -> None:
    tp.test_harmony_fields_match_jax(both)


def test_features_fields_match_jax(both) -> None:
    tp.test_features_fields_match_jax(both)


def test_stereo_fields_match_jax(both) -> None:
    tp.test_stereo_fields_match_jax(both)


def test_progress_stages_fire_in_the_jax_order(port, reference) -> None:
    assert port[1] == reference[1] == STAGES


def test_per_module_agrees_with_the_fused_path(stereo, port) -> None:
    fused = analyse_track(
        AudioInput(samples=stereo.mean(axis=0), sample_rate=SR, stereo_samples=stereo),
        transport="float32",
        device="cpu",
    )
    compare_results(port[0], fused, "per-module vs fused")
    # the novelty curves come from one function of the substrate
    np.testing.assert_allclose(
        port[0].structure.novelty_curve, fused.structure.novelty_curve, atol=1e-3
    )
