"""The PyTorch port's ``analyse_track`` against the JAX package's fused
path, field by field, on the CPU.

Both packages get the same 20 s stereo fixture (made with numpy); the
port runs its plain PyTorch path (``device="cpu"``) and the JAX package
its CPU path. Tolerances are no looser than the fused-vs-per-module
agreement in ``test_agreement.py``: BPM and confidence 1e-3, beat and
downbeat times 1e-4 s, tracked beats 12 ms, integrated LUFS, true peak
and RMS 5e-3 dB, loudness curves 2e-2 dB; key, chords, section count
and MIDI exact. Every ported transport runs: "float32", "int16", "int8"
and "ms" (the default, "auto").

Downbeat bar positions are exact too, but for one documented case: under
"ms" this fixture's path holds a shortened bar on which the bar-position
Viterbi ties exactly, and float rounding picks the labels inside it. There
the test proves the tie instead (``_assert_rounding_tie``).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import track_analyser_tpu.models.downbeat as jax_downbeat
from chip_smoke import equal_score_key
from synth import progression
from track_analyser_tpu.parallel.batch import analyse_track_fused as jax_analyse_track_fused
from track_analyser_tpu.utils import AudioInput as JaxAudioInput
from track_analyser_tpu_torch import analyse_track
from track_analyser_tpu_torch.utils import AudioInput

torch.set_num_threads(2)

SR = 22_050
REPO = Path(__file__).resolve().parents[1]


def _rich_stereo() -> np.ndarray:
    """20 s: kick grid at 120 BPM + I-IV-V-I chords + stereo imbalance +
    a -50 dBFS noise floor.

    The noise floor matters for a cross-framework comparison. Without
    it the onset envelope between kicks is float rounding noise (~1e-8,
    sustained tones give zero flux), and onset backtracking picks its
    local minima from that noise: two correct float32 implementations
    (XLA's and PyTorch's FFT, matmul and log10 round differently) then
    backtrack an onset to different frames and the BPM regression moves
    by ~0.04. With a noise floor the decisions rest on the signal.
    """

    seconds = 20.0
    n = int(seconds * SR)
    t = np.arange(n) / SR
    chords = np.tile(
        progression([(60, "maj"), (65, "maj"), (67, "maj"), (60, "maj")], 2.5, SR), 2
    )[:n]
    kick = np.zeros(n, dtype=np.float32)
    for i, b in enumerate(np.arange(0.0, seconds, 0.5)):
        s = int(b * SR)
        e = min(n, s + int(0.05 * SR))
        seg = np.arange(e - s) / SR
        amp = 1.0 if i % 4 == 0 else 0.45
        kick[s:e] += amp * np.sin(2 * np.pi * (60 + 50 * np.exp(-seg * 60)) * seg) * np.exp(-seg * 40)
    left = 0.5 * chords + 0.8 * kick
    right = 0.35 * chords + 0.8 * kick + 0.05 * np.sin(2 * np.pi * 3000.0 * t)
    noise = np.random.default_rng(7).normal(0.0, 0.003, size=(2, n))
    stereo = (np.stack([left, right]) + noise).astype(np.float32)
    return stereo * (0.9 / np.abs(stereo).max())


# transport -> the per-beat accent curve the JAX decoder scored (float64)
JAX_ACCENT: dict = {}
# Transports on which this fixture's downbeat path is an exact tie of the
# bar-position Viterbi, decided by float rounding: under "ms" the
# shortened 3/4 bar at beats 28-30 reads 1,3,1 in JAX and 1,2,1 in the
# port. Every other transport must match JAX's path exactly.
TIED_TRANSPORTS = ("ms",)


@pytest.fixture(scope="module", params=["float32", "int16", "int8", "ms"])
def both(request):
    stereo = _rich_stereo()
    decode = jax_downbeat._viterbi_positions

    def recording(accent, meter):
        JAX_ACCENT[request.param] = np.array(accent, dtype=np.float64)
        return decode(accent, meter)

    jax_downbeat._viterbi_positions = recording
    try:
        ref = jax_analyse_track_fused(
            JaxAudioInput(samples=stereo.mean(axis=0), sample_rate=SR, stereo_samples=stereo),
            transport=request.param,
        )
    finally:
        jax_downbeat._viterbi_positions = decode
    port = analyse_track(
        AudioInput(samples=stereo.mean(axis=0), sample_rate=SR, stereo_samples=stereo),
        transport=request.param,
        device="cpu",
    )
    return port, ref


def test_beat_fields_match_jax(both) -> None:
    port, ref = both
    assert port.beat.bpm == pytest.approx(ref.beat.bpm, abs=1e-3)
    assert port.beat.confidence == pytest.approx(ref.beat.confidence, abs=1e-3)
    assert len(port.beat.beat_times) == len(ref.beat.beat_times)
    np.testing.assert_allclose(port.beat.beat_times, ref.beat.beat_times, atol=1e-4)
    assert port.beat.beat_frames == ref.beat.beat_frames
    assert len(port.beat.tracked_times) == len(ref.beat.tracked_times)
    np.testing.assert_allclose(port.beat.tracked_times, ref.beat.tracked_times, atol=0.012)
    # the grid is a dict of columns in the port, a DataFrame in JAX
    assert list(port.beat.grid) == list(ref.beat.grid.columns)
    for column in ref.beat.grid.columns:
        np.testing.assert_allclose(
            port.beat.grid[column], ref.beat.grid[column].to_numpy(), atol=1e-4
        )


def _assert_rounding_tie(got: "list[int]", ref: "list[int]", accent: np.ndarray) -> None:
    """``got`` differs from JAX's path ``ref`` only by a tie that float
    rounding decides: both paths score exactly the same for any accents
    (one ``equal_score_key``, with a slip), and JAX's own decoder picks
    ``got`` once one beat's accent moves by at most four float64 ulps."""

    meter = max(ref)
    assert equal_score_key(got) == equal_score_key(ref)
    assert equal_score_key(ref)[2] > 0, "a path without a slip cannot tie"
    for i in range(accent.size):
        for toward in (-np.inf, np.inf):
            nudged = accent.copy()
            for _ in range(4):
                nudged[i] = np.nextafter(nudged[i], toward)
                if jax_downbeat._viterbi_positions(nudged, meter)[1].tolist() == got:
                    return
    pytest.fail("JAX's decoder does not reach the port's path within 4 ulps of one beat's accent")


def test_downbeat_fields_match_jax(both, request) -> None:
    port, ref = both
    transport = request.node.callspec.params["both"]
    assert port.downbeat.source == ref.downbeat.source == "rnn"
    np.testing.assert_allclose(
        port.downbeat.downbeat_times, ref.downbeat.downbeat_times, atol=1e-4
    )
    if transport in TIED_TRANSPORTS and port.downbeat.beat_positions != ref.downbeat.beat_positions:
        _assert_rounding_tie(
            port.downbeat.beat_positions, ref.downbeat.beat_positions, JAX_ACCENT[transport]
        )
    else:
        assert port.downbeat.beat_positions == ref.downbeat.beat_positions


def test_equal_score_key_marks_exact_viterbi_ties() -> None:
    """The bar-position Viterbi's score of a path is its emissions plus
    -10 per slip; paths with one ``equal_score_key`` score the same."""

    from track_analyser_tpu_torch.models.downbeat import _viterbi_positions

    def path_score(accent, positions, meter):
        p = np.asarray(positions)
        emit = np.where(p == 1, accent, -accent / (meter - 1)).sum()
        return emit - 10.0 * equal_score_key(positions)[2]

    accent = np.random.default_rng(4).normal(size=12)
    shortened = [3, 1, 2, 3, 1, 2, 1, 2, 3, 1, 2, 3]  # 1,2,1: a skip out of position 2
    skipped = [3, 1, 2, 3, 1, 3, 1, 2, 3, 1, 2, 3]  # 1,3,1: a skip into position 3
    assert equal_score_key(shortened) == equal_score_key(skipped) == (3, (1, 4, 6, 9), 1)
    assert path_score(accent, shortened, 3) == pytest.approx(path_score(accent, skipped, 3), abs=1e-12)
    assert equal_score_key([1, 2, 3] * 4) == (3, (0, 3, 6, 9), 0)
    for meter in (3, 4):
        score, positions = _viterbi_positions(accent, meter)
        assert score * accent.size == pytest.approx(path_score(accent, positions.tolist(), meter), abs=1e-9)


def test_structure_fields_match_jax(both) -> None:
    port, ref = both
    assert len(port.structure.segments) == len(ref.structure.segments)
    assert [s.label for s in port.structure.segments] == [s.label for s in ref.structure.segments]
    assert [s.category for s in port.structure.segments] == [
        s.category for s in ref.structure.segments
    ]
    for attr in ("start", "end"):
        np.testing.assert_allclose(
            [getattr(s, attr) for s in port.structure.segments],
            [getattr(s, attr) for s in ref.structure.segments],
            atol=1e-3,
        )
    for attr in ("confidence", "percussive_ratio"):
        np.testing.assert_allclose(
            [getattr(s, attr) for s in port.structure.segments],
            [getattr(s, attr) for s in ref.structure.segments],
            atol=1e-3,
        )
    # half-precision rows: compare at the f16 step
    np.testing.assert_allclose(
        port.structure.novelty_curve, ref.structure.novelty_curve, atol=1e-3
    )


def test_loudness_fields_match_jax(both) -> None:
    port, ref = both
    for attr in ("integrated_lufs", "loudness_range", "true_peak_dbfs", "rms_dbfs"):
        assert getattr(port.loudness, attr) == pytest.approx(
            getattr(ref.loudness, attr), abs=5e-3
        ), attr
    np.testing.assert_allclose(
        port.loudness.momentary_lufs, ref.loudness.momentary_lufs, atol=2e-2
    )
    np.testing.assert_allclose(
        port.loudness.short_term_lufs, ref.loudness.short_term_lufs, atol=2e-2
    )


def test_harmony_fields_match_jax(both) -> None:
    port, ref = both
    assert port.harmonic.primary_key.key == ref.harmonic.primary_key.key
    assert port.harmonic.secondary_key.key == ref.harmonic.secondary_key.key
    assert port.harmonic.primary_key.confidence == pytest.approx(
        ref.harmonic.primary_key.confidence, abs=1e-3
    )
    assert port.harmonic.secondary_key.confidence == pytest.approx(
        ref.harmonic.secondary_key.confidence, abs=1e-3
    )
    assert [h.chord for h in port.harmonic.chord_hints] == [
        h.chord for h in ref.harmonic.chord_hints
    ]
    np.testing.assert_allclose(
        [h.time for h in port.harmonic.chord_hints],
        [h.time for h in ref.harmonic.chord_hints],
        atol=1e-4,
    )
    p_times = [p.time for p in port.harmonic.chord_change_points]
    r_times = [p.time for p in ref.harmonic.chord_change_points]
    assert len(p_times) == len(r_times)
    np.testing.assert_allclose(p_times, r_times, atol=1e-4)
    np.testing.assert_allclose(
        [p.strength for p in port.harmonic.chord_change_points],
        [p.strength for p in ref.harmonic.chord_change_points],
        atol=1e-2,
    )
    for band in ("low_band", "mid_band", "high_band"):
        assert getattr(port.harmonic.spectral_balance, band) == pytest.approx(
            getattr(ref.harmonic.spectral_balance, band), abs=1e-3
        )
    assert port.harmonic.stereo_image.correlation == pytest.approx(
        ref.harmonic.stereo_image.correlation, abs=1e-3
    )
    assert port.harmonic.stereo_image.balance == pytest.approx(
        ref.harmonic.stereo_image.balance, abs=1e-3
    )
    # notes are a dict of columns in the port, a DataFrame in JAX
    for attr in ("hook_suggestion", "bass_suggestion"):
        p_notes = getattr(port.harmonic, attr).notes
        r_notes = getattr(ref.harmonic, attr).notes
        assert getattr(port.harmonic, attr).name == getattr(ref.harmonic, attr).name
        assert list(p_notes) == list(r_notes.columns)
        for column in ("pitch", "velocity", "channel"):
            assert p_notes[column].tolist() == r_notes[column].tolist()
        for column in ("start", "duration"):
            np.testing.assert_allclose(p_notes[column], r_notes[column].to_numpy(), atol=1e-4)


def test_features_fields_match_jax(both) -> None:
    port, ref = both
    np.testing.assert_array_equal(port.features.ltas.frequencies, ref.features.ltas.frequencies)
    np.testing.assert_allclose(
        port.features.ltas.magnitude, ref.features.ltas.magnitude, rtol=1e-3, atol=1e-3
    )
    # f16 readback rows: per-frame values within one f16 step
    np.testing.assert_allclose(
        port.features.spectral_centroid.values,
        ref.features.spectral_centroid.values,
        rtol=1e-3,
    )
    assert port.features.spectral_centroid.mean == pytest.approx(
        ref.features.spectral_centroid.mean, rel=1e-3
    )
    # rolloff is a bin frequency, shipped at f16: a frame whose cumulative
    # sum sits on the 85% threshold may land one bin (sr / n_fft) away,
    # plus one f16 step (rtol 1e-3)
    np.testing.assert_allclose(
        port.features.spectral_rolloff.values,
        ref.features.spectral_rolloff.values,
        rtol=1e-3,
        atol=SR / 2048,
    )
    assert port.features.spectral_rolloff.mean == pytest.approx(
        ref.features.spectral_rolloff.mean, rel=1e-3
    )


def test_stereo_fields_match_jax(both) -> None:
    port, ref = both
    assert port.stereo.mid_rms == pytest.approx(ref.stereo.mid_rms, abs=1e-4)
    assert port.stereo.side_rms == pytest.approx(ref.stereo.side_rms, abs=1e-4)
    assert port.stereo.correlation == pytest.approx(ref.stereo.correlation, abs=1e-3)
    for band in ("low", "mid", "high"):
        assert getattr(port.stereo.width, band) == pytest.approx(
            getattr(ref.stereo.width, band), abs=1e-2
        )
    assert port.stems is None and ref.stems is None


def test_analyse_track_reads_a_wav_path(tmp_path) -> None:
    """A path goes through the port's own WAV decoder; the result equals
    the one for the decoded samples passed in directly."""

    from track_analyser_tpu_torch.io import decode_wav, write_wav
    from track_analyser_tpu.io.codecs import decode_wav as jax_decode_wav

    stereo = _rich_stereo()[:, : 6 * SR]
    path = tmp_path / "clip.wav"
    write_wav(path, stereo, SR)
    data, sr, meta = decode_wav(path)
    ref_data, ref_sr, ref_meta = jax_decode_wav(path)
    np.testing.assert_array_equal(data, ref_data)
    assert (sr, meta) == (ref_sr, ref_meta)

    from track_analyser_tpu.utils import coerce_audio as jax_coerce_audio
    from track_analyser_tpu_torch.utils import coerce_audio

    audio, ref_audio = coerce_audio(str(path)), jax_coerce_audio(str(path))
    assert audio.sample_rate == ref_audio.sample_rate == 44_100  # resampled
    np.testing.assert_array_equal(audio.samples, ref_audio.samples)
    np.testing.assert_array_equal(audio.stereo_samples, ref_audio.stereo_samples)

    from_path = analyse_track(str(path), device="cpu")
    assert from_path.audio.path == str(path)
    np.testing.assert_array_equal(from_path.audio.samples, audio.samples)
    assert np.isfinite(from_path.beat.bpm)


def test_beat_grid_matches_jax() -> None:
    """The per-call grid (envelope computed by the port's ops, on the
    CPU) against the JAX package's ``tempo.beat_grid``."""

    from track_analyser_tpu.tempo import beat_grid as jax_beat_grid
    from track_analyser_tpu_torch.tempo import beat_grid

    y = _rich_stereo()[:, : 8 * SR].mean(axis=0)
    ref = jax_beat_grid(y, SR)
    got = beat_grid(y, SR, device="cpu")
    assert list(got) == list(ref.columns)
    for column in ref.columns:
        np.testing.assert_allclose(got[column], ref[column].to_numpy(), atol=1e-4, err_msg=column)


@pytest.mark.parametrize(
    "kwargs", [{"transport": "ms6"}, {"transport": "ms5"}, {"fused": False}], ids=["ms6", "ms5", "per_module"]
)
def test_every_option_of_the_jax_package_runs(kwargs) -> None:
    """The options the port once refused now run on a short clip: finite
    fields, every stage reported in order."""

    from chip_smoke import numeric_leaves
    from track_analyser_tpu_torch.config import DEFAULT_CONFIG

    stereo = _rich_stereo()[:, : 4 * SR]
    audio = AudioInput(samples=stereo.mean(axis=0), sample_rate=SR, stereo_samples=stereo)
    stages: list = []
    result = analyse_track(audio, device="cpu", progress_callback=stages.append, **kwargs)
    assert stages == ["audio", "beats", "structure", "loudness", "harmonic", "features", "stereo"]
    assert DEFAULT_CONFIG.bpm_min <= result.beat.bpm <= DEFAULT_CONFIG.bpm_max
    for name, value in numeric_leaves(result):
        assert np.all(np.isfinite(value)), name


def test_cuda_device_raises_without_cuda() -> None:
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the error path needs a host without it")
    stereo = _rich_stereo()[:, : 2 * SR]
    audio = AudioInput(samples=stereo.mean(axis=0), sample_rate=SR, stereo_samples=stereo)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analyse_track(audio)


def test_import_leaves_jax_out() -> None:
    code = (
        "import sys, track_analyser_tpu_torch, track_analyser_tpu_torch.parallel.batch, "
        "track_analyser_tpu_torch.ops.fused_stft, track_analyser_tpu_torch.ops.cuda_build, "
        "track_analyser_tpu_torch.profile_track, track_analyser_tpu_torch.cli, "
        "track_analyser_tpu_torch.tempo, track_analyser_tpu_torch.features, "
        "track_analyser_tpu_torch.stereo, track_analyser_tpu_torch.harmony, "
        "track_analyser_tpu_torch.analysis.harmonic, track_analyser_tpu_torch.models.downbeat_net, "
        "track_analyser_tpu_torch.native.binding, track_analyser_tpu_torch.native.build, "
        "track_analyser_tpu_torch.io.flac, track_analyser_tpu_torch.io.vorbis, "
        "track_analyser_tpu_torch.io.mpg123, track_analyser_tpu_torch.io.ffmpeg, "
        "track_analyser_tpu_torch.profiling, track_analyser_tpu_torch.parallel.mesh, "
        "track_analyser_tpu_torch.parallel.sharded, track_analyser_tpu_torch.models.training, "
        "track_analyser_tpu_torch.models.separation_net, track_analyser_tpu_torch.dryrun, "
        "track_analyser_tpu_torch.evaluation, track_analyser_tpu_torch.ops.chroma, "
        "track_analyser_tpu_torch.ops.spectral, track_analyser_tpu_torch.ops.loudness, chip_smoke; "
        "from track_analyser_tpu_torch.analysis import beats, loudness, structure, harmonic; "
        "harmonic.analyse_harmony; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert not any(m.startswith('track_analyser_tpu.') or m == 'track_analyser_tpu' "
        "for m in sys.modules), 'JAX package imported'"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
