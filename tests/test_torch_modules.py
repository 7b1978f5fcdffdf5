"""Each public module API of the port against its JAX counterpart, on the
CPU: ``tempo``, ``analysis.{beats,structure,loudness,harmonic}``,
``harmony``, ``features``, ``stereo``, ``models.downbeat`` and the GRU of
``models.downbeat_net``.

The same numpy inputs (an 8 s cut of ``test_torch_pipeline``'s stereo
fixture, with its -50 dBFS noise floor) go to both packages; the port runs
``device="cpu"``. Decisions (keys, chords, sections, MIDI, bar positions)
are exact; values are held at ``test_torch_pipeline``'s tolerances or
tighter. Where a module takes a beat result, both packages get the same
beats (the JAX package's, copied into the port's dataclass).

The downbeat ladder keeps its rungs where the inputs run out (fewer than 4
beats, no checkpoint, fewer than 8 tracked beats); a device error inside
any step propagates, where the JAX package swallows every exception.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import test_torch_pipeline as tp

from track_analyser_tpu import features as j_features
from track_analyser_tpu import harmony as j_harmony
from track_analyser_tpu import stereo as j_stereo
from track_analyser_tpu import tempo as j_tempo
from track_analyser_tpu.analysis import beats as j_beats
from track_analyser_tpu.analysis import loudness as j_loudness
from track_analyser_tpu.analysis import structure as j_structure
from track_analyser_tpu.models import downbeat as j_downbeat
from track_analyser_tpu.models import downbeat_net as j_net
from track_analyser_tpu.utils import AudioInput as JaxAudioInput
from track_analyser_tpu_torch import features, harmony, stereo, tempo
from track_analyser_tpu_torch.analysis import beats, harmonic, loudness, structure
from track_analyser_tpu_torch.models import downbeat, downbeat_net
from track_analyser_tpu_torch.ops import median as median_module
from track_analyser_tpu_torch.utils import AudioInput

torch.set_num_threads(2)

SR = tp.SR
CKPT_DIR = Path(__file__).resolve().parents[1] / "track_analyser_tpu" / "models" / "checkpoints"
GRU_CKPT = CKPT_DIR / "downbeat_v1.npz"
CUDA_ERROR = "CUDA error: an illegal memory access was encountered"


@pytest.fixture(scope="module")
def clip() -> np.ndarray:
    return tp._rich_stereo()[:, : 8 * SR]


@pytest.fixture(scope="module")
def audios(clip):
    mono = clip.mean(axis=0)
    return (
        AudioInput(samples=mono, sample_rate=SR, stereo_samples=clip),
        JaxAudioInput(samples=mono, sample_rate=SR, stereo_samples=clip),
    )


@pytest.fixture(scope="module")
def beat_results(audios):
    """(port, JAX) analyse_beats results: (beats, downbeats) each."""

    audio, jax_audio = audios
    return beats.analyse_beats(audio, seed=0, device="cpu"), j_beats.analyse_beats(jax_audio, seed=0)


@pytest.fixture(scope="module")
def shared_beats(beat_results):
    """The JAX package's beat result as (port, JAX) dataclasses."""

    ref = beat_results[1][0]
    return (
        beats.BeatAnalysis(
            bpm=ref.bpm,
            beat_times=list(ref.beat_times),
            beat_frames=list(ref.beat_frames),
            confidence=ref.confidence,
            grid=None,
            tracked_times=list(ref.tracked_times),
        ),
        ref,
    )


def _close_to_max(got, ref, rel: float) -> None:
    """Within ``rel`` of the reference's largest magnitude, element-wise."""

    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# tempo
# ---------------------------------------------------------------------------


def test_onset_envelope_matches_jax(clip) -> None:
    y = clip.mean(axis=0)
    got = tempo.onset_envelope(y, SR, device="cpu")
    ref = j_tempo.onset_envelope(y, SR)
    assert got.shape == ref.shape == (1 + y.size // 512,)
    _close_to_max(got, ref, 1e-5)
    # a signal shorter than one hop still gives one frame
    assert tempo.onset_envelope(y[:100], SR, device="cpu").shape == j_tempo.onset_envelope(y[:100], SR).shape


def test_estimate_bpm_matches_jax(clip) -> None:
    y = clip.mean(axis=0)
    assert tempo.estimate_bpm(y, SR, device="cpu") == pytest.approx(j_tempo.estimate_bpm(y, SR), abs=1e-3)
    # a narrower band moves the autocorrelation peak the same way in both
    got = tempo.estimate_bpm(y, SR, 70.0, 100.0, device="cpu")
    assert got == pytest.approx(j_tempo.estimate_bpm(y, SR, 70.0, 100.0), abs=1e-3)


# ---------------------------------------------------------------------------
# analysis.beats and models.downbeat
# ---------------------------------------------------------------------------


def test_analyse_beats_matches_jax(beat_results) -> None:
    (got, got_down), (ref, ref_down) = beat_results
    assert got.bpm == pytest.approx(ref.bpm, abs=1e-3)
    assert got.confidence == pytest.approx(ref.confidence, abs=1e-3)
    np.testing.assert_allclose(got.beat_times, ref.beat_times, atol=1e-4)
    assert got.beat_frames == ref.beat_frames
    assert len(got.tracked_times) == len(ref.tracked_times) >= 8
    np.testing.assert_allclose(got.tracked_times, ref.tracked_times, atol=0.012)
    assert got_down.source == ref_down.source == "rnn"
    np.testing.assert_allclose(got_down.downbeat_times, ref_down.downbeat_times, atol=1e-4)
    assert got_down.beat_positions == ref_down.beat_positions


def test_tracked_times_for_matches_jax(audios, beat_results) -> None:
    audio, jax_audio = audios
    env = j_tempo.onset_envelope(audio.samples, SR)
    bpm = beat_results[1][0].bpm
    got = beats.tracked_times_for(audio, env, bpm, device="cpu")
    ref = j_beats.tracked_times_for(jax_audio, env, bpm)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, atol=0.012)


def test_accent_curves_match_jax(audios) -> None:
    from track_analyser_tpu.substrate import pad_to_bucket

    audio, _ = audios
    padded, f_valid = pad_to_bucket(audio.samples, hop=512)
    refs = [np.asarray(c)[:f_valid] for c in j_downbeat._accent_graph(jnp.asarray(padded), sr=SR)]
    gots = downbeat._accent_curves(audio.samples, SR, "cpu")
    for got, ref in zip(gots, refs):
        _close_to_max(got, ref, 1e-5)


def test_track_downbeats_matches_jax(audios, shared_beats) -> None:
    audio, _ = audios
    times = np.asarray(shared_beats[1].tracked_times)
    got = downbeat.track_downbeats(audio.samples, SR, times, device="cpu")
    ref = j_downbeat.track_downbeats(audio.samples, SR, times)
    assert downbeat.available() and j_downbeat.available()
    assert got.source == ref.source == "rnn"
    assert got.beat_positions == ref.beat_positions
    np.testing.assert_allclose(got.downbeat_times, ref.downbeat_times, atol=1e-4)


def test_analyse_downbeats_on_the_same_beats_matches_jax(audios, shared_beats) -> None:
    audio, jax_audio = audios
    got = beats.analyse_downbeats(audio, shared_beats[0], seed=0, device="cpu")
    ref = j_beats.analyse_downbeats(jax_audio, shared_beats[1], seed=0)
    assert (got.source, got.beat_positions) == (ref.source, ref.beat_positions)
    np.testing.assert_allclose(got.downbeat_times, ref.downbeat_times, atol=1e-4)


def test_downbeat_ladder_rungs_where_inputs_run_out(audios, shared_beats, monkeypatch) -> None:
    """Fewer than 4 beats: None from the decoder, the heuristic from
    analyse_downbeats. Fewer than 8 tracked beats: the constant grid is the
    time base. A checkpoint that is not there: the accent features alone."""

    audio, jax_audio = audios
    port_beats, ref_beats = shared_beats
    assert downbeat.track_downbeats(audio.samples, SR, [0.5, 1.0, 1.5], device="cpu") is None
    few = beats.build_beat_analysis(120.0, np.array([0.5, 1.0, 1.5]), SR)
    fallback = beats.analyse_downbeats(audio, few, seed=0, device="cpu")
    assert (fallback.source, fallback.beat_positions, fallback.downbeat_times) == ("heuristic", [1, 2, 3], [0.5])

    short = beats.BeatAnalysis(
        bpm=port_beats.bpm, beat_times=port_beats.beat_times, beat_frames=port_beats.beat_frames,
        confidence=port_beats.confidence, tracked_times=port_beats.tracked_times[:7],
    )
    got = beats.analyse_downbeats(audio, short, seed=0, device="cpu")
    on_grid = downbeat.track_downbeats(audio.samples, SR, port_beats.beat_times, device="cpu")
    assert got.beat_positions == on_grid.beat_positions
    assert len(got.beat_positions) == len(port_beats.beat_times)

    monkeypatch.setenv("TRACK_ANALYSER_TPU_DOWNBEAT_CKPT", str(CKPT_DIR / "no_such_checkpoint.npz"))
    with pytest.warns(UserWarning, match="not loaded"):
        got = downbeat.track_downbeats(audio.samples, SR, ref_beats.beat_times, device="cpu")
    ref = j_downbeat.track_downbeats(audio.samples, SR, ref_beats.beat_times)
    assert got.source == ref.source == "accent"
    assert got.beat_positions == ref.beat_positions


def _raise_cuda_error(*_args, **_kwargs):
    raise RuntimeError(CUDA_ERROR)


@pytest.mark.parametrize(
    "step",
    ["tracked_times_for", "analyse_downbeats", "net_activation", "chroma_cue", "net_params"],
)
def test_a_device_error_inside_a_ladder_propagates(step, audios, shared_beats, monkeypatch) -> None:
    """Each place where the JAX package swallows every exception: the
    port's error comes out of the public call."""

    audio, _ = audios
    port_beats = shared_beats[0]
    times = port_beats.tracked_times
    downbeat._net_params_cache.clear()
    if step == "tracked_times_for":
        monkeypatch.setattr(downbeat, "_accent_graph", _raise_cuda_error)
        call = lambda: beats.tracked_times_for(audio, np.ones(100), 120.0, device="cpu")  # noqa: E731
    elif step == "analyse_downbeats":
        monkeypatch.setattr(downbeat, "_accent_curves", _raise_cuda_error)
        call = lambda: beats.analyse_downbeats(audio, port_beats, seed=0, device="cpu")  # noqa: E731
    elif step == "net_activation":
        monkeypatch.setattr(downbeat_net, "downbeat_activation", _raise_cuda_error)
        call = lambda: downbeat.track_downbeats(audio.samples, SR, times, device="cpu")  # noqa: E731
    elif step == "chroma_cue":
        monkeypatch.setattr(harmony, "_compute_chromas", _raise_cuda_error)
        call = lambda: downbeat.track_downbeats(audio.samples, SR, times, device="cpu")  # noqa: E731
    else:
        monkeypatch.setattr(downbeat_net, "load_checkpoint", _raise_cuda_error)
        call = lambda: beats.analyse_downbeats(audio, port_beats, seed=0, device="cpu")  # noqa: E731
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            call()
    finally:
        downbeat._net_params_cache.clear()


# ---------------------------------------------------------------------------
# The GRU downbeat net (downbeat_v1.npz)
# ---------------------------------------------------------------------------


def test_gru_forward_matches_jax() -> None:
    params = downbeat_net.load_checkpoint(GRU_CKPT)
    assert "gru0_wx" in params and "tcn0_w" not in params
    feats = np.random.default_rng(3).normal(size=(300, 128)).astype(np.float32)
    ref = np.asarray(j_net.forward({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats)))
    model = downbeat_net.params_from_jax(params)
    assert isinstance(model, downbeat_net.DownbeatGRU)
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
        lanes = model(torch.from_numpy(np.stack([feats, feats[::-1].copy()]))).numpy()
    assert got.shape == ref.shape == (300, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lanes[0], got, rtol=0, atol=1e-6)


def test_gru_downbeat_activation_named_by_the_environment(audios, shared_beats, monkeypatch) -> None:
    """TRACK_ANALYSER_TPU_DOWNBEAT_CKPT naming the GRU checkpoint: both
    packages load it, its P(downbeat) agrees within 1e-5, and the
    per-module decoder runs on it (source "rnn")."""

    monkeypatch.setenv("TRACK_ANALYSER_TPU_DOWNBEAT_CKPT", str(GRU_CKPT))
    audio, _ = audios
    params = downbeat._net_params()
    assert params is not None and "gru0_wx" in params
    got = downbeat_net.downbeat_activation(params, audio.samples, SR, device="cpu")
    ref = j_net.downbeat_activation(j_downbeat._net_params(), audio.samples, SR)
    assert got.shape == ref.shape == (1 + audio.samples.size // 512,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)

    times = shared_beats[1].tracked_times
    got = downbeat.track_downbeats(audio.samples, SR, times, device="cpu")
    ref = j_downbeat.track_downbeats(audio.samples, SR, times)
    assert got.source == ref.source == "rnn"
    assert got.beat_positions == ref.beat_positions


# ---------------------------------------------------------------------------
# analysis.structure
# ---------------------------------------------------------------------------


def test_analyse_structure_matches_jax_through_median31(audios, shared_beats, monkeypatch) -> None:
    calls = []
    kernel = median_module.median31

    def counting(x, axis=-1):
        calls.append((tuple(x.shape), axis))
        return kernel(x, axis)

    monkeypatch.setattr(median_module, "median31", counting)
    audio, jax_audio = audios
    got = structure.analyse_structure(audio, shared_beats[0], seed=0, device="cpu")
    ref = j_structure.analyse_structure(jax_audio, shared_beats[1], seed=0)
    # once per axis, on the (1, 1025, frames) |STFT| of the bucket
    assert [axis for _shape, axis in calls] == [-1, -2], calls
    assert calls[0][0] == calls[1][0] and calls[0][0][:2] == (1, 1025), calls
    assert [(s.label, s.category) for s in got.segments] == [(s.label, s.category) for s in ref.segments]
    for attr in ("start", "end", "confidence", "percussive_ratio"):
        np.testing.assert_allclose(
            [getattr(s, attr) for s in got.segments], [getattr(s, attr) for s in ref.segments], atol=1e-3
        )
    assert len(got.novelty_curve) == len(ref.novelty_curve) == 1 + audio.samples.size // 512
    np.testing.assert_allclose(got.novelty_curve, ref.novelty_curve, atol=1e-3)


# ---------------------------------------------------------------------------
# analysis.loudness
# ---------------------------------------------------------------------------


def test_measure_loudness_matches_jax(audios) -> None:
    y = audios[0].samples
    got = loudness.measure_loudness(y, SR, device="cpu")
    ref = j_loudness.measure_loudness(y, SR)
    assert got[0] == pytest.approx(ref[0], abs=5e-3)
    for g, r in zip(got[1:3], ref[1:3]):
        assert len(g) == len(r)
        np.testing.assert_allclose(g, r, atol=2e-2)
    assert got[3] == pytest.approx(ref[3], abs=5e-3)
    with pytest.raises(ValueError, match="mono"):
        loudness.measure_loudness(audios[0].stereo_samples, SR, device="cpu")


@pytest.mark.parametrize("oversample", [1, 4, 8])
def test_true_peak_dbtp_matches_jax(audios, oversample) -> None:
    y = audios[0].samples
    got = loudness.true_peak_dbtp(y, SR, oversample=oversample, device="cpu")
    assert got == pytest.approx(j_loudness.true_peak_dbtp(y, SR, oversample=oversample), abs=5e-3)


def test_analyse_loudness_matches_jax(audios) -> None:
    got = loudness.analyse_loudness(audios[0], seed=0, device="cpu")
    ref = j_loudness.analyse_loudness(audios[1], seed=0)
    for attr in ("integrated_lufs", "loudness_range", "true_peak_dbfs", "rms_dbfs"):
        assert getattr(got, attr) == pytest.approx(getattr(ref, attr), abs=5e-3), attr
    np.testing.assert_allclose(got.momentary_lufs, ref.momentary_lufs, atol=2e-2)
    np.testing.assert_allclose(got.short_term_lufs, ref.short_term_lufs, atol=2e-2)


# ---------------------------------------------------------------------------
# harmony and the analysis.harmonic shim
# ---------------------------------------------------------------------------


def test_chromas_match_jax(audios) -> None:
    y = audios[0].samples
    for got, ref in zip(harmony._compute_chromas(y, SR, device="cpu"), j_harmony._compute_chromas(y, SR)):
        assert got.shape == ref.shape == (12, 1 + y.size // 512)
        _close_to_max(got, ref, 1e-5)


def test_key_estimate_matches_jax(audios) -> None:
    got = harmony.key_estimate(audios[0].samples, SR, device="cpu")
    ref = j_harmony.key_estimate(audios[0].samples, SR)
    for g, r in ((got.best, ref.best), (got.second_best, ref.second_best)):
        assert g.key == r.key
        assert g.confidence == pytest.approx(r.confidence, abs=1e-3)


def test_key_scoring_and_templates_equal_jax() -> None:
    """The host key scoring and chord templates, bit for bit."""

    for g, r in zip(harmony._profile_matrices(), j_harmony._profile_matrices()):
        np.testing.assert_array_equal(g, r)
    chroma = np.random.default_rng(5).random((12, 40))
    np.testing.assert_array_equal(
        harmony._correlate_chroma(chroma, harmony.MAJOR_PROFILE),
        j_harmony._correlate_chroma(chroma, j_harmony.MAJOR_PROFILE),
    )
    got_scores, got_keys = harmony._score_keys([chroma, chroma[:, ::2]])
    ref_scores, ref_keys = j_harmony._score_keys([chroma, chroma[:, ::2]])
    np.testing.assert_array_equal(got_scores, ref_scores)
    assert got_keys == ref_keys
    got = harmony._estimate_keys_from_chroma(chroma, chroma[::-1])
    ref = j_harmony._estimate_keys_from_chroma(chroma, chroma[::-1])
    assert (got.best.key, got.best.confidence) == (ref.best.key, ref.best.confidence)
    got_t, ref_t = harmony._build_chord_templates(), j_harmony._build_chord_templates()
    assert list(got_t) == list(ref_t) and len(got_t) == 60
    for name in ref_t:
        np.testing.assert_array_equal(got_t[name], ref_t[name])


def test_balance_and_stereo_image_match_jax(audios) -> None:
    audio, jax_audio = audios
    got, ref = harmony._spectral_balance(audio, device="cpu"), j_harmony._spectral_balance(jax_audio)
    for band in ("low_band", "mid_band", "high_band"):
        assert getattr(got, band) == pytest.approx(getattr(ref, band), abs=1e-5)
    got, ref = harmony._stereo_image(audio, device="cpu"), j_harmony._stereo_image(jax_audio)
    assert got.correlation == pytest.approx(ref.correlation, abs=1e-5)
    assert got.balance == pytest.approx(ref.balance, abs=1e-5)
    mono = AudioInput(samples=audio.samples, sample_rate=SR)
    assert harmony._stereo_image(mono, device="cpu") == harmony.StereoImage(correlation=1.0, balance=0.0)


def test_analyse_harmony_on_the_same_beats_matches_jax(audios, shared_beats) -> None:
    audio, jax_audio = audios
    port_beats, ref_beats = shared_beats
    got = harmony.analyse_harmony(audio, port_beats, None, seed=0, device="cpu")
    ref = j_harmony.analyse_harmony(jax_audio, ref_beats, None, seed=0)
    tp.test_harmony_fields_match_jax((_Wrapped(got), _Wrapped(ref)))


class _Wrapped:
    """A harmony result in the place ``test_torch_pipeline`` reads it."""

    def __init__(self, harmonic) -> None:
        self.harmonic = harmonic


def test_harmonic_shim_forwards_and_warns(audios, shared_beats) -> None:
    assert harmonic.HarmonyAnalysis is harmony.HarmonyAnalysis
    assert harmonic.key_estimate is harmony.key_estimate
    with pytest.raises(AttributeError):
        harmonic.no_such_name  # noqa: B018
    with pytest.warns(DeprecationWarning, match="analyse_harmony"):
        got = harmonic.analyse_harmonic(audios[0], shared_beats[0], None, seed=0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        direct = harmony.analyse_harmony(audios[0], shared_beats[0], None, seed=0, device="cpu")
    assert got.primary_key == direct.primary_key
    assert [h.chord for h in got.chord_hints] == [h.chord for h in direct.chord_hints]


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["mono", "stereo"])
def test_feature_series_match_jax(audios, layout) -> None:
    x = audios[0].samples if layout == "mono" else audios[0].stereo_samples
    got, ref = features.compute_ltas(x, SR, device="cpu"), j_features.compute_ltas(x, SR)
    np.testing.assert_array_equal(got.frequencies, ref.frequencies)
    np.testing.assert_allclose(got.magnitude, ref.magnitude, rtol=1e-3, atol=1e-3)
    got = features.spectral_centroid_series(x, SR, device="cpu")
    np.testing.assert_allclose(got.values, j_features.spectral_centroid_series(x, SR).values, rtol=1e-3)
    got = features.spectral_rolloff_series(x, SR, roll_percent=0.5, device="cpu")
    ref = j_features.spectral_rolloff_series(x, SR, roll_percent=0.5)
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-3, atol=SR / 2048)


def test_analyse_features_matches_jax(audios) -> None:
    got = features.analyse_features(audios[0], device="cpu")
    ref = j_features.analyse_features(audios[1])
    tp.test_features_fields_match_jax((_Features(got), _Features(ref)))


class _Features:
    def __init__(self, features) -> None:
        self.features = features


# ---------------------------------------------------------------------------
# stereo
# ---------------------------------------------------------------------------


def test_stereo_helpers_match_jax(clip) -> None:
    for layout in (clip, clip.T, clip[:1], clip[0], np.concatenate([clip, clip[:1]])):
        got, ref = stereo.mid_side_rms(layout, device="cpu"), j_stereo.mid_side_rms(layout)
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        assert stereo.mono_compatibility_correlation(layout) == j_stereo.mono_compatibility_correlation(layout)
    assert stereo.mid_side_rms(np.zeros((2, 0), np.float32), device="cpu") == (0.0, 0.0)
    assert stereo.mono_compatibility_correlation(np.stack([clip[0], clip[0]])) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize(
    "bands",
    [None, [("low", 0.0, 150.0), ("mid", 150.0, 4_000.0), ("high", 4_000.0, 11_025.0)], [("low", 1.0, 2.0)]],
)
def test_frequency_dependent_width_matches_jax(clip, bands) -> None:
    got = stereo.frequency_dependent_width(clip, SR, bands=bands, device="cpu")
    ref = j_stereo.frequency_dependent_width(clip, SR, bands=bands)
    for band in ("low", "mid", "high"):
        assert getattr(got, band) == pytest.approx(getattr(ref, band), abs=1e-4)


def test_analyse_stereo_matches_jax(audios) -> None:
    for port_audio, jax_audio in (audios, (AudioInput(samples=audios[0].samples, sample_rate=SR),
                                           JaxAudioInput(samples=audios[0].samples, sample_rate=SR))):
        got, ref = stereo.analyse_stereo(port_audio, device="cpu"), j_stereo.analyse_stereo(jax_audio)
        assert got.mid_rms == pytest.approx(ref.mid_rms, rel=1e-5)
        assert got.side_rms == pytest.approx(ref.side_rms, rel=1e-5, abs=1e-9)
        assert got.correlation == ref.correlation
        assert got.width.as_dict() == pytest.approx(ref.width.as_dict(), abs=1e-4)


# ---------------------------------------------------------------------------
# Every entry point runs on the card unless told otherwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "call",
    [
        lambda a, b: tempo.estimate_bpm(a.samples, SR),
        lambda a, b: beats.analyse_beats(a, seed=0),
        lambda a, b: structure.analyse_structure(a, b, seed=0),
        lambda a, b: loudness.analyse_loudness(a, seed=0),
        lambda a, b: harmony.analyse_harmony(a, b, None, seed=0),
        lambda a, b: features.analyse_features(a),
        lambda a, b: stereo.analyse_stereo(a),
    ],
    ids=["tempo", "beats", "structure", "loudness", "harmony", "features", "stereo"],
)
def test_module_apis_default_to_cuda(call, audios, shared_beats) -> None:
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the error path needs a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(audios[0], shared_beats[0])
