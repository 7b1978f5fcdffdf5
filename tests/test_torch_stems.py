"""The port's stem separation (``analysis/stems.py``) against the JAX
package's, on the CPU.

Seeded numpy mixtures of peak <= 1 go through both DSP separators (in
JAX, ``hpss`` takes its XLA median on the CPU) and both ``separate_stems``
ladders. Tolerances: 1e-4 absolute on float stems; decoded PCM_16 WAVs
within one LSB (1/32768) plus that float tolerance, since two correct
float32 paths can round a sample to neighbouring integers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from track_analyser_tpu.analysis import stems as jstems
from track_analyser_tpu_torch.analysis import stems as tstems
from track_analyser_tpu_torch.io import AudioDecodeError, decode_wav, load_audio, write_wav
from track_analyser_tpu_torch.models import separation

torch.set_num_threads(2)

ATOL = 1e-4
LSB = 1.0 / 32768.0
SR = 44_100
NAMES = ("drums", "bass", "other", "vocals")


def _mixture(n: int, seed: int, channels: int = 0) -> np.ndarray:
    """Kicks, a bass tone, a wobbling mid tone and noise hats, peak 0.9."""

    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    rows = []
    for c in range(max(channels, 1)):
        y = 0.3 * np.sin(2 * np.pi * 80.0 * t) + 0.2 * (1 + 0.8 * np.sin(2 * np.pi * 3.0 * t)) * np.sin(
            2 * np.pi * (500.0 + 60.0 * c) * t
        )
        for b in np.arange(0.0, n / SR, 0.5):
            s = int(b * SR)
            e = min(n, s + 1_500)
            y[s:e] += 0.5 * rng.normal(size=e - s) * np.exp(-np.arange(e - s) / 300.0)
        y += 0.01 * rng.normal(size=n)
        rows.append(y)
    x = np.stack(rows) if channels else rows[0]
    return (x * (0.9 / np.abs(x).max())).astype(np.float32)


@pytest.mark.parametrize("channels", [0, 2], ids=["mono", "stereo"])
def test_separate_stems_arrays_matches_jax(channels) -> None:
    y = _mixture(3 * SR + 77, seed=1 + channels, channels=channels)
    ref = jstems.separate_stems_arrays(y, SR)
    got = tstems.separate_stems_arrays(y, SR, device="cpu")
    assert tuple(got) == tuple(ref) == NAMES
    for name in NAMES:
        assert got[name].shape == ref[name].shape == y.shape
        assert got[name].dtype == np.float32
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL, err_msg=name)


def test_stereo_channels_equal_their_mono_runs() -> None:
    y = _mixture(2 * SR, seed=5, channels=2)
    both = tstems.separate_stems_arrays(y, SR, device="cpu")
    for c in range(2):
        one = tstems.separate_stems_arrays(y[c], SR, device="cpu")
        for name in NAMES:
            np.testing.assert_allclose(both[name][c], one[name], atol=2e-6, err_msg=name)


def test_dsp_stems_sum_to_the_mixture() -> None:
    """drums + bass + vocals masks never exceed one here (the harmonic
    and percussive soft masks sum to one and the band weights are <= 1),
    so ``m_other`` is not clipped and the four stems add up to the input."""

    y = _mixture(2 * SR + 500, seed=7, channels=2)
    stems = tstems.separate_stems_arrays(y, SR, device="cpu")
    total = sum(stems[name] for name in NAMES)
    np.testing.assert_allclose(total, y, atol=ATOL)
    assert all(np.abs(stems[name]).max() > 1e-3 for name in ("drums", "bass", "other"))


def test_padded_body_equals_exact_shape_away_from_the_tail() -> None:
    """``f_valid`` masks the padding out of the modulation statistics and
    the ISTFT. HPSS's median along time is not masked (in neither
    package): within 15 frames of the end it sees zeros where the
    exact-shape run reflects, so the comparison stops 20 frames short.
    Those tail frames also enter each bin's modulation statistic, which
    moves the vocals/other split of every frame a little; drums, bass and
    the sum of other and vocals do not depend on it."""

    n, n_padded = 50_000, 131_072
    y = _mixture(n, seed=8)
    padded = np.zeros(n_padded, dtype=np.float32)
    padded[:n] = y
    with torch.inference_mode():
        exact = tstems._dsp_separate_body(torch.from_numpy(y), sr=SR, n_samples=n)
        wide = tstems._dsp_separate_body(
            torch.from_numpy(padded), sr=SR, n_samples=n_padded, f_valid=1 + n // 1024
        )
    assert exact.shape == (4, n) and wide.shape == (4, n_padded)
    keep = n - 20 * 1024
    exact, wide = exact[:, :keep].numpy(), wide[:, :keep].numpy()
    np.testing.assert_allclose(wide[:2], exact[:2], atol=ATOL)
    np.testing.assert_allclose(wide[2] + wide[3], exact[2] + exact[3], atol=ATOL)


def test_blend_weights() -> None:
    assert tstems._BLEND_NEURAL_WEIGHT == jstems._BLEND_NEURAL_WEIGHT
    y = _mixture(SR, seed=9)
    dsp = tstems.separate_stems_arrays(y, SR, device="cpu")
    neural = torch.full((len(NAMES),) + y.shape, 0.5)  # the net's stems, stacked in NAMES order
    blended = tstems._blend_with_dsp(neural, y, SR, device="cpu")
    assert blended.dtype == torch.float32 and blended.shape == (len(NAMES),) + y.shape
    for i, name in enumerate(NAMES):
        w = tstems._BLEND_NEURAL_WEIGHT[name]
        np.testing.assert_allclose(blended[i].numpy(), w * 0.5 + (1.0 - w) * dsp[name], atol=1e-6)


@pytest.fixture(scope="module")
def stereo_wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("stems_src") / "mix.wav"
    write_wav(path, _mixture(2 * SR + 11, seed=10, channels=2), SR)
    return path


def test_write_wav_round_trips_stereo_pcm16(stereo_wav, tmp_path) -> None:
    data, sr, meta = load_audio(stereo_wav, mono=False)
    assert data.shape == (2, 2 * SR + 11) and sr == SR
    assert meta["channels"] == 2 and meta["subtype"] == "PCM_16" and meta["file_type"] == "WAV"
    again = tmp_path / "again.wav"
    write_wav(again, data, SR, subtype="PCM_16")
    back, _sr, _meta = decode_wav(again)
    np.testing.assert_allclose(back, data, atol=LSB)
    mono, _sr, meta = load_audio(stereo_wav, target_sr=22_050)
    assert mono.ndim == 1 and meta["channels"] == 2
    assert meta["duration"] == pytest.approx(mono.size / 22_050.0)


def test_separate_stems_writes_what_jax_writes(stereo_wav, tmp_path, monkeypatch) -> None:
    monkeypatch.delenv("TRACK_ANALYSER_TPU_SEPARATION_CKPT", raising=False)
    ref = jstems.separate_stems(str(stereo_wav), tmp_path / "jax")
    got = tstems.separate_stems(str(stereo_wav), tmp_path / "port", device="cpu")
    assert isinstance(got, tstems.StemBundle)
    assert got.model_name == ref.model_name == "bandsplit-masknet-v5"
    assert tuple(got.stems) == tuple(ref.stems) == NAMES
    source, _sr, _meta = decode_wav(stereo_wav)
    for name in NAMES:
        assert got.stems[name].name == ref.stems[name].name == f"mix_{name}.wav"
        ours, sr, meta = decode_wav(got.stems[name])
        theirs, _sr, _meta = decode_wav(ref.stems[name])
        assert sr == SR and meta["subtype"] == "PCM_16"
        assert ours.shape == theirs.shape == source.shape
        np.testing.assert_allclose(ours, theirs, atol=LSB + ATOL, err_msg=name)


def test_separate_stems_without_a_checkpoint_is_the_dsp_separator(stereo_wav, tmp_path, monkeypatch) -> None:
    monkeypatch.delenv("TRACK_ANALYSER_TPU_SEPARATION_CKPT", raising=False)
    monkeypatch.setattr(separation, "_BUNDLED", ())
    got = tstems.separate_stems(str(stereo_wav), tmp_path, device="cpu")
    assert got.model_name == "hpss-dsp-v1"
    source, _sr, _meta = decode_wav(stereo_wav)
    dsp = tstems.separate_stems_arrays(source, SR, device="cpu")
    for name in NAMES:
        written, _sr, _meta = decode_wav(got.stems[name])
        # written as round(x * 32767), decoded as k / 32768: half a step of
        # rounding plus up to one of scale
        np.testing.assert_allclose(written, dsp[name], atol=1.5 * LSB)


def test_ladder_returns_none_only_for_path_and_file_errors(tmp_path) -> None:
    assert tstems.separate_stems(None, tmp_path, device="cpu") is None
    assert tstems.separate_stems(str(tmp_path / "missing.wav"), tmp_path, device="cpu") is None
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF this file is not audio " * 64)
    with pytest.raises(AudioDecodeError):
        load_audio(bad)
    assert tstems.separate_stems(str(bad), tmp_path, device="cpu") is None
    assert not list(tmp_path.glob("*_drums.wav"))


@pytest.mark.parametrize("where", ["dsp", "net"])
def test_a_failure_inside_a_separator_propagates(where, stereo_wav, tmp_path, monkeypatch) -> None:
    """No DSP result and no None stands in for a separator that failed."""

    def boom(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    if where == "dsp":
        monkeypatch.setattr(tstems, "_dsp_separate_body", boom)
    else:
        monkeypatch.setattr(separation, "separate", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tstems.separate_stems(str(stereo_wav), tmp_path, device="cpu")
    assert not list(tmp_path.glob("*.wav"))


def test_separate_stems_cuda_raises_without_cuda(stereo_wav, tmp_path) -> None:
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the error path needs a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstems.separate_stems(str(stereo_wav), tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstems.separate_stems_arrays(np.zeros(SR, dtype=np.float32), SR)
