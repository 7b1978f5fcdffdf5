"""The port's batched fused graph against the JAX package's, on the CPU.

Every output key of ``full_track_graph`` on a batch of two bucket-padded
stereo lanes of different valid lengths, lane by lane against
``jitted_full_track_graph`` of that lane alone, with both branches of
the shared STFT's switch: ``ops/stft.magnitude`` (the default) and the
fused |STFT| (``TA_PALLAS_STFT=1``, whose plain version runs on the
CPU). Also the padding contract inside the port (a bucket-padded run
equals an exact-shape run over the valid frames), and ``pack_outputs``
/ ``unpack_outputs`` against JAX's on the same graph outputs.

Per-key tolerances are relative to each key's largest magnitude
(``scale``): the graph is float32 end to end, and XLA and PyTorch round
FFTs, log10 and long sums differently, so differences of a few float32
ulps of the scale are expected. Keys built from differences of nearly
equal values (self-similarity, the smoothed percussive-ratio novelty,
the stereo correlation over ~10^5 samples) get more room, each with its
reason beside it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from track_analyser_tpu import substrate as j_sub
from track_analyser_tpu_torch import substrate as t_sub

torch.set_num_threads(2)

SR = 22_050
N = 6 * SR + 321

# key -> tolerance as a fraction of the key's largest |value|
_TOLERANCES = {
    "onset_env": 5e-6,
    "beat_energy": 2e-6,
    "low_energy": 2e-6,
    # |first difference| of a smoothed ratio curve (cancellation), then
    # min-max normalised; still below the f16 step (~5e-4) these rows
    # ship at
    "novelty": 2e-4,
    "energy_novelty": 1e-3,
    "perc_col": 2e-6,
    "harm_col": 2e-6,
    "ltas": 2e-6,
    "centroid": 2e-6,
    # exact unless a bin's cumulative sum sits on the 85% threshold
    "rolloff": 0.0,
    "chroma_cq": 5e-6,
    "chroma_cq_coarse": 5e-6,
    "key_scores": 2e-6,
    "balance_total": 2e-6,
    "balance_low": 2e-6,
    "balance_mid": 2e-6,
    "balance_high": 2e-6,
    "integrated_lufs": 1e-6,
    "short_term_db": 1e-6,
    "momentary_db": 1e-6,
    "true_peak": 1e-6,
    "rms": 1e-6,
    # a float32 dot product of two ~10^5-sample centred channels
    "stereo_corr_centered": 5e-5,
    "stereo_balance": 5e-6,
    "mid_rms": 1e-6,
    "side_rms": 1e-6,
    "stereo_widths": 2e-6,
    "f_valid": 0.0,
}


def _stereo(n: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    t = np.arange(n) / SR
    chord = sum(np.sin(2 * np.pi * f * t) for f in (261.63, 329.63, 392.0))
    chord[n // 2 :] = sum(np.sin(2 * np.pi * f * t[n // 2 :]) for f in (293.66, 349.23, 440.0))
    kick = np.zeros(n)
    for start in range(0, n, SR // 2):
        seg = np.arange(min(1_000, n - start)) / SR
        kick[start : start + seg.size] += np.sin(2 * np.pi * 70 * seg) * np.exp(-seg * 40)
    left = 0.2 * chord + 0.6 * kick + 0.003 * rng.normal(size=n)
    right = 0.12 * chord + 0.6 * kick + 0.003 * rng.normal(size=n)
    return (0.9 * np.stack([left, right]) / 2.0).astype(np.float32)


# The two lanes of the batch: the full fixture, and a shorter one that
# shares its bucket (the reference's vmap over lanes of one bucket).
N_VALID = (N, 4 * SR + 777)
BRANCHES = ("cufft", "fused")


@pytest.fixture(scope="module")
def padded():
    stereo = _stereo(N)
    buf = np.zeros((2, 2, t_sub.bucket_length(N)), dtype=np.float32)
    for b, n in enumerate(N_VALID):
        buf[b, :, :n] = stereo[:, :n]
    return buf


@pytest.fixture(scope="module")
def jax_out(padded):
    outs = []
    for b, n in enumerate(N_VALID):
        out = j_sub.jitted_full_track_graph(jnp.asarray(padded[b]), jnp.asarray(n), sr=SR)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return outs


def _port_graph(padded: np.ndarray, n_valid, branch: str) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        if branch == "fused":
            mp.setenv("TA_PALLAS_STFT", "1")
        else:
            mp.delenv("TA_PALLAS_STFT", raising=False)
        with torch.inference_mode():
            out = t_sub.full_track_graph(
                torch.from_numpy(padded), torch.tensor(n_valid), sr=SR
            )
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def port_outs(padded):
    return {branch: _port_graph(padded, N_VALID, branch) for branch in BRANCHES}


@pytest.fixture(scope="module")
def port_out(port_outs):
    """Lane 0 of the default branch."""

    return {k: v[0] for k, v in port_outs["cufft"].items()}


def test_bucket_length_matches() -> None:
    for n in (1, 32_768, 100_000, N, 44_100 * 180, 44_100 * 30):
        assert t_sub.bucket_length(n) == j_sub.bucket_length(n)


def test_output_keys_match(jax_out, port_out) -> None:
    # autocorr is not ported: the host recomputes it in float64
    assert sorted(port_out) == sorted(set(jax_out[0]) - {"autocorr"})
    assert sorted(_TOLERANCES) == sorted(port_out)


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("lane", range(len(N_VALID)))
@pytest.mark.parametrize("key", sorted(_TOLERANCES))
def test_graph_output_matches_jax(key, lane, branch, jax_out, port_outs) -> None:
    ref = jax_out[lane][key].astype(np.float64)
    got = port_outs[branch][key][lane].astype(np.float64)
    assert got.shape == ref.shape, key
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=_TOLERANCES[key] * scale, err_msg=key)


def test_padding_does_not_change_results(padded, port_out) -> None:
    """Bucket-padded vs exact-shape inside the port: framewise curves over
    the valid frames and every masked global reduction agree.

    Where the JAX package itself does not keep the contract, neither does
    the port (it reproduces the reference): the time median of HPSS reads
    the zero padding within 15 frames (the median radius) of the end, so
    perc_col/harm_col are compared before that, and energy_novelty and
    novelty, which carry that tail through a 0.5 s smoother and a min-max
    normalisation over the whole curve, are left out here (they are held
    to the JAX package's padded run in test_graph_output_matches_jax).
    Likewise the exact-shape decimation stops at 1 + n//decim samples and
    drops the anti-alias filter's tail, which reaches the CQ chroma
    through its longest window (4096 decimated samples = 64 frames), so
    the chroma is compared before the last 64 frames.
    """

    with torch.inference_mode():
        exact = {
            k: v.numpy()[0]
            for k, v in t_sub.full_track_graph(
                torch.from_numpy(np.ascontiguousarray(padded[:1, :, :N])), torch.tensor([N]), sr=SR
            ).items()
        }
    f_valid = 1 + N // 512
    framewise = {
        "onset_env": f_valid, "beat_energy": f_valid, "low_energy": f_valid,
        "centroid": f_valid, "rolloff": f_valid,
        "perc_col": f_valid - 15, "harm_col": f_valid - 15,
    }
    for key, stop in framewise.items():
        ref = exact[key][:stop].astype(np.float64)
        got = port_out[key][:stop].astype(np.float64)
        # a different frame count changes FFT sizes (k-weighting, the
        # smoothing FFT) and the global dB floor's neighbourhood: float32
        # noise relative to the curve's scale
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max(), err_msg=key)
    np.testing.assert_allclose(
        port_out["chroma_cq"][:, : f_valid - 64], exact["chroma_cq"][:, : f_valid - 64],
        rtol=0, atol=1e-4,
    )
    for key in ("integrated_lufs", "rms", "true_peak", "side_rms", "stereo_balance",
                "stereo_corr_centered", "key_scores", "stereo_widths", "ltas",
                "balance_total", "balance_low", "balance_mid", "balance_high"):
        ref = exact[key].astype(np.float64)
        np.testing.assert_allclose(
            port_out[key].astype(np.float64), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
            err_msg=key,
        )


def test_pack_and_unpack_match_jax(port_outs) -> None:
    """The same graph outputs packed by both packages give the same bytes
    (f16/bf16 rounding included), lane by lane, and unpack to the same
    arrays."""

    batch = port_outs["cufft"]
    with torch.inference_mode():
        t_packed = [p.numpy() for p in t_sub.pack_outputs({k: torch.from_numpy(v) for k, v in batch.items()})]
    assert len(t_packed) == 4
    for lane in range(len(N_VALID)):
        j_packed = [
            np.asarray(p)
            for p in j_sub.pack_outputs({k: jnp.asarray(v[lane]) for k, v in batch.items()})
        ]
        assert len(j_packed) == 4
        for got, ref in zip(t_packed, j_packed):
            assert got[lane].shape == ref.shape
            np.testing.assert_array_equal(got[lane].view(ref.dtype), ref)

        t_unpacked = t_sub.unpack_outputs(*(p[lane] for p in t_packed))
        j_unpacked = j_sub.unpack_outputs(*j_packed)
        assert sorted(t_unpacked) == sorted(j_unpacked)
        for key in j_unpacked:
            np.testing.assert_array_equal(
                np.asarray(t_unpacked[key]), np.asarray(j_unpacked[key]), err_msg=key
            )


def test_graph_rejects_unbatched_stereo() -> None:
    with pytest.raises(ValueError, match="B, 2, n"):
        t_sub.full_track_graph(torch.zeros(2, 1 << 15), torch.tensor([100]), sr=SR)
