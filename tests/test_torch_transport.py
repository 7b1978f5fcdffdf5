"""The port's host transports against the JAX package's, on the CPU.

The quantisers, the host-exact stereo values and the bucket arithmetic
of the "int8", "int16" and "ms" transports are numpy copies in the port;
each is held bit for bit against the JAX function on the same input.
The "ms" payload must equal the JAX package's chunked parts
concatenated (its zero chunks materialised), and the device-side
decoders must reproduce the JAX decoders exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from track_analyser_tpu.parallel import batch as jb
from track_analyser_tpu.utils import AudioInput as JaxAudioInput
from track_analyser_tpu_torch.parallel import batch as tb
from track_analyser_tpu_torch.utils import AudioInput

torch.set_num_threads(2)

SR = 22_050
BLOCK = 65_536


def _signal(n: int, channels: int, seed: int) -> np.ndarray:
    """Tones + clicks + noise, with a silent stretch (a zero-scale block)."""

    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    base = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.normal(size=n)
    base[:: SR // 2] += 0.8
    x = np.stack([base * (1.0 - 0.3 * c) + 0.02 * rng.normal(size=n) for c in range(channels)])
    x[:, BLOCK : 2 * BLOCK] = 0.0
    return x.astype(np.float32)


def _audio_pair(n: int, stereo: bool, seed: int = 0):
    x = _signal(n, 2 if stereo else 1, seed)
    st = x if stereo else None
    mono = x.mean(axis=0) if stereo else x[0]
    return (
        AudioInput(samples=mono, sample_rate=SR, stereo_samples=st),
        JaxAudioInput(samples=mono, sample_rate=SR, stereo_samples=st),
    )


def test_quantise_i8_is_bit_exact() -> None:
    x = _signal(3 * BLOCK, 2, 1)
    got_v, got_s = tb._quantise_i8(x)
    ref_v, ref_s = jb._quantise_i8(x)
    np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(got_s, ref_s)
    assert got_s[0, 1] == 0.0  # the silent block


@pytest.mark.parametrize("start, end", [(0, 3 * BLOCK), (BLOCK, 3 * BLOCK), (0, 4 * BLOCK)])
def test_quantise_mid_range_is_bit_exact(start, end) -> None:
    x = _signal(3 * BLOCK - 777, 2, 2)
    n = x.shape[1]
    got = tb._quantise_mid_range(x, n, start, end)
    ref = jb._quantise_mid_range(x, n, start, end)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_stereo_stats_are_bit_exact() -> None:
    x = _signal(100_003, 2, 3)
    for n_valid in (100_003, 50_000, 0):
        np.testing.assert_array_equal(
            tb._stereo_stats(x[0], x[1], n_valid), jb._stereo_stats(x[0], x[1], n_valid)
        )


@pytest.mark.parametrize("n, channels", [(5 * SR + 11, 2), (3 * SR, 1), (700, 2), (0, 2)])
def test_host_stereo_widths_are_bit_exact(n, channels) -> None:
    x = _signal(max(n, 1), channels, 4)[:, :n]
    np.testing.assert_array_equal(
        tb._host_stereo_widths(x, SR), jb._host_stereo_widths(x, SR)
    )


_LENGTHS = [1, 32_768, 100_000, 2_000_000, 1 << 21, (1 << 21) + 1, 44_100 * 181, 44_100 * 600,
            44_100 * 1_500, 44_100 * 1_600, 44_100 * 3_000]


def test_ms_bucket_arithmetic_is_exact() -> None:
    for n in _LENGTHS:
        bucket = tb.ms_bucket_length(n)
        assert bucket == jb.ms_bucket_length(n), n
        assert bucket % BLOCK == 0
        assert tb._ms_chunk_ranges(bucket) == jb._ms_chunk_ranges(bucket), n
        assert tb._ms_quantise_len(n, bucket) == jb._ms_quantise_len(n, bucket), n


@pytest.mark.parametrize("quantiser", ["numpy", "native"])
@pytest.mark.parametrize("seconds, stereo", [(5.5, True), (4.0, False), (8.0, True)])
def test_ms_payload_equals_jax_parts_concatenated(seconds, stereo, quantiser, monkeypatch) -> None:
    """Against the JAX package's numpy quantiser, bit for bit; against its
    native C++ one, the payload bit for bit and the float64 stereo sums
    to 1e-12 (the C++ loop adds in another order)."""

    if quantiser == "numpy":
        from track_analyser_tpu.native import binding as native_binding

        def _unavailable(*_args, **_kwargs):
            raise RuntimeError("native quantiser switched off for this test")

        monkeypatch.setattr(native_binding, "quantise_mid", _unavailable)
    audio, jax_audio = _audio_pair(int(seconds * SR), stereo, seed=5)
    bucket = tb.ms_bucket_length(len(audio.samples))
    (mid, scales), (stats, widths), n_valid = tb._stage_payload_ms(audio, bucket)
    parts, (ref_stats, ref_widths), ref_n = jb._stage_payload_ms(jax_audio, bucket)
    chunks = [p.materialise() if isinstance(p, jb._ZeroChunk) else np.asarray(p) for p in parts[:-1]]
    ref_mid = np.concatenate(chunks)
    assert mid.shape == ref_mid.shape == (bucket,)
    np.testing.assert_array_equal(mid, ref_mid)
    np.testing.assert_array_equal(scales, np.asarray(parts[-1]))
    if quantiser == "numpy":
        np.testing.assert_array_equal(stats, ref_stats)
    else:
        np.testing.assert_allclose(stats, ref_stats, rtol=1e-12, atol=0)
    assert n_valid == ref_n
    if stereo:
        np.testing.assert_array_equal(widths, ref_widths)
    else:
        assert widths is None and ref_widths is None


@pytest.mark.parametrize("stereo", [True, False])
def test_int8_and_int16_payloads_are_bit_exact(stereo) -> None:
    audio, jax_audio = _audio_pair(int(5.0 * SR), stereo, seed=6)
    bucket = tb.bucket_length(len(audio.samples))
    (vals, scales), n_valid = tb._stage_payload_i8(audio, bucket)
    (ref_vals, ref_scales), ref_n = jb._stage_payload_i8(jax_audio, bucket)
    np.testing.assert_array_equal(vals, np.asarray(ref_vals))
    np.testing.assert_array_equal(scales, np.asarray(ref_scales))
    (p16,), n16 = tb._stage_payload_i16(audio, bucket)
    ref16, ref_n16 = jb._stage_payload_i16(jax_audio, bucket)
    np.testing.assert_array_equal(p16, np.asarray(ref16))
    assert n_valid == ref_n == n16 == ref_n16


def test_device_decoders_match_jax() -> None:
    x = _signal(3 * BLOCK, 2, 7)
    vals, scales = tb._quantise_i8(x)
    got = tb._dequantise_i8(torch.from_numpy(vals)[None], torch.from_numpy(scales)[None])[0]
    ref = np.asarray(jb._dequantise_i8(jnp.asarray(vals), jnp.asarray(scales)))
    np.testing.assert_array_equal(got.numpy(), ref)
    # "ms" decodes its (B, n) mid lanes with the same blockwise decoder
    mono = tb._dequantise_i8(torch.from_numpy(vals[:1]), torch.from_numpy(scales[:1]))
    ref_mono = np.asarray(jb._dequantise_mono_i8(jnp.asarray(vals[0]), jnp.asarray(scales[0])))
    np.testing.assert_array_equal(mono[0].numpy(), ref_mono)


def test_host_stereo_stats_overwrite_matches_jax() -> None:
    x = _signal(4 * SR, 2, 8)
    stats = tb._stereo_stats(x[0], x[1], x.shape[1])
    widths = tb._host_stereo_widths(x, SR)
    got, ref = {"stereo_widths": np.zeros(3)}, {"stereo_widths": np.zeros(3)}
    tb._apply_host_stereo_stats(got, stats, widths)
    jb._apply_host_stereo_stats(ref, stats, widths)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_unported_transports_raise_and_name_the_roadmap() -> None:
    audio, _ = _audio_pair(2 * SR, True)
    for transport in ("ms6", "ms5"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tb.analyse_track_fused(audio, transport=transport, device="cpu")
    with pytest.raises(ValueError, match="unknown transport"):
        tb.analyse_track_fused(audio, transport="mp3", device="cpu")
