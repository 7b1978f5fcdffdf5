"""The port's host transports against the JAX package's, on the CPU.

The quantisers, the packers, the host-exact stereo values and the bucket
arithmetic of the "int8", "int16", "ms", "ms6" and "ms5" transports: the
port stages through its native library and keeps numpy copies of the
JAX package's quantisers as their plain versions; each is held bit for
bit against the JAX function on the same input (and the sub-byte
quantisers also against the JAX package's native C++ ones). With the
plain versions swapped in for the native ones, the mid-only payloads
must equal the JAX package's numpy-staged chunked parts concatenated
(its zero chunks materialised), and
the device-side decoders must reproduce the JAX decoders exactly: the
sub-byte decode ``base + int32-cumsum(codes) * step`` is a multiply and
an add on both sides (XLA's CPU lowering does not contract it into a
fused multiply-add here), so it is held bit for bit too.
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


def _plain_quantisers(monkeypatch) -> None:
    """Stage through the port's numpy plain versions instead of its native
    library, as the JAX package stages without its own."""

    monkeypatch.setattr(tb.native_binding, "quantise_mid", lambda x, nb, _block: tb._quantise_mid_range(x, x.shape[1], 0, nb))
    monkeypatch.setattr(tb.native_binding, "quantise_mid6", lambda x, nb, _block: tb._quantise_mid6_range(x, x.shape[1], 0, nb))
    monkeypatch.setattr(tb.native_binding, "quantise_mid5", lambda x, nb, _block: tb._quantise_mid5_range(x, x.shape[1], 0, nb))


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
    """Both packages on their numpy quantisers, bit for bit; both on
    their native C++ ones, bit for bit too where the JAX package's
    library is built (its float64 stereo sums held to 1e-12 against the
    numpy-staged JAX sums otherwise: the C++ loop adds in another order)."""

    if quantiser == "numpy":
        from track_analyser_tpu.native import binding as native_binding

        def _unavailable(*_args, **_kwargs):
            raise RuntimeError("native quantiser switched off for this test")

        monkeypatch.setattr(native_binding, "quantise_mid", _unavailable)
        _plain_quantisers(monkeypatch)
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


@pytest.mark.parametrize("bits", [6, 5])
@pytest.mark.parametrize(
    "start, end, carry", [(0, 3 * BLOCK, 0.0), (BLOCK, 3 * BLOCK, 0.25), (0, 4 * BLOCK, 0.0)]
)
def test_subbyte_quantisers_are_bit_exact(bits, start, end, carry) -> None:
    """ms6 / ms5 against the JAX numpy quantisers: packed codes, scales,
    bases, stereo sums and the carry, over ranges inside and past the
    signal (the tail quantises zeros)."""

    x = _signal(3 * BLOCK - 777, 2, 2)
    n = x.shape[1]
    port, ref = _SUBBYTE[bits]
    got = port(x, n, start, end, carry)
    want = ref(x, n, start, end, carry)
    for g, r in zip(got[:4], want[:4]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[4] == want[4]
    assert got[0].size == (end - start) * bits // 8


@pytest.mark.parametrize("bits", [6, 5])
def test_subbyte_delta_coding_is_bit_exact(bits) -> None:
    """A smooth signal, where the delta coding (negative scale) wins in
    most blocks: its error-feedback chain, op for op."""

    t = np.arange(2 * BLOCK) / SR
    x = np.stack([0.6 * np.sin(2 * np.pi * 55.0 * t), 0.5 * np.sin(2 * np.pi * 55.0 * t + 0.1)]).astype(np.float32)
    got = _SUBBYTE[bits][0](x, x.shape[1], 0, 2 * BLOCK)
    want = _SUBBYTE[bits][1](x, x.shape[1], 0, 2 * BLOCK)
    for g, r in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, r)
    assert (got[1] < 0).mean() > 0.5


_SUBBYTE = {6: (tb._quantise_mid6_range, jb._quantise_mid6_range), 5: (tb._quantise_mid5_range, jb._quantise_mid5_range)}


@pytest.mark.parametrize("bits", [6, 5])
def test_subbyte_quantisers_match_the_native_ones(bits) -> None:
    from track_analyser_tpu.native import binding as native_binding

    x = _signal(2 * BLOCK + 4_321, 2, 9)
    native = (native_binding.quantise_mid6 if bits == 6 else native_binding.quantise_mid5)(
        x, 3 * BLOCK, tb._ms_block(bits)
    )
    if native is None:
        pytest.skip("the JAX package's native quantiser is not built here")
    got = _SUBBYTE[bits][0](x, x.shape[1], 0, 3 * BLOCK)
    for g, r in zip(got[:3], native[:3]):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_allclose(got[3], native[3], rtol=1e-12, atol=0)


@pytest.mark.parametrize("bits", [6, 5])
def test_packers_are_bit_exact_and_unpack_back(bits) -> None:
    qmax, bias = (31, 32) if bits == 6 else (15, 16)
    codes = np.random.default_rng(bits).integers(-qmax, qmax + 1, size=8 * 1_024) + bias
    codes = codes.astype(np.uint8)
    pack_port, pack_jax = (tb._pack_i6, jb._pack_i6) if bits == 6 else (tb._pack_i5, jb._pack_i5)
    packed = pack_port(codes)
    np.testing.assert_array_equal(packed, pack_jax(codes))
    assert packed.size == codes.size * bits // 8
    unpacked = tb._unpack_codes(torch.from_numpy(packed)[None], bits)[0].numpy()
    np.testing.assert_array_equal(unpacked, codes.astype(np.int32) - bias)


@pytest.mark.parametrize("bits", [6, 5])
def test_subbyte_device_decoders_match_jax(bits) -> None:
    x = _signal(3 * BLOCK, 2, 10)
    packed, scales, bases, _stats, _carry = _SUBBYTE[bits][0](x, x.shape[1], 0, 3 * BLOCK)
    got = tb._dequantise_subbyte(
        torch.from_numpy(packed)[None], torch.from_numpy(scales)[None], torch.from_numpy(bases)[None], bits
    )[0].numpy()
    decode = jb._dequantise_mono_i6 if bits == 6 else jb._dequantise_mono_i5
    ref = np.asarray(decode(jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(bases)))
    assert got.shape == ref.shape == (3 * BLOCK,)
    np.testing.assert_array_equal(got, ref)
    # the decode reconstructs the mid within half a step of the coarsest block
    mid = 0.5 * (x[0] + x[1])
    step = np.abs(scales).max() / (31.0 if bits == 6 else 15.0)
    assert np.abs(got - mid).max() <= step


@pytest.mark.parametrize("quantiser", ["numpy", "native"])
@pytest.mark.parametrize("transport, bits", [("ms6", 6), ("ms5", 5)])
@pytest.mark.parametrize("stereo", [True, False])
def test_subbyte_payload_equals_jax_parts(transport, bits, stereo, quantiser, monkeypatch) -> None:
    from track_analyser_tpu.native import binding as native_binding

    if quantiser == "numpy":
        for name in ("quantise_mid", "quantise_mid6", "quantise_mid5"):
            monkeypatch.setattr(native_binding, name, lambda *a, **k: None)
        _plain_quantisers(monkeypatch)
    audio, jax_audio = _audio_pair(int(5.5 * SR), stereo, seed=5)
    bucket = tb.ms_bucket_length(len(audio.samples))
    (vals, scales, bases), (stats, widths), n_valid = tb._stage_payload_ms(audio, bucket, bits)
    parts, (ref_stats, ref_widths), ref_n = jb._stage_payload_ms(jax_audio, bucket, bits)
    chunks = [p.materialise() if isinstance(p, jb._ZeroChunk) else np.asarray(p) for p in parts[:-2]]
    ref_vals = np.concatenate(chunks)
    assert vals.shape == ref_vals.shape == (bucket * bits // 8,)
    np.testing.assert_array_equal(vals, ref_vals)
    np.testing.assert_array_equal(scales, np.asarray(parts[-2]))
    np.testing.assert_array_equal(bases, np.asarray(parts[-1]))
    assert scales.shape == bases.shape == (bucket // tb._ms_block(bits),)
    if quantiser == "numpy":
        np.testing.assert_array_equal(stats, ref_stats)
    else:
        np.testing.assert_allclose(stats, ref_stats, rtol=1e-12, atol=0)
    assert n_valid == ref_n
    if stereo:
        np.testing.assert_array_equal(widths, ref_widths)
    else:
        assert widths is None and ref_widths is None


@pytest.mark.parametrize("bits", [6, 5])
def test_an_empty_range_gives_empty_parts(bits) -> None:
    """The port's copy returns empty parts and the carry unchanged where
    the JAX numpy quantiser raises IndexError (port only)."""

    x = _signal(BLOCK, 2, 11)
    packed, scales, bases, stats, carry = _SUBBYTE[bits][0](x, x.shape[1], BLOCK, BLOCK, 0.5)
    assert packed.size == scales.size == bases.size == 0
    assert packed.dtype == np.uint8 and scales.dtype == bases.dtype == np.float32
    assert carry == 0.5
    np.testing.assert_array_equal(stats, tb._stereo_stats(x[0, :0], x[1, :0], 0))


def test_subbyte_transports_run_and_unknown_ones_raise() -> None:
    """Every transport of the JAX package runs ("ms6" and "ms5" too, their
    BPM within the decision margin of the float32 path); an unknown one
    raises."""

    from test_torch_pipeline import _rich_stereo

    x = _rich_stereo()  # 120 BPM
    audio = AudioInput(samples=x.mean(axis=0), sample_rate=SR, stereo_samples=x)
    exact = tb.analyse_track_fused(audio, transport="float32", device="cpu")
    assert exact.beat.bpm == pytest.approx(120.0, abs=0.1)
    # test_agreement.py's decision margins for the two transports
    for transport in ("ms6", "ms5"):
        got = tb.analyse_track_fused(audio, transport=transport, device="cpu")
        assert got.beat.bpm == pytest.approx(120.0, abs=0.1), transport
        assert got.loudness.integrated_lufs == pytest.approx(exact.loudness.integrated_lufs, abs=0.15)
        assert got.loudness.true_peak_dbfs == pytest.approx(exact.loudness.true_peak_dbfs, abs=0.1)
        assert got.harmonic.primary_key.key == exact.harmonic.primary_key.key
        assert got.downbeat.source == exact.downbeat.source
        assert abs(len(got.structure.segments) - len(exact.structure.segments)) <= 1
        assert got.stereo.correlation == pytest.approx(exact.stereo.correlation, abs=1e-4)
    with pytest.raises(ValueError, match="unknown transport"):
        tb.analyse_track_fused(audio, transport="mp3", device="cpu")
