"""The port's native host library (``native/``) on the CPU: it builds, it
raises where it cannot, and it is held to the port's numpy codecs and
plain quantisers and to the JAX package's binding of the same C++.

- WAV decode equals the numpy codec bit for bit for PCM_U8, PCM_16,
  PCM_24, PCM_32, FLOAT and DOUBLE at 1, 2, 3 and 6 channels, in an
  extensible fmt chunk and with a trailing partial frame, and its mono
  downmix equals ``mean(axis=0)`` bit for bit, on one thread and on four;
  garbage is declined (None).
- FLAC decode equals the numpy decoder bit for bit.
- Every ``ta_quantise_*`` writes the numpy plain version's payload bit
  for bit (codes, scales, bases, the carry) on stereo and mono input,
  ragged lengths, silence and clipping; the float64 stereo sums agree to
  1e-12 (the C++ adds in another order). Against the JAX package's
  binding (over its own build of the same sources, made here in a
  temporary directory) every quantiser output, the sums too, and every
  WAV and FLAC decode is bit-identical.
- The library is a ``ctypes.CDLL``, whose calls release the GIL; without
  a compiler, or with a failing one, the build raises with the log, and
  so does ``analyse_library``, once.
"""

from __future__ import annotations

import ctypes
import stat
import struct

import numpy as np
import pytest

from track_analyser_tpu_torch.io import decode_wav, encode_flac, write_wav
from track_analyser_tpu_torch.io.flac import decode_flac
from track_analyser_tpu_torch.native import binding, build
from track_analyser_tpu_torch.ops import cuda_build
from track_analyser_tpu_torch.parallel import batch as tb
from track_analyser_tpu_torch.utils import AudioInput

BLOCK = tb._I8_BLOCK
SR = 44_100


@pytest.fixture(scope="module")
def lib():
    return binding.load()


def test_the_library_builds_once_and_binds_every_symbol(lib) -> None:
    path, log = build.build_native()
    assert log == "" and path.is_file()  # the fixture built it: cached now
    assert path.parent.name == "torch_kernels" and path.name.startswith("libta_native_")
    for name, (restype, argtypes) in binding._SIGNATURES.items():
        fn = getattr(lib, name)
        assert fn.restype is restype and fn.argtypes == argtypes, name
    assert binding.load() is lib


def test_no_compiler_and_a_failed_build_raise(tmp_path, monkeypatch) -> None:
    """No silent fallback to the numpy quantisers: without a compiler the
    build raises, and a failing compiler's log is in the error."""

    monkeypatch.setattr(cuda_build, "_BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        build.build_native()
    # the sweep raises once, before any track, rather than record every
    # track as failed (its per-track error policy is for the tracks)
    monkeypatch.setattr(binding, "_lib", [])
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tb.analyse_library([str(tmp_path / "a.wav")], device="cpu")
    failing = tmp_path / "failing-cxx"
    failing.write_text("#!/bin/sh\necho 'error: this compiler always fails' >&2\nexit 3\n")
    failing.chmod(failing.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "cxx", lambda: str(failing))
    with pytest.raises(RuntimeError, match="(?s)failed \\(3\\).*this compiler always fails"):
        build.build_native()
    assert not list((tmp_path / "kernels").glob("*.so"))


def _tone(seconds: float, channels: int) -> np.ndarray:
    t = np.arange(int(seconds * SR)) / SR
    rows = [(0.5 - 0.2 * c) * np.sin(2 * np.pi * (440.0 / (c + 1)) * t) for c in range(channels)]
    return np.stack(rows).astype(np.float32)


_WAV_CODES = {"PCM_U8": (1, 8), "PCM_16": (1, 16), "PCM_24": (1, 24), "PCM_32": (1, 32), "FLOAT": (3, 32), "DOUBLE": (3, 64)}


def _wav_bytes(x: np.ndarray, subtype: str, extensible: bool = False, trailing: bytes = b"") -> bytes:
    """A RIFF/WAVE file of the (channels, frames) float32 ``x`` written by
    hand: every subtype the native decoder converts (``write_wav`` writes
    neither PCM_U8 nor DOUBLE), a WAVE_FORMAT_EXTENSIBLE fmt chunk on
    request, and ``trailing`` bytes after the last whole frame."""

    tag, bits = _WAV_CODES[subtype]
    frames = np.ascontiguousarray(x.T)
    if subtype == "PCM_U8":
        body = np.clip(np.round(frames * 128.0 + 128.0), 0, 255).astype(np.uint8).tobytes()
    elif subtype == "PCM_24":
        ints = np.clip(np.round(frames * 2.0**23), -(2**23), 2**23 - 1).astype("<i4")
        body = ints.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    elif tag == 1:
        scale = 2.0 ** (bits - 1)
        body = np.clip(np.round(frames * scale), -scale, scale - 1).astype(f"<i{bits // 8}").tobytes()
    else:
        body = frames.astype(f"<f{bits // 8}").tobytes()
    body += trailing
    channels, block = x.shape[0], x.shape[0] * bits // 8
    fields = (channels, SR, SR * block, block, bits)
    if extensible:  # cbSize 22, valid bits, channel mask, SubFormat GUID led by the real tag
        guid = tag.to_bytes(4, "little") + bytes.fromhex("000000001000800000aa00389b71")
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, *fields, 22, bits, 0) + guid
    else:
        fmt = struct.pack("<HHIIHH", tag, *fields)
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(body)) + body
    if len(body) & 1:
        chunks += b"\0"
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _wav_cases():
    """(subtype, channels, layout): the plain file of every subtype at 1,
    2, 3 and 6 channels, and at 2 and 6 channels an extensible fmt chunk
    and a data chunk ending in a partial frame."""

    cases = [(st, ch, "plain") for st in _WAV_CODES for ch in (1, 2, 3, 6)]
    cases += [(st, ch, layout) for layout in ("extensible", "partial_frame") for st in _WAV_CODES for ch in (2, 6)]
    return cases


@pytest.mark.parametrize(
    "subtype, channels, layout", _wav_cases(),
    ids=[f"{st}-{ch}" + ("" if layout == "plain" else f"-{layout}") for st, ch, layout in _wav_cases()],
)
def test_wav_decode_equals_the_numpy_codec(tmp_path, lib, subtype, channels, layout) -> None:
    """The planes, rate and metadata equal the numpy codec's, and the mono
    the pass writes beside them (asked for at the file's rate) equals
    ``mean(axis=0)`` of the codec's planes, bit for bit."""

    path = tmp_path / f"tone_{subtype}.wav"
    if layout == "plain" and subtype in ("PCM_16", "PCM_24", "PCM_32", "FLOAT") and channels <= 2:
        write_wav(path, _tone(0.25, channels), SR, subtype=subtype)
    else:
        width = _WAV_CODES[subtype][1] // 8
        trailing = bytes(range(1, width * (channels - 1) + 1)) if layout == "partial_frame" else b""
        path.write_bytes(_wav_bytes(_tone(0.25, channels), subtype, layout == "extensible", trailing))
    ref = decode_wav(path)
    got = binding.decode(str(path))
    assert got is not None
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].dtype == np.float32 and got[0].flags.c_contiguous
    assert got[1:] == ref[1:]
    assert got[0].shape == (channels, int(0.25 * SR))
    planes, sr, meta, mono = binding.decode_with_mono(str(path), SR)
    assert np.array_equal(planes, ref[0]) and (sr, meta) == ref[1:]
    assert mono.dtype == np.float32 and mono.shape == (planes.shape[1],)
    assert np.array_equal(mono, ref[0].mean(axis=0))
    assert binding.decode_with_mono(str(path), SR // 2)[3] is None  # a resample comes first


@pytest.mark.parametrize("frames", [(1 << 21) - 1, (1 << 21) + 8195], ids=["one_thread", "four_threads"])
def test_the_threaded_pass_equals_the_one_thread_pass(tmp_path, lib, frames) -> None:
    """Either side of the 2**21-frame threshold the pass writes the numpy
    codec's planes and ``mean(axis=0)``: the threads split the frames and
    change no sample."""

    rng = np.random.default_rng(frames)
    x = rng.uniform(-1.0, 1.0, size=(2, frames)).astype(np.float32)
    path = tmp_path / "long.wav"
    path.write_bytes(_wav_bytes(x, "PCM_16"))
    ref = decode_wav(path)
    planes, sr, meta, mono = binding.decode_with_mono(str(path), SR)
    assert planes.shape == (2, frames) and (sr, meta) == ref[1:]
    assert np.array_equal(planes, ref[0])
    assert np.array_equal(mono, ref[0].mean(axis=0))


def test_a_data_chunk_shorter_than_asked_is_an_error(tmp_path, lib) -> None:
    """``ta_wav_read`` returns non-zero where the file holds fewer frames
    than it was asked for (a file cut between the header and the pass);
    ``decode`` then declines and the numpy codec takes the file."""

    path = tmp_path / "short.wav"
    write_wav(path, _tone(0.1, 2), SR)
    frames, channels, sr, subtype, offset = (ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int(),
                                             ctypes.c_int(), ctypes.c_longlong())
    assert lib.ta_wav_info(str(path).encode(), ctypes.byref(frames), ctypes.byref(channels), ctypes.byref(sr),
                           ctypes.byref(subtype), ctypes.byref(offset)) == 0
    assert (frames.value, channels.value, sr.value, subtype.value) == (int(0.1 * SR), 2, SR, 1)
    more = frames.value + 1
    planes = np.empty((2, more), dtype=np.float32)
    rc = lib.ta_wav_read(str(path).encode(), offset.value, more, 2, subtype.value,
                         planes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), None)
    assert rc != 0


def test_garbage_is_declined(tmp_path, lib) -> None:
    cases = {
        "text.wav": b"not a wav at all",
        "empty.wav": b"",
        "riff_only.wav": b"RIFF\x04\x00\x00\x00WAVE",
        "riff_not_audio.wav": b"RIFF this file is not audio " * 16,
    }
    for name, raw in cases.items():
        (tmp_path / name).write_bytes(raw)
        assert binding.decode(str(tmp_path / name)) is None, name
        assert binding.decode_flac(str(tmp_path / name)) is None, name
    assert binding.decode(str(tmp_path / "missing.wav")) is None
    flac = encode_flac(tmp_path / "a.flac", _tone(0.1, 1), SR)
    assert binding.decode(str(flac)) is None  # a FLAC is no WAV


def test_flac_decode_equals_the_numpy_decoder(tmp_path, lib) -> None:
    rng = np.random.default_rng(3)
    t = np.arange(int(0.6 * SR)) / SR
    tone = 0.5 * np.sin(2 * np.pi * 220.0 * t) + 0.04 * rng.normal(size=t.size)
    stereo = np.stack([tone, 0.8 * tone + 0.02 * rng.normal(size=t.size)]).astype(np.float32)
    for name, data, kwargs in (
        ("mono16", tone.astype(np.float32), {}),
        ("stereo16", stereo, {}),
        ("stereo_ms", stereo, {"stereo_mode": "mid-side"}),
        ("mono24", tone.astype(np.float32), {"bits_per_sample": 24}),
        ("stereo24_ms", stereo, {"bits_per_sample": 24, "stereo_mode": "mid-side"}),
        ("silence", np.zeros(3_000, dtype=np.float32), {}),
    ):
        path = encode_flac(tmp_path / f"{name}.flac", data, SR, **kwargs)
        ref = decode_flac(path)
        got = binding.decode_flac(str(path))
        assert got is not None, name
        np.testing.assert_array_equal(got[0], ref[0], err_msg=name)
        assert got[1:] == ref[1:], name


def _signal(n: int, channels: int, seed: int, *, clip: bool = False) -> np.ndarray:
    """Tones + clicks + noise with a silent stretch (a zero-scale block);
    ``clip`` drives it past full scale."""

    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    base = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.normal(size=n)
    base[:: SR // 2] += 0.8
    x = np.stack([base * (1.0 - 0.3 * c) + 0.02 * rng.normal(size=n) for c in range(channels)])
    x[:, BLOCK // 2 : BLOCK + 3_000] = 0.0
    if clip:
        x *= 3.0
    return x.astype(np.float32)


# (label, channels, samples, clip): ragged lengths inside and past the
# last block, a mono source, a signal driven past full scale
_CASES = [
    ("stereo", 2, 2 * BLOCK + 12_345, False),
    ("mono", 1, BLOCK + 7, False),
    ("stereo_clipped", 2, BLOCK - 1_001, True),
]


@pytest.mark.parametrize("label, channels, n, clip", _CASES, ids=[c[0] for c in _CASES])
def test_i8_and_i16_payloads_equal_the_plain_versions(lib, label, channels, n, clip) -> None:
    x = _signal(n, channels, 1, clip=clip)
    bucket = -(-n // BLOCK) * BLOCK + BLOCK  # a zero block past the signal
    audio = AudioInput(samples=x.mean(axis=0), sample_rate=SR, stereo_samples=x if channels == 2 else None)
    source = tb._source_channels(audio)
    padded, n_valid = tb._pad_track(audio, bucket)
    assert n_valid == n
    vals, scales = binding.quantise_i8(source, bucket, BLOCK)
    ref_vals, ref_scales = tb._quantise_i8(padded)
    np.testing.assert_array_equal(vals, ref_vals)
    np.testing.assert_array_equal(scales, ref_scales)
    assert scales[0, -1] == 0.0
    np.testing.assert_array_equal(binding.quantise_i16_stereo(source, bucket), tb._quantise_i16(padded))
    np.testing.assert_array_equal(binding.quantise_i16(padded[0, :n], bucket), tb._quantise_i16(padded[0]))
    # the staging functions are these calls
    (staged16,), _ = tb._stage_payload_i16(audio, bucket)
    np.testing.assert_array_equal(staged16, tb._quantise_i16(padded))
    staged8, _ = tb._stage_payload_i8(audio, bucket)
    np.testing.assert_array_equal(staged8[0], ref_vals)


@pytest.mark.parametrize("label, channels, n, clip", _CASES, ids=[c[0] for c in _CASES])
def test_mid_quantisers_equal_the_plain_versions(lib, label, channels, n, clip) -> None:
    x = _signal(n, channels, 2, clip=clip)
    bucket = -(-n // BLOCK) * BLOCK
    mid, scales, stats = binding.quantise_mid(x, bucket, BLOCK)
    ref = tb._quantise_mid_range(x, n, 0, bucket)
    np.testing.assert_array_equal(mid, ref[0])
    np.testing.assert_array_equal(scales, ref[1])
    np.testing.assert_allclose(stats, ref[2], rtol=1e-12, atol=0)
    assert stats[0] == n
    # ta_quantise_ms's mid, scales and sums are ta_quantise_mid's
    full = binding.quantise_ms(x, bucket, BLOCK)
    np.testing.assert_array_equal(full[0], mid)
    np.testing.assert_array_equal(full[1], scales)
    np.testing.assert_array_equal(full[5], stats)
    assert full[2].shape == (bucket // 2,) and np.isfinite(full[4])


@pytest.mark.parametrize("bits", [6, 5])
@pytest.mark.parametrize("label, channels, n, clip", _CASES, ids=[c[0] for c in _CASES])
def test_subbyte_quantisers_equal_the_plain_versions(lib, bits, label, channels, n, clip) -> None:
    x = _signal(n, channels, 3, clip=clip)
    block = tb._ms_block(bits)
    bucket = -(-n // BLOCK) * BLOCK
    native = binding.quantise_mid6 if bits == 6 else binding.quantise_mid5
    plain = tb._quantise_mid6_range if bits == 6 else tb._quantise_mid5_range
    for carry in (0.0, 0.25):
        got = native(x, bucket, block, carry)
        ref = plain(x, n, 0, bucket, carry)
        for g, r in zip(got[:3], ref[:3]):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
        np.testing.assert_allclose(got[3], ref[3], rtol=1e-12, atol=0)
        assert got[4] == ref[4]


@pytest.mark.parametrize("bits", [6, 5])
def test_the_delta_coding_chain_equals_the_plain_version(lib, bits) -> None:
    """A smooth signal, where the delta coding with error feedback (a
    negative scale) wins in most blocks: the float32 chain bit for bit."""

    t = np.arange(2 * BLOCK) / SR
    x = np.stack([0.6 * np.sin(2 * np.pi * 55.0 * t), 0.5 * np.sin(2 * np.pi * 55.0 * t + 0.1)]).astype(np.float32)
    native = binding.quantise_mid6 if bits == 6 else binding.quantise_mid5
    plain = tb._quantise_mid6_range if bits == 6 else tb._quantise_mid5_range
    got = native(x, 2 * BLOCK, tb._ms_block(bits))
    ref = plain(x, x.shape[1], 0, 2 * BLOCK)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g, r)
    assert got[4] == ref[4]
    assert (got[1] < 0).mean() > 0.5


def test_the_staged_ms_payloads_are_the_native_ones(lib) -> None:
    x = _signal(3 * BLOCK - 777, 2, 4)
    audio = AudioInput(samples=x.mean(axis=0), sample_rate=SR, stereo_samples=x)
    bucket = tb.ms_bucket_length(x.shape[1])
    qlen = tb._ms_quantise_len(x.shape[1], bucket)
    for bits, fn in ((8, binding.quantise_mid), (6, binding.quantise_mid6), (5, binding.quantise_mid5)):
        parts, (stats, _widths), n_valid = tb._stage_payload_ms(audio, bucket, bits)
        want = fn(x, qlen, tb._ms_block(bits))
        np.testing.assert_array_equal(parts[0][: want[0].size], want[0])
        assert not parts[0][want[0].size :].any()
        np.testing.assert_array_equal(stats, want[-1] if bits == 8 else want[3])
        assert n_valid == x.shape[1]


@pytest.fixture(scope="module")
def jax_binding(tmp_path_factory):
    """The JAX package's binding over its own build of the same sources
    (its build function, its flags), compiled into a temporary directory:
    the library file inside the JAX package is neither read nor written."""

    from track_analyser_tpu.native import binding as jax_native
    from track_analyser_tpu.native import build as jax_build

    folder = tmp_path_factory.mktemp("jax_native")
    assert jax_build._compile(build.cxx(), jax_build.SRCS, folder / jax_build.OUT.name, verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "__file__", str(folder / "binding.py"))
        mp.setattr(jax_native, "_lib", None)
        assert jax_native.available() and jax_native.has_transport()
        yield jax_native


def test_every_quantiser_equals_the_jax_binding(lib, jax_binding) -> None:
    """The same C++ with the same flags: every output bit-identical to the
    JAX package's binding, the float64 sums too."""

    for label, channels, n, clip in _CASES:
        x = _signal(n, channels, 5, clip=clip)
        src = x[0] if channels == 1 else x
        bucket = -(-n // BLOCK) * BLOCK
        pairs = [
            (binding.quantise_i8(src, bucket, BLOCK), jax_binding.quantise_i8(src, bucket, BLOCK)),
            ((binding.quantise_i16_stereo(src, bucket),), (jax_binding.quantise_i16_stereo(src, bucket),)),
            (binding.quantise_ms(src, bucket, BLOCK), jax_binding.quantise_ms(src, bucket, BLOCK)),
            (binding.quantise_mid(src, bucket, BLOCK), jax_binding.quantise_mid(src, bucket, BLOCK)),
            (binding.quantise_mid6(src, bucket, BLOCK, 0.5), jax_binding.quantise_mid6(src, bucket, BLOCK, 0.5)),
            (binding.quantise_mid5(src, bucket, 1024, 0.5), jax_binding.quantise_mid5(src, bucket, 1024, 0.5)),
        ]
        for k, (got, ref) in enumerate(pairs):
            assert len(got) == len(ref), (label, k)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(r), err_msg=f"{label} {k}")


def test_decoders_equal_the_jax_binding(tmp_path, lib, jax_binding) -> None:
    """WAV (every subtype) and FLAC decode through both bindings of the
    same C++: samples, rate and metadata identical."""

    x = _tone(0.2, 2)
    paths = []
    for subtype in ("PCM_16", "PCM_24", "PCM_32", "FLOAT"):
        paths.append((binding.decode, jax_binding.decode, tmp_path / f"t_{subtype}.wav"))
        write_wav(paths[-1][2], x, SR, subtype=subtype)
    for bps in (16, 24):
        flac = encode_flac(tmp_path / f"t_{bps}.flac", x, SR, bits_per_sample=bps, stereo_mode="mid-side")
        paths.append((binding.decode_flac, jax_binding.decode_flac, flac))
    for ours, theirs, path in paths:
        got, ref = ours(str(path)), theirs(str(path))
        assert got is not None and ref is not None, path.name
        np.testing.assert_array_equal(got[0], ref[0], err_msg=path.name)
        assert got[1:] == ref[1:], path.name


def test_bad_shapes_raise_before_the_call(lib) -> None:
    x = np.zeros((2, 100), dtype=np.float32)
    with pytest.raises(ValueError, match="do not fit"):
        binding.quantise_i16_stereo(x, 64)
    with pytest.raises(ValueError, match="multiple of block"):
        binding.quantise_mid(x, 1000, 64)
    with pytest.raises(ValueError, match="multiple of block"):
        binding.quantise_mid6(x, 1024, 1022)
    with pytest.raises(ValueError, match="shape"):
        binding.quantise_i8(np.zeros((3, 10), dtype=np.float32), 64, 64)
    with pytest.raises(ValueError, match="one channel"):
        binding.quantise_i16(x, 128)


def test_native_calls_release_the_gil(lib) -> None:
    """The library is a ctypes.CDLL, not a PyDLL: no bound function carries
    the flag that would keep the GIL for the call, so the sweep's staging
    threads quantise in parallel."""

    assert type(lib) is ctypes.CDLL
    assert {"ta_wav_info", "ta_wav_read"} <= set(binding._SIGNATURES)  # the one-pass WAV decode
    for name in binding._SIGNATURES:
        assert not type(getattr(lib, name))._flags_ & ctypes._FUNCFLAG_PYTHONAPI, name
