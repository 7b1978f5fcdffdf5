"""The port's numpy FLAC codec (``io/flac.py``) against the JAX package's,
on the same bytes, on the CPU.

Decode is held bit for bit to the JAX decoder (1 and 2 channels, 16 and
24 bits, and streams built of constant, verbatim, fixed, LPC and
mid-side subframes); the encoder must write the JAX encoder's bytes; the
committed golden vector decodes to its committed samples; corrupt and
truncated streams raise ``AudioDecodeError``. Inputs are made from seeds
with numpy and kept short: the numpy codec takes ~0.3 s a second of
44.1 kHz stereo.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path

import numpy as np
import pytest

from track_analyser_tpu.io import flac as jax_flac
from track_analyser_tpu_torch.io import AudioDecodeError, decode_file
from track_analyser_tpu_torch.io.flac import _lpc_candidate, decode_flac, encode_flac

GOLDEN = Path(__file__).parent / "golden" / "flac_tiny.json"


def _int_samples(data: np.ndarray, bps: int) -> np.ndarray:
    return np.round(np.asarray(data, dtype=np.float64) * float(1 << (bps - 1))).astype(np.int64)


def _musical(seconds: float, sr: int, channels: int, seed: int = 5) -> np.ndarray:
    """Tones + noise (fixed prediction and Rice coding)."""

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    rows = [0.5 * np.sin(2 * np.pi * (220.0 + 110.0 * c) * t) + 0.05 * rng.normal(size=t.size) for c in range(channels)]
    out = np.stack(rows)
    return (out / np.max(np.abs(out)) * 0.8).astype(np.float32)


def _decode_both(path: Path):
    got, ref = decode_flac(path), jax_flac.decode_flac(path)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].dtype == ref[0].dtype == np.float32
    assert got[1:] == ref[1:]
    return got


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bps", [16, 24])
def test_round_trip_is_lossless_and_equals_jax(tmp_path, channels, bps) -> None:
    sr = 44_100
    audio = _musical(0.5, sr, channels)
    path = encode_flac(tmp_path / f"rt_{channels}_{bps}.flac", audio, sr, bits_per_sample=bps)
    ref_path = jax_flac.encode_flac(tmp_path / f"ref_{channels}_{bps}.flac", audio, sr, bits_per_sample=bps)
    assert path.read_bytes() == ref_path.read_bytes()
    data, got_sr, meta = _decode_both(path)
    assert got_sr == sr and data.shape == (channels, audio.shape[1])
    assert meta == {"channels": channels, "duration": audio.shape[1] / sr, "file_type": "FLAC", "subtype": f"PCM_{bps}"}
    full = 1 << (bps - 1)
    np.testing.assert_array_equal(_int_samples(data, bps), np.clip(_int_samples(audio, bps), -full, full - 1))


@pytest.mark.parametrize(
    "name, make",
    [
        ("constant", lambda rng: np.full(10_000, 0.25, dtype=np.float32)),
        ("silence", lambda rng: np.zeros(5_000, dtype=np.float32)),
        ("verbatim", lambda rng: rng.uniform(-0.99, 0.99, size=20_000).astype(np.float32)),
        (
            "lpc",
            lambda rng: (
                0.6 * np.sin(2 * np.pi * 220.0 * np.arange(26_460) / 44_100)
                + 0.2 * np.sin(2 * np.pi * 331.0 * np.arange(26_460) / 44_100)
            ).astype(np.float32),
        ),
    ],
)
def test_subframe_kinds_decode_bit_exact(tmp_path, name, make) -> None:
    """Constant and silent blocks, white noise (verbatim or escape-coded
    residuals) and a strongly tonal signal (quantised-LPC subframes)."""

    x = make(np.random.default_rng(0))
    if name == "lpc":
        assert _lpc_candidate(_int_samples(x[:4096], 16), 8) is not None
        assert _lpc_candidate(_int_samples(x[:4096], 16), 8)[1] == jax_flac._lpc_candidate(_int_samples(x[:4096], 16), 8)[1]
    path = encode_flac(tmp_path / f"{name}.flac", x, 44_100)
    assert path.read_bytes() == jax_flac.encode_flac(tmp_path / f"ref_{name}.flac", x, 44_100).read_bytes()
    data, _sr, _meta = _decode_both(path)
    np.testing.assert_array_equal(_int_samples(data[0], 16), _int_samples(x, 16))


def test_mid_side_and_integer_input_decode_bit_exact(tmp_path) -> None:
    """Channel assignment 10 with odd L + R sums (the side's low bit
    carries into the mid), from integer input; the same samples coded
    as independent channels decode alike."""

    ints = _int_samples(_musical(0.4, 44_100, 2), 16)
    ints[0, ::3] += 1
    path = encode_flac(tmp_path / "ms.flac", ints, 44_100, stereo_mode="mid-side")
    assert path.read_bytes() == jax_flac.encode_flac(tmp_path / "ref_ms.flac", ints, 44_100, stereo_mode="mid-side").read_bytes()
    data, _sr, meta = _decode_both(path)
    assert meta["channels"] == 2
    np.testing.assert_array_equal(_int_samples(data, 16), ints)
    independent, _sr, _meta = _decode_both(encode_flac(tmp_path / "ind.flac", ints, 44_100))
    np.testing.assert_array_equal(independent, data)


def test_rates_off_the_header_table_and_small_blocks(tmp_path) -> None:
    """11 025 Hz is not in the frame header's rate table (a 16-bit field
    follows), and a 1 000-sample block size gives many frames."""

    x = _musical(0.3, 11_025, 1)
    path = encode_flac(tmp_path / "rate.flac", x, 11_025, block_size=1_000)
    assert path.read_bytes() == jax_flac.encode_flac(tmp_path / "ref.flac", x, 11_025, block_size=1_000).read_bytes()
    _data, sr, _meta = _decode_both(path)
    assert sr == 11_025


def test_golden_vector_decodes(tmp_path) -> None:
    blob = json.loads(GOLDEN.read_text())
    path = tmp_path / "golden.flac"
    path.write_bytes(zlib.decompress(bytes.fromhex(blob["flac_hex_zlib"])))
    data, sr, _meta = _decode_both(path)
    assert sr == blob["sample_rate"]
    expected = np.asarray(blob["samples_int16"], dtype=np.int64)
    np.testing.assert_array_equal(_int_samples(data[0], 16)[: expected.size], expected)


def test_corrupt_and_truncated_streams_raise(tmp_path) -> None:
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"fLaC" + b"\x00" * 64)
    with pytest.raises(AudioDecodeError, match="STREAMINFO"):
        decode_flac(bad)
    with pytest.raises(AudioDecodeError, match=f"Could not decode audio file: {bad}$"):
        decode_file(bad)
    from track_analyser_tpu_torch.io import ffmpeg

    whole = _musical(0.5, 44_100, 1)
    blob = encode_flac(tmp_path / "whole.flac", whole, 44_100).read_bytes()
    for frac in (0.3, 0.5, 0.99):
        cut = tmp_path / f"cut_{frac}.flac"
        cut.write_bytes(blob[: int(len(blob) * frac)])
        with pytest.raises(AudioDecodeError, match="truncated"):
            decode_flac(cut)
        # the ladder steps down to the ffmpeg tier, which decodes the
        # frames that are whole (as the JAX package's ladder does)
        if ffmpeg.available():
            data, _sr, meta = decode_file(cut)
            assert meta["file_type"] == "FLAC" and 0 < data.shape[1] < whole.shape[1]
        else:
            with pytest.raises(AudioDecodeError, match="Could not decode audio file") as info:
                decode_file(cut)
            assert isinstance(info.value.__cause__, AudioDecodeError)
    not_flac = tmp_path / "not.flac"
    not_flac.write_bytes(b"RIFF")
    with pytest.raises(AudioDecodeError, match="Not a FLAC file"):
        decode_flac(not_flac)
