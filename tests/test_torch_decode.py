"""The port's decode ladder (``io/codecs.decode_file``) against the JAX
package's decoders on the same bytes, on the CPU.

- The committed golden Ogg and MP3 vectors decode through the port's
  libvorbisfile and libmpg123 tiers to exactly what the JAX package's
  tiers give (the same system libraries), and to the committed samples.
- The ffmpeg tier decodes an MP3 as libmpg123 does, and the ladder falls
  through to it where the MP3 tier is absent.
- Fuzzed WAV and FLAC inputs decode or raise ``AudioDecodeError``,
  nothing else; a non-audio file gives exactly "Could not decode audio
  file: <path>"; an exception that is not a decode error (a binding's
  ``TypeError``) propagates out of the ladder.
- Each tier is absent only where its system library is.
- ``analyse_track(device="cpu")`` on an 8 s fixture as a PCM_16 WAV and
  as a 16-bit FLAC of the same samples gives equal results, field for
  field, and the FLAC result agrees with the JAX package's
  ``analyse_track`` on the same file within the CPU parity tests'
  tolerances (``chip_smoke.compare_results``).

A tier's test skips only where its system library is absent here.
"""

from __future__ import annotations

import ctypes
import json
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import compare_results, differing_fields
from synth import progression
from track_analyser_tpu_torch.io import (
    AudioDecodeError,
    codecs,
    decode_file,
    decode_wav,
    encode_flac,
    ffmpeg,
    mpg123,
    vorbis,
    write_wav,
)
from track_analyser_tpu_torch.native import binding
from track_analyser_tpu_torch.native import build as native_build

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "golden"
SR = 44_100


def _golden(tmp_path: Path, name: str, key: str, suffix: str) -> "tuple[Path, dict]":
    blob = json.loads((GOLDEN / name).read_text())
    path = tmp_path / f"golden{suffix}"
    path.write_bytes(zlib.decompress(bytes.fromhex(blob[key])))
    return path, blob


def _skip_unless(tier) -> None:
    reason = tier.unavailable_reason()
    if reason is not None:
        pytest.skip(f"{tier.__name__.rsplit('.', 1)[-1]} tier absent: {reason}")


def test_golden_ogg_decodes_as_the_jax_tier_does(tmp_path) -> None:
    from track_analyser_tpu.io import vorbis as jax_vorbis

    _skip_unless(vorbis)
    path, blob = _golden(tmp_path, "ogg_tiny.json", "ogg_hex_zlib", ".ogg")
    data, sr, meta = decode_file(path)
    ref = jax_vorbis.decode_ogg(path)
    np.testing.assert_array_equal(data, ref[0])
    assert (sr, meta) == ref[1:] and sr == blob["sample_rate"]
    assert meta["file_type"] == "OGG" and data.shape[0] == 1 and data.shape[1] > blob["n_samples_min"]
    spec = np.abs(np.fft.rfft(data[0, : sr // 2]))
    assert abs(np.fft.rfftfreq(sr // 2, 1 / sr)[np.argmax(spec)] - blob["tone_hz"]) < 5.0


def test_golden_mp3_decodes_as_the_jax_tier_does(tmp_path) -> None:
    from track_analyser_tpu.io import mpg123 as jax_mpg123

    _skip_unless(mpg123)
    path, blob = _golden(tmp_path, "mp3_tiny.json", "mp3_hex_zlib", ".mp3")
    data, sr, meta = decode_file(path)
    ref = jax_mpg123.decode_mp3(path)
    np.testing.assert_array_equal(data, ref[0])
    assert (sr, meta) == ref[1:] and sr == blob["sample_rate"] and meta["file_type"] == "MP3"
    expected = np.frombuffer(bytes.fromhex(blob["decoded_ch0_f32_hex"]), dtype=np.float32)
    np.testing.assert_allclose(data[0][:: blob["decoded_stride"]][: expected.size], expected, atol=1e-4)


@pytest.fixture(scope="module")
def mp3_tone(tmp_path_factory):
    from test_mp3 import _encode_mp3

    t = np.arange(SR) / SR
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    path = tmp_path_factory.mktemp("mp3") / "tone.mp3"
    if not _encode_mp3(path, tone, SR):
        pytest.skip("libmp3lame absent: no MP3 to decode")
    return path


def test_ffmpeg_tier_agrees_with_mpg123_and_the_jax_tier(mp3_tone) -> None:
    from track_analyser_tpu.io import ffmpeg as jax_ffmpeg

    _skip_unless(ffmpeg)
    got = ffmpeg.decode(str(mp3_tone))
    assert got is not None
    data, sr, meta = got
    assert sr == SR and data.shape[0] == 1 and meta["subtype"] == "FLOAT"
    if jax_ffmpeg.available():
        ref = jax_ffmpeg.decode(str(mp3_tone))
        np.testing.assert_array_equal(data, ref[0])
        assert (sr, meta) == ref[1:]
    if mpg123.available():
        other, other_sr, _ = mpg123.decode_mp3(mp3_tone)
        assert other_sr == sr
        # two decoders of one stream: equal up to their delay handling
        m = min(data.shape[-1], other.shape[-1]) - 2_000
        x, y = data[0], other[0]
        denom = float(np.linalg.norm(x[:m]) * np.linalg.norm(y[:m])) + 1e-12
        best = max(abs(float(np.dot(x[s : s + m], y[:m]))) / denom for s in range(0, 2_000, 250))
        assert best > 0.9


def test_the_ladder_falls_through_to_ffmpeg(mp3_tone, monkeypatch) -> None:
    _skip_unless(ffmpeg)
    monkeypatch.setattr(mpg123, "available", lambda: False)
    data, sr, meta = decode_file(str(mp3_tone))
    assert sr == SR and data.shape[0] == 1 and data.shape[-1] > SR // 2
    assert meta["subtype"] == "FLOAT"  # the ffmpeg tier's


def test_fuzzed_wav_and_flac_escape_only_as_decode_errors(tmp_path) -> None:
    """Truncated and byte-flipped WAV/FLAC files decode (a partly valid
    file is a valid outcome) or raise AudioDecodeError; no parser's or
    library's error escapes another way."""

    t = np.arange(int(0.25 * 22_050)) / 22_050
    y = (0.3 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    wav = tmp_path / "a.wav"
    write_wav(wav, y, 22_050)
    flac = encode_flac(tmp_path / "a.flac", (y * 32767).astype(np.int16)[None, :], 22_050)
    rng = np.random.default_rng(7)
    outcomes = {"decoded": 0, "refused": 0}
    for src in (wav, flac):
        raw = src.read_bytes()
        cases = [raw[: int(len(raw) * f)] for f in (0.05, 0.4, 0.9)]
        for _ in range(12):
            b = bytearray(raw)
            for _ in range(int(rng.integers(1, 8))):
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
            cases.append(bytes(b))
        for i, case in enumerate(cases):
            path = tmp_path / f"fuzz_{i}{src.suffix}"
            path.write_bytes(case)
            try:
                data, rate, _meta = decode_file(str(path))
            except AudioDecodeError as exc:
                assert str(exc) == f"Could not decode audio file: {path}"
                outcomes["refused"] += 1
                continue
            assert rate > 0 and data.ndim == 2 and data.dtype == np.float32
            outcomes["decoded"] += 1
    assert outcomes["decoded"] > 0


def test_a_non_audio_file_gives_the_jax_message(tmp_path) -> None:
    for name, raw in (
        ("bad.wav", b"RIFF this file is not audio " * 64),
        ("noise.bin", b"\x00\x01garbage-not-audio" * 10),
        ("not_audio.mp3", b"\x00\x01\x02\x03 this is not audio"),
    ):
        path = tmp_path / name
        path.write_bytes(raw)
        with pytest.raises(AudioDecodeError) as info:
            decode_file(path)
        assert str(info.value) == f"Could not decode audio file: {path}"
        # the first-party codec's error is the cause where the container matched one
        assert (info.value.__cause__ is not None) == name.endswith(".wav")
    with pytest.raises(AudioDecodeError, match="Could not decode audio file"):
        decode_file(tmp_path / "missing.wav")


def test_an_exception_that_is_no_decode_error_propagates(tmp_path, monkeypatch) -> None:
    """The ladder steps down on decode errors only: a TypeError (a binding
    bug) or a ctypes ArgumentError inside a tier reaches the caller."""

    path = tmp_path / "a.ogg"
    path.write_bytes(b"OggS" + b"\x00" * 60)

    def broken(*_args, **_kwargs):
        raise TypeError("a binding bug")

    monkeypatch.setattr(vorbis, "available", lambda: True)
    monkeypatch.setattr(vorbis, "decode_ogg", broken)
    with pytest.raises(TypeError, match="a binding bug"):
        decode_file(path)

    def declines(*_args, **_kwargs):
        raise AudioDecodeError("vorbisfile could not open it")

    monkeypatch.setattr(vorbis, "decode_ogg", declines)
    monkeypatch.setattr(ffmpeg, "available", lambda: False)
    with pytest.raises(AudioDecodeError, match="Could not decode audio file"):
        decode_file(path)  # a decode error steps down, to the end here

    wav = tmp_path / "a.wav"
    write_wav(wav, np.zeros(100, dtype=np.float32), SR)

    def argument_error(*_args, **_kwargs):
        raise ctypes.ArgumentError("argument 2: wrong type")

    monkeypatch.setattr(binding, "decode", argument_error)
    with pytest.raises(ctypes.ArgumentError):
        decode_file(wav)
    monkeypatch.setattr(binding, "decode", lambda _path: None)  # the library declines
    data, sr, meta = decode_file(wav)  # the numpy codec takes it
    assert sr == SR and meta["file_type"] == "WAV" and data.shape == (1, 100)


def test_a_tier_is_absent_only_without_its_system_library(monkeypatch) -> None:
    import ctypes.util

    for tier in (vorbis, mpg123):
        assert tier.available() == (tier.unavailable_reason() is None)
    real = ctypes.util.find_library
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    assert vorbis.unavailable_reason() == "no system libvorbisfile" and not vorbis.available()
    assert mpg123.unavailable_reason() == "no system libmpg123" and not mpg123.available()
    assert native_build._probe_ffmpeg().startswith("no system libavformat")
    monkeypatch.setattr(ctypes.util, "find_library", real)
    present = all(real(name) for name in native_build.FFMPEG_LIBS)
    if present:
        # the libraries are here: the tier hangs on the headers alone
        monkeypatch.setattr(native_build, "cxx", lambda: "false")
        assert "headers are absent" in native_build._probe_ffmpeg()


def _fixture(seconds: float = 8.0) -> np.ndarray:
    """A 120 BPM kick grid + I-IV-V-I chords + stereo imbalance + a -50
    dBFS noise floor at 44.1 kHz (no resampling on the way in)."""

    n = int(seconds * SR)
    t = np.arange(n) / SR
    chords = np.tile(progression([(60, "maj"), (65, "maj"), (67, "maj"), (60, "maj")], 2.0, SR), 2)[:n]
    kick = np.zeros(n)
    for i, b in enumerate(np.arange(0.0, seconds, 0.5)):
        s, e = int(b * SR), min(n, int(b * SR) + int(0.05 * SR))
        seg = np.arange(e - s) / SR
        kick[s:e] += (1.0 if i % 4 == 0 else 0.45) * np.sin(2 * np.pi * (60 + 50 * np.exp(-seg * 60)) * seg) * np.exp(-seg * 40)
    left = 0.5 * chords + 0.8 * kick
    right = 0.35 * chords + 0.8 * kick + 0.05 * np.sin(2 * np.pi * 3000.0 * t)
    stereo = np.stack([left, right]) + np.random.default_rng(7).normal(0.0, 0.003, size=(2, n))
    return (stereo * (0.9 / np.abs(stereo).max())).astype(np.float32)


def test_flac_and_wav_of_the_same_samples_analyse_alike_and_as_jax(tmp_path) -> None:
    from track_analyser_tpu import analyse_track as jax_analyse_track
    from track_analyser_tpu_torch import analyse_track

    wav = tmp_path / "track.wav"
    write_wav(wav, _fixture(), SR, subtype="PCM_16")
    samples, _sr, _meta = decode_wav(wav)
    # the WAV's own integers, so both files hold the same samples
    flac = encode_flac(tmp_path / "track.flac", np.round(samples * 32768.0).astype(np.int64), SR)
    decoded, sr, meta = decode_file(flac)
    assert meta["file_type"] == "FLAC" and sr == SR
    np.testing.assert_array_equal(decoded, samples)

    from_wav = analyse_track(str(wav), device="cpu")
    from_flac = analyse_track(str(flac), device="cpu")
    assert from_flac.audio.path == str(flac)
    assert differing_fields(from_flac, from_wav) == []
    ref = jax_analyse_track(str(flac))
    compare_results(from_flac, ref, "port vs JAX on the FLAC", rounding_differs=True)
