"""The port's ``coerce_audio`` and ``load_audio`` on a WAV path, on the CPU.

The native decode writes the channel-major planes and, where the file's
rate is ``coerce_audio``'s ``target_sr``, the mono downmix in one pass;
both must equal the numpy codec followed by ``mean(axis=0)``, bit for
bit. At another rate the planes are resampled first and downmixed after,
as the numpy composition does.
"""

from __future__ import annotations

import numpy as np

from track_analyser_tpu_torch.io import decode_wav, load_audio, write_wav
from track_analyser_tpu_torch.ops.resample import resample_poly_host
from track_analyser_tpu_torch.utils import coerce_audio


def _port_stereo_wav(tmp_path, sr: int):
    rng = np.random.default_rng(sr)
    x = (0.5 * rng.uniform(-1.0, 1.0, size=(2, sr // 4))).astype(np.float32)
    path = tmp_path / f"stereo_{sr}.wav"
    write_wav(path, x, sr, subtype="PCM_16")
    return path


def test_port_coerce_path_at_its_own_rate_is_the_codec_and_its_mean(tmp_path):
    path = _port_stereo_wav(tmp_path, 44_100)
    planes, sr, _meta = decode_wav(path)
    audio = coerce_audio(path, target_sr=sr)
    assert audio.sample_rate == sr and audio.path == str(path)
    assert audio.samples.dtype == np.float32 and audio.stereo_samples.dtype == np.float32
    assert np.array_equal(audio.stereo_samples, planes)
    assert np.array_equal(audio.samples, planes.mean(axis=0))


def test_port_coerce_path_at_another_rate_resamples_then_downmixes(tmp_path):
    path = _port_stereo_wav(tmp_path, 22_050)
    planes, sr, _meta = decode_wav(path)
    stereo = resample_poly_host(planes, sr, 44_100)
    audio = coerce_audio(path, target_sr=44_100)
    assert audio.sample_rate == 44_100
    assert np.array_equal(audio.stereo_samples, stereo)
    assert np.array_equal(audio.samples, stereo.mean(axis=0))
    kept = coerce_audio(path, target_sr=44_100, mono=False)  # the mono resampled on its own
    assert np.array_equal(kept.samples, resample_poly_host(planes.mean(axis=0), sr, 44_100))


def test_port_load_audio_keeps_the_codec_planes(tmp_path):
    path = _port_stereo_wav(tmp_path, 44_100)
    planes, sr, meta = decode_wav(path)
    data, rate, got_meta = load_audio(path, mono=False)
    assert rate == sr and got_meta == meta
    assert data.dtype == np.float32 and data.flags.c_contiguous
    assert np.array_equal(data, planes)
    mono, _rate, _meta = load_audio(path)
    assert np.array_equal(mono, planes.mean(axis=0))
