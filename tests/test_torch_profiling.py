"""The port's observability helpers on the CPU: ``profiling.StageTimer``
and ``profiling.device_trace``, and the ``TRACK_ANALYSER_TPU_DEBUG_NANS=1``
sanitizer (``device.check_nans``).

- ``StageTimer`` records the seven stages the per-module path reports
  through its progress callback, in the JAX package's order, and reports
  as the JAX package's ``StageTimer`` does for the same stages.
- ``device_trace`` writes a Chrome trace that names the ops it ran.
- With the variable set, a NaN injected into one graph's output raises
  ``FloatingPointError`` naming the graph and the output; without it the
  NaN passes through; with it a clean analysis runs through.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from track_analyser_tpu.profiling import StageTimer as JaxStageTimer
from track_analyser_tpu_torch import analyse_track, tempo
from track_analyser_tpu_torch.device import DEBUG_NANS, check_nans
from track_analyser_tpu_torch.parallel import batch
from track_analyser_tpu_torch.profiling import StageTimer, device_trace
from track_analyser_tpu_torch.utils import AudioInput

torch.set_num_threads(2)

SR = 22_050
# the per-module path's stages, in the order the JAX package's
# pipeline.analyse_track(fused=False) reports them
STAGES = ["audio", "beats", "structure", "loudness", "harmonic", "features", "stereo"]


def _clip(seconds: float = 4.0) -> AudioInput:
    t = np.arange(int(seconds * SR)) / SR
    kick = np.zeros_like(t)
    for b in np.arange(0.0, seconds, 0.5):
        s = int(b * SR)
        seg = np.arange(min(int(0.05 * SR), t.size - s)) / SR
        kick[s : s + seg.size] += np.sin(2 * np.pi * (60 + 50 * np.exp(-seg * 60)) * seg) * np.exp(-seg * 40)
    chord = 0.3 * np.sin(2 * np.pi * 261.63 * t) + 0.2 * np.sin(2 * np.pi * 329.63 * t)
    noise = np.random.default_rng(3).normal(0.0, 0.003, size=(2, t.size))
    stereo = (np.stack([chord + 0.8 * kick, 0.7 * chord + 0.8 * kick]) + noise).astype(np.float32)
    stereo *= 0.9 / np.abs(stereo).max()
    return AudioInput(samples=stereo.mean(axis=0), sample_rate=SR, stereo_samples=stereo)


def test_stage_timer_records_the_per_module_stages() -> None:
    seen: list = []
    timer = StageTimer()
    analyse_track(_clip(), fused=False, device="cpu", progress_callback=timer.callback(seen.append))
    assert timer.stages == seen == STAGES
    assert set(timer.durations) == set(STAGES)
    assert all(d >= 0.0 for d in timer.durations.values())
    assert timer.total == pytest.approx(sum(timer.durations.values()))
    lines = timer.report().splitlines()
    assert len(lines) == len(STAGES) + 2 and lines[-1].startswith("total")

    # the JAX package's StageTimer, fed the same stages, lays out the same report
    ref = JaxStageTimer()
    ref.stages, ref.durations = list(timer.stages), dict(timer.durations)
    assert ref.report() == timer.report()


def test_device_trace_writes_a_chrome_trace(tmp_path) -> None:
    with device_trace(tmp_path / "traces") as path:
        x = torch.randn(256, 256)
        (x @ x).sum()
    assert path.parent == tmp_path / "traces" and path.is_file()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("matmul" in n or "mm" in n for n in names), sorted(names)[:20]


def test_check_nans_names_the_graph_and_the_output(monkeypatch) -> None:
    clean = {"a": torch.zeros(3), "codes": torch.zeros(3, dtype=torch.int16)}
    bad = {"a": torch.zeros(3), "b": torch.tensor([0.0, float("nan")])}
    monkeypatch.delenv(DEBUG_NANS, raising=False)
    assert check_nans("g", bad) is bad  # off: no check, no sync
    monkeypatch.setenv(DEBUG_NANS, "1")
    assert check_nans("g", clean) is clean
    assert check_nans("g", (torch.tensor([float("inf")]),))  # NaN only, as jax_debug_nans
    with pytest.raises(FloatingPointError, match="NaN in output 'b' of the device graph g"):
        check_nans("g", bad)
    with pytest.raises(FloatingPointError, match="output 1 of the device graph h"):
        check_nans("h", (torch.zeros(2), torch.full((2,), float("nan"))))


def test_a_nan_in_a_per_module_graph_raises_only_with_the_variable(monkeypatch) -> None:
    real = tempo._envelope_graph

    def poisoned(*args, **kwargs):
        env = real(*args, **kwargs)
        env[3] = float("nan")
        return env

    monkeypatch.setattr(tempo, "_envelope_graph", poisoned)
    y = _clip(2.0).samples
    monkeypatch.delenv(DEBUG_NANS, raising=False)
    assert np.isnan(tempo._padded_envelope(y, SR, 512, "cpu")).sum() == 1
    monkeypatch.setenv(DEBUG_NANS, "1")
    with pytest.raises(FloatingPointError, match="tempo._envelope_graph"):
        tempo._padded_envelope(y, SR, 512, "cpu")


def test_a_nan_in_the_fused_graph_raises_only_with_the_variable(monkeypatch) -> None:
    real = batch.full_track_graph

    def poisoned(*args, **kwargs):
        out = dict(real(*args, **kwargs))
        out["momentary_db"] = out["momentary_db"].clone()
        out["momentary_db"][..., 0] = float("nan")
        return out

    audio = _clip(2.0)
    monkeypatch.setattr(batch, "full_track_graph", poisoned)
    stereo = torch.from_numpy(np.ascontiguousarray(audio.stereo_samples))[None]
    n_valid = torch.tensor([stereo.shape[-1]])
    monkeypatch.delenv(DEBUG_NANS, raising=False)
    with torch.inference_mode():
        batch._core_graph(stereo, n_valid, sr=SR)
    monkeypatch.setenv(DEBUG_NANS, "1")
    with pytest.raises(FloatingPointError, match="'momentary_db' of the device graph parallel.batch._core_graph"):
        analyse_track(audio, device="cpu")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_module"])
def test_a_clean_analysis_passes_the_sanitizer(monkeypatch, fused) -> None:
    monkeypatch.setenv(DEBUG_NANS, "1")
    result = analyse_track(_clip(), fused=fused, device="cpu")
    assert np.isfinite(result.beat.bpm)
