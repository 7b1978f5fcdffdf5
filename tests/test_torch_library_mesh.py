"""The port's library sweep over a mesh of dispatch workers
(``analyse_library(mesh=...)``), on the CPU.

The 4-source library of ``test_torch_library.py`` (two stereo WAVs, one
mono WAV, one file that does not decode) goes through:

- the port's sweep on two CPU workers against the JAX sweep on two of
  the suite's eight virtual CPU devices, position by position
  (``chip_smoke.compare_results``);
- the port's sweep on one, two and three CPU workers against its
  one-device sweep: bit for bit at ``device_batch=1``, within
  ``compare_results`` at ``device_batch=2``.

Also: the manifest's resume, ``shard`` striping and the progress count
under a mesh, the meshes that raise, the default mesh taken from
``device``, an error in one worker (it propagates and leaves no thread
running), ``analyze-batch --device cpu``, and the caches the workers
share.
"""

from __future__ import annotations

import json
import threading

import pytest
import torch

from chip_smoke import compare_results, differing_fields, make_track, with_noise_floor
from test_torch_library import GOOD, LIBRARY, SR
from track_analyser_tpu_torch.io import write_wav
from track_analyser_tpu_torch.parallel import batch as tb
from track_analyser_tpu_torch.pipeline import TrackAnalysisResult

torch.set_num_threads(2)

# A sweep that raises must end well inside this many seconds (a hung
# worker would hold the call forever).
ERROR_DEADLINE_S = 120.0


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_library")
    paths = []
    for name, seconds, bpm, seed, stereo in LIBRARY:
        path = root / name
        if seconds is None:
            path.write_bytes(b"RIFF this file is not audio " * 64)
        else:
            x = with_noise_floor(make_track(seconds, bpm=bpm, seed=seed), 100 + seed)
            write_wav(path, x if stereo else x.mean(axis=0), SR)
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def one_device(sources):
    return tb.analyse_library(sources, device="cpu")


@pytest.fixture(scope="module")
def jax_two_devices(sources):
    import jax

    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.parallel.mesh import make_mesh

    return analyse_library(sources, mesh=make_mesh(devices=jax.devices()[:2]), transport="ms")


def test_two_workers_match_the_jax_sweep_on_two_devices(sources, jax_two_devices) -> None:
    from track_analyser_tpu.parallel.batch import TrackFailure as JaxTrackFailure

    got = tb.analyse_library(sources, device="cpu", mesh=["cpu", "cpu"])
    assert len(got) == len(jax_two_devices) == len(LIBRARY)
    for i, (g, ref) in enumerate(zip(got, jax_two_devices)):
        if i in GOOD:
            assert isinstance(g, TrackAnalysisResult), i
            compare_results(g, ref, f"port on two workers vs JAX on two devices, source {i}")
        else:
            assert isinstance(g, tb.TrackFailure) and isinstance(ref, JaxTrackFailure)
            assert g.source == ref.source


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_mesh_equals_one_device_bit_for_bit(workers, sources, one_device) -> None:
    got = tb.analyse_library(sources, device="cpu", mesh=["cpu"] * workers)
    assert [type(g) for g in got] == [type(r) for r in one_device]
    for i in GOOD:
        assert differing_fields(got[i], one_device[i]) == [], (workers, i)


@pytest.mark.parametrize("workers", [2, 3])
def test_mesh_at_device_batch_two_agrees_with_one_device(workers, sources, one_device) -> None:
    got = tb.analyse_library(sources, device="cpu", mesh=[torch.device("cpu")] * workers, device_batch=2)
    assert isinstance(got[1], tb.TrackFailure)
    for i in GOOD:
        compare_results(got[i], one_device[i], f"{workers} workers at device_batch 2 vs one device, source {i}")


def test_manifest_resumes_under_a_mesh(sources, tmp_path) -> None:
    manifest = tmp_path / "sweep.jsonl"
    tb.analyse_library(sources, device="cpu", mesh=["cpu", "cpu"], manifest_path=manifest)
    records = [json.loads(line) for line in manifest.read_text().splitlines()]
    assert sorted(r["source"] for r in records) == sorted(sources)
    assert [r["source"] for r in records if "error" in r] == [sources[1]]
    rerun = tb.analyse_library(sources, device="cpu", mesh=["cpu", "cpu"], manifest_path=manifest)
    for i, item in enumerate(rerun):
        assert isinstance(item, tb.SkippedTrack if i in GOOD else tb.TrackFailure), (i, item)


def test_shard_with_a_mesh_covers_each_source_once(sources) -> None:
    shards = [tb.analyse_library(sources, device="cpu", mesh=["cpu", "cpu"], shard=(k, 2)) for k in range(2)]
    for i in range(len(sources)):
        kinds = [type(shard[i]) for shard in shards]
        others = [s[i] for s in shards if isinstance(s[i], tb.SkippedTrack)]
        assert len(others) == 1 and others[0].reason == "other-shard", (i, kinds)
        assert sum(k is not tb.SkippedTrack for k in kinds) == 1, (i, kinds)


def test_progress_counts_each_source_once(sources) -> None:
    seen = []
    tb.analyse_library(
        sources * 2, device="cpu", mesh=["cpu", "cpu"],
        progress_callback=lambda src, done, total: seen.append((src, done, total)),
    )
    assert [done for _src, done, _total in seen] == list(range(1, 2 * len(sources) + 1))
    assert {total for _src, _done, total in seen} == {2 * len(sources)}
    assert sorted(src for src, _done, _total in seen) == sorted(sources * 2)


@pytest.mark.parametrize(
    "mesh",
    [[], ["cpu", "cuda"], ["cuda:0", torch.device("cpu")], ["meta"], ["cpu", "meta"]],
    ids=["empty", "cpu-cuda", "cuda-cpu", "meta", "cpu-meta"],
)
def test_bad_meshes_raise(mesh) -> None:
    with pytest.raises(ValueError, match="mesh"):
        tb.analyse_library([], device="cpu", mesh=mesh)


def test_default_mesh_comes_from_device(monkeypatch) -> None:
    """Without ``mesh``: "cpu" is one CPU worker, "cuda" every visible card,
    "cuda:N" that card; a CUDA entry comes back indexed. The card count is
    faked, so no card is touched."""

    assert tb._resolve_mesh(None, "cpu") == [torch.device("cpu")]
    assert tb._resolve_mesh(["cpu", "cpu"], "cuda") == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = [torch.device("cuda", i) for i in range(3)]
    assert tb._resolve_mesh(None, "cuda") == cards
    assert tb._resolve_mesh(None, torch.device("cuda")) == cards
    assert tb._resolve_mesh(None, "cuda:2") == [cards[2]]
    assert tb._resolve_mesh(["cuda", "cuda:0", "cuda:1"], "cpu") == [cards[0], cards[0], cards[1]]
    with pytest.raises(ValueError, match="not visible"):
        tb._resolve_mesh(["cuda:3"], "cuda")


def test_cuda_mesh_raises_without_cuda(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mesh in (None, ["cuda:0", "cuda:0"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tb.analyse_library([], device="cuda", mesh=mesh)


def test_an_error_in_one_worker_propagates_and_stops_every_thread(sources, monkeypatch) -> None:
    """``_dispatch`` raises on worker 1's second chunk: the sweep raises
    that error, within the deadline, and every thread it started has
    ended."""

    real = tb._dispatch
    calls: dict = {}

    def failing(*args, **kwargs):
        name = threading.current_thread().name
        calls[name] = calls.get(name, 0) + 1
        if name.startswith("analyse_library-worker1") and calls[name] == 2:
            raise RuntimeError("injected device error on worker 1")
        return real(*args, **kwargs)

    monkeypatch.setattr(tb, "_dispatch", failing)
    before = set(threading.enumerate())
    outcome: dict = {}

    def sweep():
        try:
            tb.analyse_library(sources * 3, device="cpu", mesh=["cpu", "cpu"])
        except BaseException as exc:  # handed to the test thread
            outcome["error"] = exc

    runner = threading.Thread(target=sweep, daemon=True)
    runner.start()
    runner.join(ERROR_DEADLINE_S)
    assert not runner.is_alive(), f"the sweep did not end within {ERROR_DEADLINE_S} s"
    error = outcome.get("error")
    assert isinstance(error, RuntimeError) and "injected device error on worker 1" in str(error), error
    assert any(name.startswith("analyse_library-worker1") and n >= 2 for name, n in calls.items()), calls
    left = [t.name for t in set(threading.enumerate()) - before - {runner} if t.is_alive()]
    assert left == []


def test_analyze_batch_on_the_cpu_runs(sources, tmp_path, capsys) -> None:
    from track_analyser_tpu_torch.cli import main

    code = main(["analyze-batch", *sources, "--out", str(tmp_path), "--device", "cpu", "--plots", "skip"])
    out = capsys.readouterr().out
    assert code == 0, out
    assert f"({len(GOOD)} track(s), 1 failed)" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        name[: -len(".wav")] for name, seconds, *_ in LIBRARY if seconds is not None
    )


def test_the_workers_caches_build_each_entry_once() -> None:
    """The fused STFT's tables and bases and the downbeat net, asked for
    from eight threads at once, are one object each."""

    from track_analyser_tpu_torch.models import downbeat as downbeat_model
    from track_analyser_tpu_torch.models import downbeat_net
    from track_analyser_tpu_torch.ops import fused_stft

    params = dict(downbeat_model._net_params())  # a new dict: a key no call has built
    calls = {
        "tables": lambda: fused_stft.fft_tables(2048, "cpu"),
        "basis": lambda: fused_stft.windowed_basis(1024, "cpu")[0],
        "net": lambda: downbeat_net.model_for(params, torch.device("cpu")),
    }
    for name, call in calls.items():
        barrier = threading.Barrier(8)
        got = []

        def ask():
            barrier.wait()
            got.append(call())

        threads = [threading.Thread(target=ask) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(got) == 8 and all(g is got[0] for g in got), name
