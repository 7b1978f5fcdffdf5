"""The batched graph as a captured CUDA graph (``parallel.batch._dispatch``),
the device-constant cache it needs, and the launch counts it holds.

The CPU tests hold the cache, the graph key, the LRU bound and the CPU
dispatch, which stays eager. The ``gpu``-marked tests hold a replay bit for
bit to the eager path (``TRACK_ANALYSER_TPU_DEBUG_NANS=1`` keeps the
dispatch eager) at the benchmark's two buckets; they skip on a host
without CUDA. This file imports no JAX, so that on the card it runs as
``python3 -m pytest --noconftest -m gpu tests/test_torch_graphs.py``.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

from track_analyser_tpu_torch import profiling, substrate
from track_analyser_tpu_torch.device import DEBUG_NANS, device_constant
from track_analyser_tpu_torch.ops import cuda_build, loudness, mel, spectral, stft
from track_analyser_tpu_torch.ops.median import median31
from track_analyser_tpu_torch.parallel import batch
from track_analyser_tpu_torch.utils import AudioInput

torch.set_num_threads(2)

SR = 44_100
# The benchmark's buckets: a 30 s clip (sweep-gtzan22k, resampled to
# 44.1 kHz) and a 138.5 s CD track (single-cd44k's mean length).
SECONDS = {"sweep": 30.0, "cd": 138.5}


def _audio(seconds: float, seed: int, sr: int = SR) -> AudioInput:
    """A stereo pulse train over tones and noise: onsets, pitch and a side
    channel for every part of the graph."""

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    beat = (np.mod(t, 60.0 / (110 + seed % 20)) < 0.02).astype(np.float64)
    tone = 0.2 * np.sin(2 * np.pi * (110.0 + 20 * (seed % 7)) * t)
    left = 0.5 * beat + tone + 0.01 * rng.standard_normal(n)
    right = 0.4 * beat + 0.8 * tone + 0.01 * rng.standard_normal(n)
    stereo = np.stack([left, right]).astype(np.float32)
    return AudioInput(samples=stereo.mean(axis=0), sample_rate=sr, stereo_samples=stereo)


def _staged(transport: str, audios, dev):
    """The chunk's payload uploaded to ``dev``, as ``_dispatch`` takes it."""

    n_bucket = batch._bucket_for(transport)(len(audios[0].samples))
    staged = [batch._stage_track(a, transport, n_bucket) for a in audios]
    parts = [np.stack([s[0][p] for s in staged]) for p in range(len(staged[0][0]))]
    return batch._upload(parts, [s[2] for s in staged], torch.device(dev))


def _run(transport: str, staged) -> "list[np.ndarray]":
    outs, events = batch._dispatch(transport, staged, sr=SR)
    return batch._fetch(outs, events)


def _same(a, b) -> bool:
    """Equal bit for bit, through dataclasses, containers and arrays."""

    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and _same(dataclasses.asdict(a), dataclasses.asdict(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return a == b


# ---------------------------------------------------------------------------
# The device-constant cache.
# ---------------------------------------------------------------------------


def _ramp(n: int, scale: float = 1.0) -> np.ndarray:
    return (scale * np.linspace(-1.0, 1.0, n)).astype(np.float32)


def test_device_constant_is_one_tensor_per_array_and_device() -> None:
    first = device_constant(_ramp, 513, device="cpu")
    assert device_constant(_ramp, 513, device="cpu") is first
    assert device_constant(_ramp, 513, device=torch.device("cpu")) is first
    assert np.array_equal(first.numpy(), _ramp(513)) and first.dtype == torch.float32
    as64 = device_constant(_ramp, 513, device="cpu", dtype=torch.float64)
    assert as64 is not first and as64.dtype == torch.float64
    assert device_constant(_ramp, 513, device="cpu", dtype=torch.float64) is as64
    # Another argument, positional or by keyword, is another constant.
    assert device_constant(_ramp, 514, device="cpu") is not first
    scaled = device_constant(_ramp, 513, device="cpu", scale=2.0)
    assert scaled is not first and np.array_equal(scaled.numpy(), _ramp(513, 2.0))
    assert device_constant(_ramp, 513, device="cpu", scale=2.0) is scaled


def test_device_constant_of_a_tuple_builder_is_a_tuple_of_tensors() -> None:
    from track_analyser_tpu_torch.ops.chroma import multires_cq_filterbanks

    got = device_constant(multires_cq_filterbanks, SR, 8192, 4096, 16, low_octaves=3, device="cpu")
    want = multires_cq_filterbanks(SR, 8192, 4096, 16, low_octaves=3)
    assert isinstance(got, tuple) and len(got) == len(want) == 2
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    assert device_constant(multires_cq_filterbanks, SR, 8192, 4096, 16, low_octaves=3, device="cpu") is got


def test_device_constant_is_a_normal_tensor_under_inference_mode() -> None:
    with torch.inference_mode():
        const = device_constant(_ramp, 12, device="cpu", scale=3.0)
    assert not const.is_inference()
    x = torch.ones(12, requires_grad=True)
    (x * const).sum().backward()  # autograd may save it
    assert np.array_equal(x.grad.numpy(), _ramp(12, 3.0))


def test_device_constant_from_many_threads_is_one_tensor() -> None:
    built = []

    def ones(n: int) -> np.ndarray:
        built.append(n)
        return np.ones((n, n), dtype=np.float32)

    barrier = threading.Barrier(8)
    got = []

    def ask():
        barrier.wait()
        got.append(device_constant(ones, 64, device="cpu"))

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert built == [64]  # built once


@pytest.mark.parametrize(
    "builder, args",
    [
        (mel.mel_filterbank, (SR, 2048, 128)),
        (spectral.balance_band_weights, (SR, 2048)),
        (stft.hann_window, (2048,)),
        (loudness._k_weighting_spectrum, (SR, 65_536)),
        (substrate._key_profiles, ()),
        (stft.fft_frequencies, (SR, 2048)),
    ],
    ids=["mel", "balance", "hann", "k_weighting_spectrum", "key_profiles", "bin_frequencies"],
)
def test_the_graphs_constants_are_built_once(builder, args) -> None:
    """Every constant the fused graph keeps on the device is one tensor per
    builder and arguments, equal bit for bit to the builder's array."""

    const = device_constant(builder, *args, device="cpu")
    assert device_constant(builder, *args, device="cpu") is const
    want = builder(*args)
    assert const.dtype == torch.from_numpy(want).dtype and np.array_equal(const.numpy(), want)


def test_k_weighting_spectrum_is_the_rfft_of_the_fir() -> None:
    got = loudness._k_weighting_spectrum(SR, 65_536)
    want = np.fft.rfft(loudness.k_weighting_fir(SR), n=65_536).astype(np.complex64)
    assert got.dtype == np.complex64 and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# Launch counts held during a capture.
# ---------------------------------------------------------------------------


def _counter():
    def fn():
        pass

    fn.launches = 0
    fn.launches_time = 0
    return fn


def test_held_launches_are_added_only_when_replayed() -> None:
    fn = _counter()
    cuda_build.count_launch(fn, "launches", "launches_time")
    with cuda_build.held_launches() as held:
        cuda_build.count_launch(fn, "launches", "launches_time")
        cuda_build.count_launch(fn, "launches")
    assert (fn.launches, fn.launches_time) == (1, 1)
    assert held == [(fn, ("launches", "launches_time")), (fn, ("launches",))]
    for _ in range(3):
        cuda_build.add_launches(held)
    assert (fn.launches, fn.launches_time) == (7, 4)
    cuda_build.count_launch(fn, "launches")  # held no more
    assert fn.launches == 8


def test_held_launches_hold_only_this_threads() -> None:
    fn = _counter()
    done = threading.Event()

    def other():
        cuda_build.count_launch(fn, "launches")
        done.set()

    with cuda_build.held_launches() as held:
        thread = threading.Thread(target=other)
        thread.start()
        thread.join(timeout=30)
    assert done.is_set() and fn.launches == 1 and held == []


# ---------------------------------------------------------------------------
# The graph key and the cache of captured graphs.
# ---------------------------------------------------------------------------


def _key(transport="ms", seconds=2.0, lanes=1, sr=SR):
    staged = _staged(transport, [_audio(seconds, seed=k) for k in range(lanes)], "cpu")
    return batch._graph_key(transport, staged[0], staged[1], sr=sr)


def test_graph_key_separates_what_a_capture_depends_on(monkeypatch) -> None:
    base = _key()
    assert _key() == base  # the same payload shape: one graph
    assert hash(base) == hash(_key())
    others = {
        "transport": _key(transport="ms6"),
        "bucket": _key(seconds=4.0),
        "device_batch": _key(lanes=2),
        "sr": _key(sr=22_050),
    }
    sentinel = torch.nn.Identity()
    monkeypatch.setattr(batch, "_bundled_net", lambda dev: sentinel)
    others["net"] = _key()
    monkeypatch.setattr(batch, "_bundled_net", lambda dev: None)
    others["no net"] = _key()
    monkeypatch.setenv("TA_PALLAS_STFT", "1")
    others["fused stft, no net"] = _key()
    keys = [base, *others.values()]
    assert len(set(keys)) == len(keys), others


@pytest.mark.parametrize("transport", ["float32", "int16", "int8", "ms", "ms6", "ms5"])
def test_graph_key_is_the_same_for_every_chunk_of_a_bucket(transport) -> None:
    assert _key(transport, seconds=2.0) == _key(transport, seconds=2.01)


def test_device_graphs_evict_the_least_recently_used() -> None:
    card = batch._DeviceGraphs(limit=2)
    a, b, c = object(), object(), object()
    card.put("a", a)
    card.put("b", b)
    assert list(card.entries) == ["a", "b"]
    assert card.get("a") is a  # now the most recently used
    card.put("c", c)
    assert card.get("b") is None and card.get("a") is a and card.get("c") is c
    assert list(card.entries) == ["a", "c"]


def test_device_graphs_are_one_cache_per_card() -> None:
    assert batch._device_graphs(torch.device("cuda", 0)) is batch._device_graphs(torch.device("cuda", 0))
    assert batch._device_graphs(torch.device("cuda", 0)) is not batch._device_graphs(torch.device("cuda", 1))
    assert batch._device_graphs(torch.device("cuda", 0)).limit == batch._GRAPHS_PER_DEVICE


@pytest.mark.parametrize("transport", ["ms", "int16", "float32"])
def test_cpu_dispatch_stays_eager(transport) -> None:
    """On the CPU ``_dispatch`` runs ``_core_graph`` as it is, returns no
    events, captures nothing and records no graph span."""

    audios = [_audio(2.0, seed=3), _audio(2.0, seed=4)]
    staged = _staged(transport, audios, "cpu")
    with torch.inference_mode():
        want = batch._core_graph(batch._decode_payload(transport, staged[0]), staged[1], sr=SR)
    before = {k: v for k, v in profiling.stage_seconds().items() if k.startswith("graph")}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset_spans()
        outs, events = batch._dispatch(transport, staged, sr=SR)
        names = {r.name for r in profiling.spans()}
    assert events is None
    assert len(outs) == len(want) and all(torch.equal(o, w) for o, w in zip(outs, want))
    assert not names & {"graph_capture", "graph_replay"}
    assert {k: v for k, v in profiling.stage_seconds().items() if k.startswith("graph")} == before
    assert "cpu" not in batch._graphs


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the median kernel have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", ["sweep", "cd"])
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("transport", ["ms", "ms6", "int16", "float32"])
def test_a_replay_is_bit_identical_to_the_eager_graph(card, monkeypatch, transport, lanes, bucket) -> None:
    """Capture on one chunk, replay on another, and hold the replay's
    outputs to the eager graph's on the same chunk, bit for bit."""

    seconds = SECONDS[bucket]
    first = _staged(transport, [_audio(seconds, seed=10 + k) for k in range(lanes)], card)
    second = [_audio(seconds - 0.5 * k, seed=20 + k) for k in range(lanes)]
    _run(transport, first)  # captures, unless an earlier test did
    replayed = _run(transport, _staged(transport, second, card))
    monkeypatch.setenv(DEBUG_NANS, "1")
    eager = _run(transport, _staged(transport, second, card))
    assert len(replayed) == len(eager)
    for k, (r, e) in enumerate(zip(replayed, eager)):
        assert r.dtype == e.dtype and r.shape == e.shape, k
        assert np.array_equal(r, e, equal_nan=True), f"output {k} differs"


@pytest.mark.gpu
def test_a_second_call_replays_and_counts_its_medians(card) -> None:
    audio = _audio(12.0, seed=5)
    staged = lambda: _staged("ms", [audio], card)  # noqa: E731
    before = (median31.launches, median31.launches_time, median31.launches_freq)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset_spans()
        with profiling.span("dispatch"):
            first = _run("ms", staged())
        names = [r.name for r in profiling.spans()]
        after_first = (median31.launches, median31.launches_time, median31.launches_freq)
        profiling.reset_spans()
        for _ in range(3):
            with profiling.span("dispatch"):
                again = _run("ms", staged())
            assert all(np.array_equal(a, b) for a, b in zip(first, again))
        later = [r for r in profiling.spans()]
    # The first call captured (and ran eagerly once), unless an earlier
    # call in the process had captured this key already.
    assert names.count("graph_capture") + names.count("graph_replay") == 1
    assert [after_first[i] - before[i] for i in range(3)] == [2, 1, 1]
    assert [r.name for r in later].count("graph_capture") == 0
    assert [r.name for r in later].count("graph_replay") == 3
    dispatch_ids = {r.span_id for r in later if r.name == "dispatch"}
    assert all(r.parent_id in dispatch_ids for r in later if r.name == "graph_replay")
    assert (median31.launches, median31.launches_time, median31.launches_freq) == tuple(
        a + 6 * (i == 0) + 3 * (i > 0) for i, a in enumerate(after_first)
    )


@pytest.mark.gpu
def test_a_replays_kernels_are_in_the_profilers_trace(card) -> None:
    """The benchmark reads the median kernels' device time from a
    ``torch.profiler`` trace: a replayed graph's kernels must be in it."""

    audio = _audio(12.0, seed=6)
    _run("ms", _staged("ms", [audio], card))
    staged = _staged("ms", [audio], card)
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        _run("ms", staged)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("median31_kernel" in n for n in names) == 2, sorted(set(names))[:20]


@pytest.mark.gpu
def test_two_workers_on_one_card_give_the_eager_results(card, monkeypatch) -> None:
    audios = [_audio(30.0 - k, seed=40 + k) for k in range(6)]
    for lanes in (1, 2):
        replayed = batch.analyse_library(audios, mesh=["cuda:0", "cuda:0"], device_batch=lanes)
        with monkeypatch.context() as m:
            m.setenv(DEBUG_NANS, "1")
            eager = batch.analyse_library(audios, mesh=["cuda:0", "cuda:0"], device_batch=lanes)
        assert all(isinstance(r, batch.TrackAnalysisResult) for r in replayed)
        for k, (r, e) in enumerate(zip(replayed, eager)):
            assert _same(r, e), (lanes, k)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.gpu
def test_captures_on_two_cards_at_once(two_cards, monkeypatch) -> None:
    """Two threads capture new keys on two cards at the same moment, as the
    dispatch workers of a mesh do at their first chunks; each capture
    succeeds, and each card's replay equals its eager graph bit for bit."""

    batch.clear_graphs()
    for round_, seconds in enumerate((9.0, 11.0, 13.0)):
        staged = {d: _staged("ms", [_audio(seconds, seed=70 + round_)], d) for d in two_cards}
        barrier = threading.Barrier(len(two_cards))
        failed: list = []

        def capture(dev):
            try:
                barrier.wait()
                with torch.cuda.device(dev):
                    _run("ms", staged[dev])
            except BaseException as exc:  # noqa: BLE001 (reported below)
                failed.append((dev, exc))

        threads = [threading.Thread(target=capture, args=(d,)) for d in two_cards]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads) and not failed, failed
        for dev in two_cards:
            assert len(batch._device_graphs(dev).entries) == round_ + 1
    for dev in two_cards:
        audio = [_audio(13.0, seed=80)]
        with torch.cuda.device(dev):
            replayed = _run("ms", _staged("ms", audio, dev))
            with monkeypatch.context() as m:
                m.setenv(DEBUG_NANS, "1")
                eager = _run("ms", _staged("ms", audio, dev))
        assert all(np.array_equal(r, e, equal_nan=True) for r, e in zip(replayed, eager)), dev


@pytest.mark.gpu
def test_a_sweep_over_two_cards_gives_the_eager_results(two_cards, monkeypatch) -> None:
    """A mesh of two cards captures on both at its first chunks, finishes
    on one thread, and gives the eager results."""

    batch.clear_graphs()
    audios = [_audio(30.0 - k, seed=90 + k) for k in range(6)]
    mesh = [str(d) for d in two_cards]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset_spans()
        replayed = batch.analyse_library(audios, mesh=mesh)
        records = profiling.spans()
    with monkeypatch.context() as m:
        m.setenv(DEBUG_NANS, "1")
        eager = batch.analyse_library(audios, mesh=mesh)
    captured = [len(batch._device_graphs(d).entries) for d in two_cards]
    assert all(captured) and [r.name for r in records].count("graph_capture") == sum(captured)
    assert len({r.thread for r in records if r.name == "finish"}) == 1
    assert all(isinstance(r, batch.TrackAnalysisResult) for r in replayed)
    for k, (r, e) in enumerate(zip(replayed, eager)):
        assert _same(r, e), k


@pytest.mark.gpu
def test_the_fused_stft_kernel_is_captured_and_counted(card, monkeypatch) -> None:
    """With ``TA_PALLAS_STFT=1`` the hand-written STFT kernel runs inside the
    captured graph: a replay equals the eager graph bit for bit and adds
    one launch of it."""

    from track_analyser_tpu_torch.ops import fused_stft

    monkeypatch.setenv("TA_PALLAS_STFT", "1")
    audio = _audio(12.0, seed=7)
    _run("ms", _staged("ms", [audio], card))  # captures the key with the kernel
    before = fused_stft.stft_magnitude.launches
    replayed = _run("ms", _staged("ms", [_audio(12.0, seed=8)], card))
    assert fused_stft.stft_magnitude.launches == before + 1
    monkeypatch.setenv(DEBUG_NANS, "1")
    eager = _run("ms", _staged("ms", [_audio(12.0, seed=8)], card))
    assert all(np.array_equal(r, e, equal_nan=True) for r, e in zip(replayed, eager))


def test_the_sweep_finishes_on_one_thread() -> None:
    """Every chunk of a sweep, from every worker, is finished by one thread:
    the finishers run under the GIL, and several at once slow each other."""

    audios = [_audio(2.0 + 0.25 * k, seed=60 + k) for k in range(4)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset_spans()
        results = batch.analyse_library(audios, mesh=["cpu", "cpu"], device_batch=1)
        finishes = [r for r in profiling.spans() if r.name == "finish"]
    assert all(isinstance(r, batch.TrackAnalysisResult) for r in results)
    assert len(finishes) == 4 and len({r.thread for r in finishes}) == 1
