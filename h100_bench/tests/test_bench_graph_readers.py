"""The readers of the program's ``graph_replay`` spans
(``graph_replay_pct.single``, ``graph_replay_pct.sweep``), on traced
stretches recorded on the H100 with a program that replays captured CUDA
graphs (``data/graph_spans_fixture.json``: one ``analyse_track`` call of a
30 s stereo track and one ``analyse_library`` call of two 10 s mono clips,
each after a warm-up call), and on ``data/spans_fixture.json``, recorded
before the program captured graphs."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from h100_bench import spans as span_reading
from h100_bench.tests.test_bench_span_readers import _ctx, reader

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def recorded():
    return json.loads((DATA / "graph_spans_fixture.json").read_text())


@pytest.mark.parametrize("kind", ["single", "sweep"])
def test_every_dispatch_of_a_warm_program_replays(monkeypatch, recorded, kind):
    part = recorded[kind]
    names = [r["name"] for r in part["spans"]]
    assert names.count("dispatch") == part["served"] and "graph_capture" not in names
    assert reader(f"graph_replay_pct.{kind}")(_ctx(monkeypatch, part)) == 100.0


@pytest.mark.parametrize("kind", ["single", "sweep"])
def test_the_share_counts_replays_over_dispatches(monkeypatch, recorded, kind):
    part = recorded[kind]
    records = [SimpleNamespace(**r) for r in part["spans"]]
    dispatches = [r for r in records if r.name == "dispatch"]
    # One more dispatch, eager (no replay inside), in the stretch.
    extra = SimpleNamespace(**{**vars(dispatches[0]), "span_id": -1})
    value = reader(f"graph_replay_pct.{kind}")(_ctx(monkeypatch, part, records + [extra]))
    assert value == pytest.approx(100.0 * len(dispatches) / (len(dispatches) + 1))


@pytest.mark.parametrize("kind", ["single", "sweep"])
def test_spans_outside_the_stretch_are_not_read(monkeypatch, recorded, kind):
    part = recorded[kind]
    late = part["trace"]["end_us"] * 1e3 + 1e6
    outside = [SimpleNamespace(**{**r, "start_ns": late, "end_ns": late + 1e3}) for r in part["spans"]]
    assert reader(f"graph_replay_pct.{kind}")(_ctx(monkeypatch, part, outside)) is None


@pytest.mark.parametrize("kind", ["single", "sweep"])
def test_a_program_that_replays_nothing_reads_nothing(monkeypatch, kind):
    """The parent of the captured graphs records dispatch spans and no
    ``graph_replay`` span; a program without spans records none: both read
    None, and neither raises."""

    part = json.loads((DATA / "spans_fixture.json").read_text())[kind]
    ctx = _ctx(monkeypatch, part)
    assert reader(f"graph_replay_pct.{kind}")(ctx) is None
    monkeypatch.setattr(span_reading, "recorded", lambda: None)
    assert reader(f"graph_replay_pct.{kind}")(ctx) is None
