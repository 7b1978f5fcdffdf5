"""The reader of the program's ``decode.wav`` spans
(``wav_decode_pct.single``), on the single-path stretch recorded on the
H100 (``data/graph_spans_fixture.json``, made before the program had the
span) with a ``decode.wav`` span added inside chosen ``decode`` spans."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from h100_bench import spans as span_reading
from h100_bench.tests.test_bench_span_readers import _ctx, reader

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def part():
    return json.loads((DATA / "graph_spans_fixture.json").read_text())["single"]


def _with_passes(part, n):
    """The stretch's spans with a "decode.wav" child in the first ``n``
    "decode" spans."""

    records = [SimpleNamespace(**r) for r in part["spans"]]
    decodes = [r for r in records if r.name == "decode"]
    passes = [
        SimpleNamespace(**{**vars(d), "name": "decode.wav", "span_id": -1 - i, "parent_id": d.span_id})
        for i, d in enumerate(decodes[:n])
    ]
    return records + passes, len(decodes)


def test_every_decode_holding_a_pass_reads_100(monkeypatch, part):
    records, n = _with_passes(part, 10**6)
    assert n >= 1
    assert reader("wav_decode_pct.single")(_ctx(monkeypatch, part, records)) == 100.0


def test_the_share_counts_decodes_that_hold_a_pass(monkeypatch, part):
    records, n = _with_passes(part, 0)
    extra = next(r for r in records if r.name == "decode")
    more = SimpleNamespace(**{**vars(extra), "span_id": -99})
    held = SimpleNamespace(**{**vars(extra), "name": "decode.wav", "span_id": -100, "parent_id": extra.span_id})
    value = reader("wav_decode_pct.single")(_ctx(monkeypatch, part, records + [more, held]))
    assert value == pytest.approx(100.0 / (n + 1))


def test_a_pass_outside_a_decode_is_not_counted(monkeypatch, part):
    """A "decode.wav" inside "stems.load" holds no "decode": the share
    counts decodes, so it cannot pass 100."""

    records, n = _with_passes(part, 10**6)
    stray = next(r for r in records if r.name == "decode.wav")
    loose = SimpleNamespace(**{**vars(stray), "span_id": -200, "parent_id": None})
    assert reader("wav_decode_pct.single")(_ctx(monkeypatch, part, records + [loose])) == 100.0


def test_a_program_without_the_pass_reads_nothing(monkeypatch, part):
    ctx = _ctx(monkeypatch, part)
    assert reader("wav_decode_pct.single")(ctx) is None
    monkeypatch.setattr(span_reading, "recorded", lambda: None)
    assert reader("wav_decode_pct.single")(ctx) is None
