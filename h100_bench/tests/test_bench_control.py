"""On the card: the precision control (the plain reference in TF32, the
precision below the configurations' float32 with TF32 off) put in the
program's place is not correct, and the program is, at a size a test
run holds. The benchmark's own runs never run the control;
``python -m h100_bench.calibrate`` reads it at the cells' own sizes."""

import json
import shutil
import tempfile
from pathlib import Path

import pytest

from h100_bench.drive import Driver
from h100_bench.gen import corpus
from h100_bench.harness import _reference, bucket_of, compare

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["cd44k_stereo", "gtzan22k_mono"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_and_the_program_passes(cuda, config, seed):
    conf = json.loads((REPO / "h100_bench" / "configs" / f"{config}.json").read_text())
    conf["corpus"]["tracks"] = [dict(t, seconds=min(t["seconds"], 30), count=1) for t in conf["corpus"]["tracks"]]
    work = Path(tempfile.mkdtemp(prefix="h100_bench_control_"))
    try:
        tracks = corpus.build(conf, seed, work)
        driver = Driver({"kind": "single"}, conf, tracks, seed, cuda, work)
        served = [driver._single(t.index) for t in tracks]
        refs = _reference(tracks, range(len(tracks)), cuda, tf32=False)
        ok, _ = compare(served, refs, tracks).verdict(conf["limits"])
        assert ok
        control = _reference(tracks, range(len(tracks)), cuda, tf32=True)
        ok, table = compare(served, refs, tracks, answers=control).verdict(conf["limits"])
        assert not ok, table
    finally:
        shutil.rmtree(work, ignore_errors=True)
