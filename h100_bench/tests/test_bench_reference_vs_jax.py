"""The plain reference against the JAX package, the system's
specification, on the CPU: for the same files, every compared field of
the JAX package's ``analyse_track`` lies within the configurations'
limits of the reference's answer. Skips where JAX is not installed (the
card's machine has none)."""

import json
import shutil
import tempfile
from pathlib import Path

import pytest

from h100_bench import correct
from h100_bench.gen import corpus
from h100_bench.reference import analyse

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def jax_analyse():
    pytest.importorskip("jax")
    from track_analyser_tpu.pipeline import analyse_track

    return analyse_track


@pytest.mark.parametrize("config, recipes", [("cd44k_stereo", ("club", "sparse_minor")),
                                             ("gtzan22k_mono", ("engine", "club"))])
def test_reference_follows_the_jax_package(jax_analyse, config, recipes):
    conf = json.loads((REPO / "h100_bench" / "configs" / f"{config}.json").read_text())
    conf["corpus"]["tracks"] = [{"recipe": r, "seconds": 12, "count": 1} for r in recipes]
    work = Path(tempfile.mkdtemp(prefix="h100_bench_spec_"))
    try:
        numbers = correct.Numbers()
        for t in corpus.build(conf, 2**31 + 5, work, workers=1):
            numbers.add(jax_analyse(t.path), analyse(t.path, device="cpu"), Path(t.path).name)
        ok, table = numbers.verdict(conf["limits"])
        assert ok and numbers.compared == 2, table
    finally:
        shutil.rmtree(work, ignore_errors=True)
