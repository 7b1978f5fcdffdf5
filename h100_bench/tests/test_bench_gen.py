"""The copied generators: deterministic per seed, the same signals as the
originals they copy, and fast enough for a run's set-up."""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from h100_bench.gen import corpus, engine, recipes

REPO = Path(__file__).resolve().parents[2]
CONFIGS = REPO / "h100_bench" / "configs"


def _bench_py_recipes() -> dict:
    """``bench.py``'s two recipes, run from its source with the JAX
    package's AudioInput replaced by a dict (nothing of it is imported)."""

    src = (REPO / "bench.py").read_text().split("def _retry")[0]
    src = src.replace("from track_analyser_tpu.utils import AudioInput", "AudioInput = lambda **kw: kw")
    ns = {"__file__": str(REPO / "bench.py")}
    exec(compile(src, "bench.py", "exec"), ns)
    return ns


def test_recipes_equal_bench_py():
    ns = _bench_py_recipes()
    # the same signals to float32 rounding (the copies build their sinusoids by block rotation)
    a = ns["_make_track"](9.0, bpm=126.0, seed=7)["stereo_samples"]
    np.testing.assert_allclose(recipes.club(9.0, 44_100, 126.0, 0, np.random.default_rng(7)), a, rtol=0, atol=1e-6)
    a = ns["_make_sparse_minor"](17.0, bpm=96.0)["stereo_samples"]
    np.testing.assert_allclose(recipes.sparse_minor(17.0, 44_100, 96.0, 0, None), a, rtol=0, atol=1e-6)


def test_engine_filters_equal_the_per_sample_loops():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import independent_engine as ie
    finally:
        sys.path.pop(0)
    x = np.random.default_rng(0).normal(size=3000)
    sr = 22_050
    np.testing.assert_allclose(engine.schroeder_reverb(x, sr, 0.1), ie.schroeder_reverb(x, sr, 0.1), atol=1e-12)
    coeffs = ie._rbj_bandpass(1800.0, 0.7, sr)
    np.testing.assert_allclose(engine.biquad(x, *coeffs), ie.biquad(x, *coeffs), atol=1e-12)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_allclose(engine.resonant_drum("snare", 4000, sr, rng_a),
                               ie.resonant_drum("snare", 4000, sr, rng_b), atol=1e-12)


@pytest.mark.parametrize("config", ["cd44k_stereo", "gtzan22k_mono"])
def test_plan_is_a_function_of_the_seed(config):
    spec = json.loads((CONFIGS / f"{config}.json").read_text())["corpus"]
    big = 2**31 + 12_345
    assert corpus.plan(spec, big) == corpus.plan(spec, big)
    assert corpus.plan(spec, big) != corpus.plan(spec, big + 1)
    # every seed asks for the same audio: durations, recipes and tempi as multisets
    a, b = corpus.plan(spec, 1), corpus.plan(spec, 2)
    for key in ("recipe", "seconds", "bpm"):
        assert sorted(getattr(p, key) for p in a) == sorted(getattr(p, key) for p in b)


def test_render_is_deterministic(tmp_path):
    p = corpus._Plan("engine", 4.0, 0.0, 0, 99)
    np.testing.assert_array_equal(corpus.render(p, 22_050, 1), corpus.render(p, 22_050, 1))
    q = corpus._Plan("club", 4.0, 120.0, 3, 5)
    np.testing.assert_array_equal(corpus.render(q, 44_100, 2), corpus.render(q, 44_100, 2))


def test_wav_round_trip(tmp_path):
    from h100_bench.reference.audio import read_wav

    x = recipes.club(2.0, 44_100, 120.0, 0, np.random.default_rng(1))
    corpus.write_wav(tmp_path / "a.wav", x, 44_100)
    data, sr = read_wav(tmp_path / "a.wav")
    assert sr == 44_100 and data.shape == x.shape
    assert np.max(np.abs(data - x)) <= 0.5 / 32768 + 1e-9


def test_synthesis_fits_the_set_up(tmp_path):
    """The costliest file of each kind, timed here: the whole corpus on
    four threads must stay within ~10 s of set-up (this sandbox's cores are
    slower than the card's host)."""

    t0 = time.perf_counter()
    corpus.render(corpus._Plan("club", 181.0, 132.0, 0, 1), 44_100, 2)
    club_181 = time.perf_counter() - t0
    t0 = time.perf_counter()
    corpus.render(corpus._Plan("engine", 30.0, 0.0, 0, 1), 22_050, 1)
    song_30 = time.perf_counter() - t0
    cd = club_181 * 16 / 4  # 16 tracks of at most 181 s on four threads
    gtzan = song_30 * 64 / 4
    assert cd < 20.0 and gtzan < 20.0, (cd, gtzan)
