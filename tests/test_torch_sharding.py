"""The port's sequence-sharded analysis (``parallel/sharded.py``) on gloo
ranks on the CPU.

One spawn of four ranks serves the whole module: the ranks run every
sharded entry point over the world of four and, split into two groups of
two, over a world of two (both pairs compute the same thing, which also
shows that the groups agree). The results are held

* against the JAX package's sharded path at ``make_mesh((2,), ("seq",))``
  (``sharded_track_outputs`` key by key, with the per-key tolerances of
  ``tests/test_torch_substrate.py``, and ``sharded_onset_envelope``);
* against the port's fused path at world 2 and 4, with the fields and
  tolerances of ``tests/test_sharding.py``;
* the true peak of a smooth plateau that crosses each internal shard
  boundary against the whole track's, rel 1e-5;
* ``oversampled_peak(mask=)`` against the JAX function's.

The 30 s 22.05 kHz fixture has a noise floor, drums that mute over 12-18
s (decisive section boundaries) and a fade-out (the analysis tail in the
padding then depends on no bucket length), as ``tests/test_sharding.py``'s
60 s fixture. World 4 would take 12.6 s (each shard needs the 136-frame
halo), but the downbeat TCN's receptive field reaches 254 frames (5.9 s)
into the padded tail, whose length differs between the sharded and the
fused paths; on a 16 s track that moves the downbeat decision (in the JAX
package as well: its own sharded path at world 2 decodes other downbeats
than its fused path there), on 30 s it does not. The plateau fixture is 16
s. Every spawn has a time limit: a hung rank fails the test instead of
hanging the run.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from track_analyser_tpu_torch.parallel import mesh, sharded
from track_analyser_tpu_torch.utils import AudioInput

torch.set_num_threads(2)

SR = 22_050
SECONDS = 30
PLATEAU_SECONDS = 16
HOP = 512
TCN_REACH = 2 * sum(d * (5 - 1) // 2 for d in (1, 2, 4, 8, 16, 32, 64))  # 254 frames
TIMEOUT_S = 300.0
WORLDS = (2, 4)

# key -> tolerance as a fraction of the key's largest |value|: those of
# tests/test_torch_substrate.py; the net's probability (seven float32
# dilated convs, then a softmax) at the 1e-5 of tests/test_torch_downbeat_net.py
_TOLERANCES = {
    "onset_env": 5e-6,
    "net_prob": 1e-5,
    "beat_energy": 2e-6,
    "low_energy": 2e-6,
    "novelty": 2e-4,
    "energy_novelty": 1e-3,
    "perc_col": 2e-6,
    "harm_col": 2e-6,
    "ltas": 2e-6,
    "centroid": 2e-6,
    "rolloff": 0.0,
    "chroma_cq": 5e-6,
    "key_scores": 2e-6,
    "balance_total": 2e-6,
    "balance_low": 2e-6,
    "balance_mid": 2e-6,
    "balance_high": 2e-6,
    "integrated_lufs": 1e-6,
    "true_peak": 1e-6,
    "rms": 1e-6,
    "stereo_corr_centered": 5e-5,
    "stereo_balance": 5e-6,
    "mid_rms": 1e-6,
    "side_rms": 1e-6,
    "stereo_widths": 2e-6,
    "f_valid": 0.0,
}


def _track() -> np.ndarray:
    """(2, n) stereo: 220 Hz tone, clicks every 0.5 s muted over 12-18 s, a
    noise floor and a 3 s fade-out; the right channel at half level."""

    n = SR * SECONDS
    rng = np.random.default_rng(0)
    y = rng.normal(0, 0.01, n).astype(np.float32)
    y += 0.2 * np.sin(2 * np.pi * 220.0 * np.arange(n) / SR).astype(np.float32)
    for b in np.arange(0.0, SECONDS - 3.0, 0.5):
        if 12.0 <= b < 18.0:
            continue
        s = int(b * SR)
        e = min(n, s + 220)
        y[s:e] += np.exp(-np.linspace(0, 6, e - s)).astype(np.float32)
    fade = np.ones(n, dtype=np.float32)
    fade[-3 * SR :] = np.linspace(1.0, 0.0, 3 * SR, dtype=np.float32)
    y *= fade
    return np.stack([y, 0.5 * y])


def _plateau_track(world: int) -> np.ndarray:
    """A quiet tone with a smooth 0.9 plateau centred on each internal
    shard boundary of a ``world``-rank split (the boundaries of
    ``sharded_track_outputs``: frames per shard rounded up to 4)."""

    n = SR * PLATEAU_SECONDS
    y = (0.02 * np.sin(2 * np.pi * 220.0 * np.arange(n) / SR)).astype(np.float32)
    ramp = 2000
    env = np.concatenate(
        [
            0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp),
            np.ones(2000),
            0.5 + 0.5 * np.cos(np.pi * np.arange(ramp) / ramp),
        ]
    )
    fs = sharded.frames_per_shard(n, world, HOP)
    for k in range(1, world):
        pos = k * fs * HOP
        y[pos - len(env) // 2 : pos - len(env) // 2 + len(env)] = (0.9 * env).astype(np.float32)
    return y


def _audio(stereo: np.ndarray) -> AudioInput:
    return AudioInput(samples=stereo.mean(axis=0), sample_rate=SR, stereo_samples=stereo)


def _ranks(group: "mesh.SeqGroup") -> dict:
    """Everything one rank computes, at world 4 and in its pair (world 2)."""

    from track_analyser_tpu_torch.ops import filters

    pair = mesh.split_groups(group, [[0, 1], [2, 3]])
    stereo = _track()
    hpss, hpss_shapes = filters.hpss, []

    def recording_hpss(mag, **kwargs):
        hpss_shapes.append(tuple(mag.shape))
        return hpss(mag, **kwargs)

    filters.hpss = recording_hpss  # this rank's process only
    out = {}
    for world, g in ((4, group), (2, pair)):
        plateau = _plateau_track(world)
        hpss_shapes.clear()
        out[world] = {
            "outputs": sharded.sharded_track_outputs(stereo, stereo.shape[-1], SR, g),
            "hpss_shape": hpss_shapes[0],
            "result": sharded.analyse_track_sharded(_audio(stereo), g),
            "envelope": sharded.sharded_onset_envelope(stereo.mean(axis=0), SR, g),
            "plateau_peak": float(sharded.sharded_track_outputs(np.stack([plateau, plateau]), plateau.size, SR, g)["true_peak"]),
            "halo": sharded.shard_halo_exchange(torch.arange(5.0) + 10 * g.rank, 2, g).numpy(),
        }
    return out


def _jax_sharded() -> tuple:
    """JAX's sharded outputs and envelope on a two-device seq mesh."""

    from track_analyser_tpu.parallel.mesh import make_mesh
    from track_analyser_tpu.parallel.sharded import sharded_onset_envelope, sharded_track_outputs

    stereo = _track()
    m = make_mesh((2,), ("seq",))
    out = sharded_track_outputs(stereo, stereo.shape[-1], SR, m)
    return {k: np.asarray(v) for k, v in out.items()}, sharded_onset_envelope(stereo.mean(axis=0), SR, m)


def _fused() -> tuple:
    """The port's fused path on the same track: the graph (and the TCN's
    probability) on the sharded path's padded length at each world, and
    the result of ``analyse_track_fused``."""

    from track_analyser_tpu_torch.models import downbeat_net
    from track_analyser_tpu_torch.parallel.batch import _bundled_net, analyse_track_fused
    from track_analyser_tpu_torch.substrate import full_track_graph

    stereo = _track()
    n = stereo.shape[-1]
    graphs = {}
    for world in WORLDS:
        padded = sharded.frames_per_shard(n, world, HOP) * world * HOP
        buf = np.zeros((1, 2, padded), dtype=np.float32)
        buf[0, :, :n] = stereo
        stereo_t, n_valid = torch.from_numpy(buf), torch.tensor([n])
        with torch.inference_mode():
            out = full_track_graph(stereo_t, n_valid, sr=SR)
            out["net_prob"] = downbeat_net.activation_graph(
                _bundled_net(torch.device("cpu")), stereo_t.mean(dim=1), n_valid, sr=SR
            )
        graphs[world] = {k: v[0].numpy() for k, v in out.items()}
    return graphs, analyse_track_fused(_audio(stereo), transport="float32", device="cpu")


def _failing_run() -> "BaseException | None":
    """What ``run_sharded`` raises on a track too short for two shards."""

    short = np.zeros((2, 4 * SR), dtype=np.float32)
    try:
        sharded.run_sharded(_audio(short), 2, device="cpu", timeout_s=TIMEOUT_S)
    except Exception as exc:  # the test inspects it
        return exc
    return None


HANG_TIMEOUT_S = 12.0


def _hang(group: "mesh.SeqGroup") -> None:
    time.sleep(3600)  # a rank that never returns


def _hung_run() -> tuple:
    """(what ``mesh.spawn`` raised on a hung rank, seconds it took)."""

    t0 = time.monotonic()
    try:
        mesh.spawn(_hang, 1, device="cpu", timeout_s=HANG_TIMEOUT_S)
    except Exception as exc:  # the test inspects it
        return exc, time.monotonic() - t0
    return None, time.monotonic() - t0


@pytest.fixture(scope="module")
def computed():
    """(the ranks' results, JAX's sharded path, the port's fused path, what
    a failing run and a hung run raised): the references are computed here
    while the ranks run."""

    with ThreadPoolExecutor(max_workers=3) as pool:
        job = pool.submit(mesh.spawn, _ranks, 4, device="cpu", timeout_s=TIMEOUT_S)
        failing = pool.submit(_failing_run)
        hung = pool.submit(_hung_run)
        jax_ref, fused_ref = _jax_sharded(), _fused()
        return job.result(), jax_ref, fused_ref, failing.result(), hung.result()


@pytest.fixture(scope="module")
def ranks(computed):
    return computed[0]


@pytest.fixture(scope="module")
def jax_sharded(computed):
    return computed[1]


@pytest.fixture(scope="module")
def fused(computed):
    return computed[2]


# ---- oversampled_peak(mask=) ------------------------------------------------

_MASKS = {
    "own_range": lambda n: (np.arange(n) >= n // 3) & (np.arange(n) < 2 * n // 3),
    "alternating": lambda n: (np.arange(n) // 97) % 2 == 0,
    "all": lambda n: np.ones(n, dtype=bool),
    "none_set": lambda n: np.zeros(n, dtype=bool),
}


@pytest.mark.parametrize("case", sorted(_MASKS))
def test_oversampled_peak_mask_matches_jax(case) -> None:
    import jax.numpy as jnp

    from track_analyser_tpu.ops.resample import oversampled_peak as jax_peak
    from track_analyser_tpu_torch.ops.resample import oversampled_peak

    y = _plateau_track(2)[: 3 * SR]
    mask = _MASKS[case](y.size)
    got = float(oversampled_peak(torch.from_numpy(y), 8, mask=torch.from_numpy(mask)))
    want = float(jax_peak(jnp.asarray(y), 8, mask=jnp.asarray(mask)))
    assert got == pytest.approx(want, abs=1e-6)


def test_oversampled_peak_without_mask_is_unchanged() -> None:
    """No mask and an all-true mask give the same peak, bit for bit."""

    from track_analyser_tpu_torch.ops.resample import oversampled_peak

    y = torch.from_numpy(_track()[:, : 3 * SR])
    plain = oversampled_peak(y, 8)
    assert plain.shape == (2,)
    for lane in range(2):
        full = oversampled_peak(y[lane], 8, mask=torch.ones(y.shape[-1], dtype=torch.bool))
        assert torch.equal(plain[lane], full)


# ---- against JAX's sharded path ----------------------------------------------

def test_output_keys_match_jax(ranks, jax_sharded) -> None:
    """Every JAX output but the device autocorrelation, which the port's
    host recomputes in float64 from onset_env (as for the fused graph)."""

    assert sorted(ranks[0][2]["outputs"]) == sorted(set(jax_sharded[0]) - {"autocorr"})
    assert sorted(_TOLERANCES) == sorted(ranks[0][2]["outputs"])


@pytest.mark.parametrize("key", sorted(_TOLERANCES))
def test_sharded_outputs_match_jax(key, ranks, jax_sharded) -> None:
    got = np.asarray(ranks[0][2]["outputs"][key], dtype=np.float64)
    ref = np.asarray(jax_sharded[0][key], dtype=np.float64)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_TOLERANCES[key] * scale, err_msg=key)


def test_sharded_onset_envelope_matches_jax(ranks, jax_sharded) -> None:
    ref = jax_sharded[1]
    got = ranks[0][2]["envelope"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6 * np.abs(ref).max())


def test_every_rank_returns_the_same_outputs(ranks) -> None:
    for world in WORLDS:
        first = ranks[0][world]["outputs"]
        for r in ranks[1:]:
            for key, value in r[world]["outputs"].items():
                assert np.array_equal(value, first[key]), (world, key)
            assert r[world]["result"].beat.bpm == ranks[0][world]["result"].beat.bpm


@pytest.mark.parametrize("world", WORLDS)
def test_shard_halo_exchange(world, ranks) -> None:
    """Each shard gets its right neighbour's first elements; the last
    shard gets zeros."""

    for r in ranks:
        got = r[world]["halo"]
        k = int(got[0] // 10)  # the rank's place in its world-sized group
        tail = [0.0, 0.0] if k == world - 1 else [10.0 * (k + 1), 10.0 * (k + 1) + 1]
        assert got.tolist() == [10.0 * k + i for i in range(5)] + tail


# ---- against the port's fused path ---------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_onset_envelope_matches_the_port(world, ranks) -> None:
    from track_analyser_tpu_torch.tempo import onset_envelope

    ref = onset_envelope(_track().mean(axis=0), SR, device="cpu")
    got = ranks[0][world]["envelope"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_curves_match_fused(world, ranks, fused) -> None:
    out = ranks[0][world]["outputs"]
    ref = fused[0][world]
    f_valid = 1 + SR * SECONDS // HOP
    for key, tol in [
        ("onset_env", 1e-3),
        ("novelty", 2e-3),
        ("perc_col", 2e-2),
        ("harm_col", 2e-2),
        ("centroid", 1.0),
    ]:
        np.testing.assert_allclose(out[key][:f_valid], ref[key][:f_valid], atol=tol, rtol=1e-3, err_msg=key)
    # The TCN's last TCN_REACH valid frames read the padded tail, whose
    # length differs between the two paths (see the module doc).
    reach = f_valid - TCN_REACH
    np.testing.assert_allclose(out["net_prob"][:reach], ref["net_prob"][:reach], atol=1e-4, rtol=1e-3)
    assert float(out["integrated_lufs"]) == pytest.approx(float(ref["integrated_lufs"]), abs=0.01)
    assert float(out["true_peak"]) == pytest.approx(float(ref["true_peak"]), rel=1e-3)
    assert float(out["stereo_corr_centered"]) == pytest.approx(float(ref["stereo_corr_centered"]), abs=3e-3)
    np.testing.assert_allclose(out["key_scores"], ref["key_scores"], atol=1e-3)
    np.testing.assert_allclose(out["stereo_widths"], ref["stereo_widths"], atol=1e-3)


def _beat(got, ref) -> None:
    assert got.beat.bpm == pytest.approx(ref.beat.bpm, abs=0.01)
    assert got.beat.confidence == pytest.approx(ref.beat.confidence, abs=1e-3)
    assert len(got.beat.beat_times) == len(ref.beat.beat_times)
    np.testing.assert_allclose(got.beat.beat_times, ref.beat.beat_times, atol=1e-3)


def _downbeat(got, ref) -> None:
    from chip_smoke import equal_score_key

    assert got.downbeat.source == ref.downbeat.source
    np.testing.assert_allclose(got.downbeat.downbeat_times, ref.downbeat.downbeat_times, atol=1e-3)
    # as tests/test_sharding.py: one trailing slip of the tracked beat base
    # is float-level noise; near-total agreement of the positions. Below
    # that, the two paths must sit on an exact tie of the bar-position
    # Viterbi across a slipped bar (ROADMAP Queue 3), which rounding
    # decides: the same downbeats (above) and the same score key.
    pos_sh = np.asarray(got.downbeat.beat_positions)
    pos_ref = np.asarray(ref.downbeat.beat_positions)
    assert abs(pos_sh.size - pos_ref.size) <= 1
    m = min(pos_sh.size, pos_ref.size)
    if float((pos_sh[:m] == pos_ref[:m]).mean()) < 0.97:
        key = equal_score_key(list(pos_ref))
        assert equal_score_key(list(pos_sh)) == key and key[2] > 0


def _structure(got, ref) -> None:
    gs, rs = got.structure.segments, ref.structure.segments
    assert [s.label for s in gs] == [s.label for s in rs]
    assert [s.category for s in gs] == [s.category for s in rs]
    np.testing.assert_allclose([s.start for s in gs], [s.start for s in rs], atol=0.05)
    np.testing.assert_allclose([s.end for s in gs], [s.end for s in rs], atol=0.05)


def _loudness(got, ref) -> None:
    for attr in ("integrated_lufs", "true_peak_dbfs", "rms_dbfs"):
        assert getattr(got.loudness, attr) == pytest.approx(getattr(ref.loudness, attr), abs=0.02), attr
    # the short-term / momentary curves are host-computed on the sharded
    # path; the range derived from them must still agree
    assert got.loudness.loudness_range == pytest.approx(ref.loudness.loudness_range, abs=0.1)


def _harmony(got, ref) -> None:
    gh, rh = got.harmonic, ref.harmonic
    assert gh.primary_key.key == rh.primary_key.key
    assert gh.secondary_key.key == rh.secondary_key.key
    assert [h.chord for h in gh.chord_hints] == [h.chord for h in rh.chord_hints]
    s_times = np.array([p.time for p in gh.chord_change_points])
    f_times = np.array([p.time for p in rh.chord_change_points])
    assert s_times.size == f_times.size
    np.testing.assert_allclose(s_times, f_times, atol=1e-3)
    assert gh.spectral_balance.low_band == pytest.approx(rh.spectral_balance.low_band, abs=1e-3)
    assert gh.stereo_image.correlation == pytest.approx(rh.stereo_image.correlation, abs=3e-3)
    for attr in ("hook_suggestion", "bass_suggestion"):
        assert getattr(gh, attr).notes["pitch"].tolist() == getattr(rh, attr).notes["pitch"].tolist()
        assert getattr(gh, attr).notes["velocity"].tolist() == getattr(rh, attr).notes["velocity"].tolist()


def _features(got, ref) -> None:
    np.testing.assert_allclose(got.features.ltas.magnitude, ref.features.ltas.magnitude, rtol=1e-2, atol=1e-3)
    assert got.features.spectral_centroid.mean == pytest.approx(ref.features.spectral_centroid.mean, rel=1e-3)
    assert got.features.spectral_rolloff.mean == pytest.approx(ref.features.spectral_rolloff.mean, rel=1e-3)


def _stereo(got, ref) -> None:
    assert got.stereo.mid_rms == pytest.approx(ref.stereo.mid_rms, abs=1e-4)
    assert got.stereo.side_rms == pytest.approx(ref.stereo.side_rms, abs=1e-4)
    assert got.stereo.correlation == pytest.approx(ref.stereo.correlation, abs=3e-3)
    for band in ("low", "mid", "high"):
        assert getattr(got.stereo.width, band) == pytest.approx(getattr(ref.stereo.width, band), rel=0.02, abs=1e-3), band


_AREAS = {
    "beat": _beat,
    "downbeat": _downbeat,
    "structure": _structure,
    "loudness": _loudness,
    "harmony": _harmony,
    "features": _features,
    "stereo": _stereo,
}


@pytest.mark.parametrize("area", sorted(_AREAS))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_result_matches_fused(world, area, ranks, fused) -> None:
    """``analyse_track_sharded`` against ``analyse_track_fused`` with the
    fields and tolerances of tests/test_sharding.py."""

    _AREAS[area](ranks[0][world]["result"], fused[1])


# ---- the true peak across a shard boundary, the guards -------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_true_peak_exact_across_shard_boundaries(world, ranks) -> None:
    """A smooth plateau crossing each internal shard boundary must not
    ring: the own range is claimed through the output mask, so the
    interpolation reads the true halo samples (zeroing the input outside
    the own range would overshoot by ~1 dB)."""

    from track_analyser_tpu_torch.ops.resample import oversampled_peak

    ref = float(oversampled_peak(torch.from_numpy(_plateau_track(world)), 8))
    assert ranks[0][world]["plateau_peak"] == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_hpss_shape_is_what_each_rank_hands_hpss(world, ranks) -> None:
    assert {r[world]["hpss_shape"] for r in ranks} == {sharded.hpss_shape(SR * SECONDS, SR, world)}


@pytest.mark.parametrize("n", [SR, SR * SECONDS, SR * SECONDS + 1, 512 * 4 * 1000 - 1, 512 * 4 * 1000])
@pytest.mark.parametrize("world", (1, 2, 3, 4))
def test_frames_per_shard_is_the_least_multiple_of_4_that_covers_the_track(n, world) -> None:
    fs = sharded.frames_per_shard(n, world)
    frames = 1 + n // HOP
    assert fs % 4 == 0 and fs * world >= frames > (fs - 4) * world


def test_sharded_rejects_too_short_tracks() -> None:
    group = mesh.SeqGroup(None, 0, 8, torch.device("cpu"), "gloo")  # raises before any collective
    short = np.zeros((2, SR), dtype=np.float32)  # 1 s over 8 shards
    with pytest.raises(ValueError, match="too short"):
        sharded.sharded_track_outputs(short, SR, SR, group)


def test_a_failing_rank_fails_run_sharded_with_its_traceback(computed) -> None:
    """A 4 s track is too short for two shards: the ranks raise, and
    ``run_sharded`` raises with a rank's traceback (no result)."""

    from torch.multiprocessing import ProcessRaisedException

    exc = computed[3]
    assert isinstance(exc, ProcessRaisedException)
    assert "too short for 2 seq shards" in str(exc) and "Traceback" in str(exc)


def test_a_hung_rank_is_stopped_at_the_time_limit(computed) -> None:
    exc, seconds = computed[4]
    assert isinstance(exc, TimeoutError)
    assert HANG_TIMEOUT_S <= seconds < HANG_TIMEOUT_S + 30
