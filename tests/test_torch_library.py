"""The port's library sweep (``parallel/batch.analyse_library``) against
the JAX package's, on the CPU.

A small WAV library (two stereo tracks, one mono track, one file that
does not decode) goes through both sweeps with the default "ms"
transport. The JAX sweep gets a one-device mesh, so that it does not pad
its chunks to the suite's 8 virtual devices. Outcomes are compared by
position, each result field at ``test_agreement.py``'s tolerances
(``chip_smoke.compare_results``, the check the card runs). Also: the
manifest's resume, ``shard`` striping, lanes at ``device_batch=2``
against batch 1, the sub-byte transports against the JAX sweep, and the
options that raise.
"""

from __future__ import annotations

import json

import pytest
import torch

from chip_smoke import compare_results, make_track, with_noise_floor
from track_analyser_tpu_torch.io import AudioDecodeError, write_wav
from track_analyser_tpu_torch.parallel import batch as tb
from track_analyser_tpu_torch.pipeline import TrackAnalysisResult

torch.set_num_threads(2)

SR = 44_100
# (file, seconds, bpm, seed, stereo); None marks the file that does not
# decode. All tracks share one "ms" bucket (196 608 samples).
LIBRARY = [
    ("a.wav", 4.2, 120.0, 0, True),
    ("bad.wav", None, None, None, None),
    ("b_mono.wav", 3.6, 126.0, 1, False),
    ("c.wav", 3.3, 124.0, 2, True),
]
GOOD = [i for i, item in enumerate(LIBRARY) if item[1] is not None]


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("library")
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
def port_sweep(sources, tmp_path_factory):
    manifest = tmp_path_factory.mktemp("manifest") / "sweep.jsonl"
    seen = []
    outcome = tb.analyse_library(
        sources,
        device="cpu",
        device_batch=2,
        manifest_path=manifest,
        progress_callback=lambda src, done, total: seen.append((src, done, total)),
    )
    return outcome, manifest, seen


@pytest.fixture(scope="module")
def jax_sweep(sources):
    import jax

    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.parallel.mesh import make_mesh

    return analyse_library(sources, mesh=make_mesh(devices=jax.devices()[:1]), transport="ms")


def test_outcomes_by_position_match_jax(port_sweep, jax_sweep) -> None:
    from track_analyser_tpu.parallel.batch import TrackFailure as JaxTrackFailure

    outcome, _manifest, _seen = port_sweep
    assert len(outcome) == len(jax_sweep) == len(LIBRARY)
    for i, (got, ref) in enumerate(zip(outcome, jax_sweep)):
        if i in GOOD:
            assert isinstance(got, TrackAnalysisResult), i
            compare_results(got, ref, f"port vs JAX sweep, source {i}")
        else:
            assert isinstance(got, tb.TrackFailure) and isinstance(ref, JaxTrackFailure)
            assert got.source == ref.source


def test_manifest_records_and_resumes(port_sweep, sources) -> None:
    """Done sources are recorded and skipped on a rerun; the failed one is
    recorded with its error and retried."""

    outcome, manifest, seen = port_sweep
    records = [json.loads(line) for line in manifest.read_text().splitlines()]
    assert sorted(r["source"] for r in records) == sorted(sources)
    assert [r["source"] for r in records if "error" in r] == [sources[1]]
    assert sorted(done for _src, done, _total in seen) == [1, 2, 3, 4]
    assert {total for _src, _done, total in seen} == {len(sources)}

    rerun = tb.analyse_library(sources, device="cpu", manifest_path=manifest)
    for i, item in enumerate(rerun):
        expected = tb.SkippedTrack if i in GOOD else tb.TrackFailure
        assert isinstance(item, expected), (i, item)
    assert all(rerun[i].reason == "manifest" for i in GOOD)


def test_device_batch_lanes_equal_batch_one(port_sweep, sources) -> None:
    outcome, _manifest, _seen = port_sweep
    single = tb.analyse_library(sources, device="cpu", device_batch=1)
    for i in GOOD:
        compare_results(outcome[i], single[i], f"device_batch 2 vs 1, source {i}")
        assert outcome[i].loudness.integrated_lufs == single[i].loudness.integrated_lufs
        assert outcome[i].beat.bpm == single[i].beat.bpm


def test_shard_striping_covers_each_source_once(sources) -> None:
    shards = [tb.analyse_library(sources, device="cpu", shard=(k, 2)) for k in range(2)]
    for i in range(len(sources)):
        kinds = [type(shard[i]) for shard in shards]
        others = [s[i] for s in shards if isinstance(s[i], tb.SkippedTrack)]
        assert len(others) == 1 and others[0].reason == "other-shard", (i, kinds)
        assert sum(k is not tb.SkippedTrack for k in kinds) == 1, (i, kinds)


def test_on_error_raise_aborts_on_the_undecodable_file(sources) -> None:
    with pytest.raises(AudioDecodeError):
        tb.analyse_library(sources[1:2], device="cpu", on_error="raise")


@pytest.mark.parametrize(
    "kwargs, error",
    [
        ({"transport": "float64"}, ValueError),
        ({"on_error": "ignore"}, ValueError),
        ({"shard": (2, 2)}, ValueError),
    ],
)
def test_bad_options_raise(kwargs, error) -> None:
    with pytest.raises(error):
        tb.analyse_library([], device="cpu", **kwargs)


@pytest.mark.parametrize("transport", ["ms6", "ms5", "int8", "int16", "float32"])
def test_every_transport_sweeps_an_empty_list(transport) -> None:
    assert tb.analyse_library([], device="cpu", transport=transport) == []


@pytest.mark.parametrize("transport, bits", [("ms6", 6), ("ms5", 5)])
def test_subbyte_sweep_matches_jax_and_counts_its_bytes(transport, bits, sources) -> None:
    """A sub-byte sweep of the two stereo tracks at ``device_batch`` 2
    against the JAX sweep with the same transport; it uploads the packed
    codes (bits / 8 bytes per bucket sample), a float32 scale and base
    per block, and an int64 n_valid, lane by lane."""

    import jax

    from track_analyser_tpu.parallel.batch import analyse_library
    from track_analyser_tpu.parallel.mesh import make_mesh

    picked = [sources[0], sources[3]]
    tb.reset_upload_bytes()
    got = tb.analyse_library(picked, device="cpu", transport=transport, device_batch=2)
    bucket = tb.ms_bucket_length(int(LIBRARY[0][1] * SR))
    per_lane = bucket * bits // 8 + 8 * (bucket // tb._ms_block(bits)) + 8
    assert tb.upload_bytes() == 2 * per_lane
    ref = analyse_library(picked, mesh=make_mesh(devices=jax.devices()[:1]), transport=transport)
    for i, (g, r) in enumerate(zip(got, ref)):
        compare_results(g, r, f"port vs JAX {transport} sweep, source {i}")


def test_sweep_counts_its_upload_bytes(sources) -> None:
    """"ms" ships one byte per bucket sample plus the block scales and
    n_valid, lane by lane."""

    tb.reset_upload_bytes()
    tb.reset_stage_seconds()
    tb.analyse_library(sources[:1], device="cpu")
    bucket = tb.ms_bucket_length(int(LIBRARY[0][1] * SR))
    assert tb.upload_bytes() == bucket + 4 * (bucket // 65_536) + 8
    stages = tb.stage_seconds()
    assert all(stages[k] > 0 for k in ("decode", "quantise", "upload", "dispatch", "finish")), stages
