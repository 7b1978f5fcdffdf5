"""The port's artefact rendering (``report.py``, ``rendering/``) against
the JAX package's, on the CPU.

The JAX package's ``_report_dict``, ``_write_csv_tables`` and
``_html_document`` use attribute access only, so they are fed the PORT's
result object and must give the same dict, CSV text and HTML string as the
port's functions. The MIDI writer is compared byte for byte on the same
note table (a ``DataFrame`` there, a dict of columns here), the tempogram
graph within 1e-4 absolute on its inf-normalised columns. Then the entry
points: ``render_all``, ``analyse_track(output_dir=..., use_stems=True)``
and ``analyse_library(output_dir=...)`` write every artefact.
"""

from __future__ import annotations

import json
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from chip_smoke import make_track, with_noise_floor
from track_analyser_tpu import report as jreport
from track_analyser_tpu.ops import onset as jonset
from track_analyser_tpu.rendering import midi as jmidi
from track_analyser_tpu.rendering import outputs as joutputs
from track_analyser_tpu_torch import analyse_track, report
from track_analyser_tpu_torch.io import write_wav
from track_analyser_tpu_torch.ops import onset
from track_analyser_tpu_torch.parallel import batch as tb
from track_analyser_tpu_torch.pipeline import TrackAnalysisResult
from track_analyser_tpu_torch.rendering import midi, outputs, render_all
from track_analyser_tpu_torch.substrate import pad_to_bucket
from track_analyser_tpu_torch.utils import AudioInput

torch.set_num_threads(2)

ATOL = 1e-4
SR = 44_100
PLOTS = ("waveform_beats.png", "tempogram.png", "novelty_boundaries.png", "ltas.png", "stereo_width.png")
TABLES = ("report.json", "beats.csv", "sections.csv", "tracked_beats.csv", "report.html", "hook.mid", "bass.mid")
STEM_FILES = tuple(f"track_{name}.wav" for name in ("drums", "bass", "other", "vocals"))


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    path = tmp_path_factory.mktemp("render_src") / "track.wav"
    write_wav(path, with_noise_floor(make_track(6.0, bpm=120.0, seed=3), 7), SR)
    return path


@pytest.fixture(scope="module")
def result(source):
    return analyse_track(str(source), device="cpu")


def test_report_dict_equals_jax(result) -> None:
    got = report._report_dict(result)
    assert got == jreport._report_dict(result)
    assert list(got) == ["audio", "beat", "downbeat", "structure", "loudness", "harmonic", "features", "stereo"]
    assert got["beat"]["count"] == len(result.beat.beat_times) > 4
    assert json.loads(json.dumps(got)) == got  # plain JSON types only


def test_csv_tables_equal_jax(result, tmp_path) -> None:
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    got = report._write_csv_tables(result, ours)
    ref = jreport._write_csv_tables(result, theirs)
    assert list(got) == list(ref) == ["beats", "sections", "tracked_beats"]
    for name in got:
        assert got[name].name == ref[name].name
        assert got[name].read_text() == ref[name].read_text(), name
    header, *rows = got["beats"].read_text().splitlines()
    assert header == "index,time,frame,is_downbeat" and len(rows) == len(result.beat.beat_times)
    flags = report._flag_downbeats(
        np.asarray(result.beat.beat_times), np.asarray(result.downbeat.downbeat_times)
    )
    assert [row.endswith("True") for row in rows] == flags.tolist()


def test_flag_downbeats_equals_jax() -> None:
    beats = np.arange(0.0, 700.0, 0.5)
    downbeats = np.concatenate([beats[::4][:50] + 0.004, [600.012, 650.2]])
    np.testing.assert_array_equal(
        report._flag_downbeats(beats, downbeats), jreport._flag_downbeats(beats, downbeats)
    )
    assert report._flag_downbeats(beats, downbeats).sum() == 51  # 600.012 rides on isclose's rtol
    assert report._flag_downbeats(np.zeros(0), downbeats).shape == (0,)
    assert not report._flag_downbeats(beats, np.zeros(0)).any()


@pytest.mark.parametrize("plot_refs", [(), PLOTS], ids=["no-plots", "plots"])
def test_html_document_equals_jax(result, plot_refs) -> None:
    got = outputs._html_document(result, list(plot_refs))
    assert got == joutputs._html_document(result, list(plot_refs))
    assert got.startswith("<!doctype html>") and f"{result.beat.bpm:.2f}" in got
    assert ("<h2>Plots</h2>" in got) == bool(plot_refs)


def _table(seed: int, rows: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "start": np.sort(rng.uniform(0.0, 40.0, rows)).round(3),
        "duration": rng.uniform(0.05, 4.0, rows).round(3),
        "pitch": rng.integers(20, 110, rows),
        "velocity": rng.integers(1, 128, rows),
    }


@pytest.mark.parametrize("which", ["hook", "bass", "random", "empty"])
def test_write_midi_is_byte_identical_to_jax(which, result, tmp_path) -> None:
    if which in ("hook", "bass"):
        notes = getattr(result.harmonic, f"{which}_suggestion").notes
        assert len(notes["start"]) > 0
    else:
        notes = _table(5, 40 if which == "random" else 0)
    midi.write_midi(notes, tmp_path / "port.mid")
    jmidi.write_midi(pd.DataFrame(notes), tmp_path / "jax.mid")
    data = (tmp_path / "port.mid").read_bytes()
    assert data == (tmp_path / "jax.mid").read_bytes()
    assert data[:4] == b"MThd" and data.endswith(b"\x00\xff\x2f\x00")


def test_encode_var_len_equals_jax() -> None:
    for value in (0, 1, 127, 128, 480, 16_383, 16_384, 2_097_151, 268_435_455):
        assert midi.encode_var_len(value) == jmidi.encode_var_len(value)
    assert midi.encode_var_len(128) == b"\x81\x00"
    with pytest.raises(ValueError):
        midi.encode_var_len(-1)


def test_tempogram_matches_jax() -> None:
    rng = np.random.default_rng(11)
    env = np.abs(rng.normal(size=700)).astype(np.float32)
    env[::43] += 4.0
    got = onset.tempogram(torch.from_numpy(env)).numpy()
    ref = np.asarray(jonset.tempogram(jnp.asarray(env)))
    assert got.shape == ref.shape == (384, 700)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got[0], 1.0, atol=1e-6)  # inf-normalised, lag 0 on top


# The right ramp is 192 frames long. Neither bucket leaves it that much
# room (3.0 s at 44.1 kHz pads by 126 frames, 2.9 s at 22.05 kHz by 4), so
# it runs past the bucket's own end in both.
@pytest.mark.parametrize("seconds, sr, pad_frames", [(3.0, SR, 126), (2.9, 22_050, 4)], ids=["pad-126", "pad-4"])
def test_tempogram_graph_matches_jax_and_the_exact_shape(seconds, sr, pad_frames) -> None:
    y = with_noise_floor(make_track(seconds, sr=sr, bpm=124.0, seed=4), 2).mean(axis=0)
    # A silent tail: the exact shape's reflection of the signal past its end
    # and the bucket's zeros are then the same samples, so the padded graph
    # must give the exact-shape tempogram on every valid column, ramps and all.
    y[-4096:] = 0.0
    padded, f_valid = pad_to_bucket(y, hop=512)
    assert padded.size // 512 + 1 - f_valid == pad_frames
    ref = np.asarray(
        jreport._tempogram_graph(jnp.asarray(padded), jnp.asarray(y.size), sr=sr, hop_length=512)
    )
    with torch.inference_mode():
        got = report._tempogram_graph(torch.from_numpy(padded), y.size, sr=sr, hop_length=512).numpy()
        exact = report._tempogram_graph(torch.from_numpy(y), y.size, sr=sr, hop_length=512).numpy()
    assert got.shape == ref.shape == (384, 1 + padded.size // 512)
    np.testing.assert_allclose(got[:, :f_valid], ref[:, :f_valid], atol=ATOL)
    assert exact.shape == (384, f_valid)
    np.testing.assert_allclose(got[:, :f_valid], exact, atol=ATOL)


def test_render_all_writes_every_artefact(result, tmp_path) -> None:
    out = render_all(result, tmp_path / "out", device="cpu")
    written = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert written == sorted(PLOTS + TABLES)
    assert out.json == tmp_path / "out" / "report.json"
    assert sorted(p.name for p in out.plots.values()) == sorted(PLOTS)
    assert json.loads(out.json.read_text()) == json.loads(json.dumps(report._report_dict(result)))
    for name in PLOTS:
        assert (tmp_path / "out" / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    html = (tmp_path / "out" / "report.html").read_text()
    assert all(f'src="{name}"' in html for name in PLOTS)
    assert (tmp_path / "out" / "hook.mid").read_bytes()[:4] == b"MThd"


def test_render_all_without_plots_and_the_request_paths(result, tmp_path) -> None:
    request = report.ReportRequest(
        include_plots=False, json_path=tmp_path / "elsewhere" / "r.json", csv_dir=tmp_path / "tables"
    )
    out = render_all(result, tmp_path / "out", report_request=request, device="cpu")
    assert out.plots == {} and out.json == tmp_path / "elsewhere" / "r.json" and out.json.exists()
    assert sorted(p.name for p in (tmp_path / "tables").iterdir()) == ["beats.csv", "sections.csv", "tracked_beats.csv"]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["bass.mid", "hook.mid", "report.html"]
    assert "<h2>Plots</h2>" not in (tmp_path / "out" / "report.html").read_text()
    only_json = report.generate_report(
        result, tmp_path / "j", report.ReportRequest(include_csv=False, include_plots=False), device="cpu"
    )
    assert only_json.csv == {} and [p.name for p in (tmp_path / "j").iterdir()] == ["report.json"]


def test_plots_without_matplotlib_raise_import_error(result, tmp_path, monkeypatch) -> None:
    """A request for plots on a host without matplotlib is an error, never
    a silent skip; everything else still renders there."""

    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        render_all(result, tmp_path / "plots", device="cpu")
    assert not list((tmp_path / "plots").glob("*.png"))
    render_all(result, tmp_path / "none", report_request=report.ReportRequest(include_plots=False), device="cpu")
    assert (tmp_path / "none" / "report.html").exists()


def test_importing_the_port_leaves_matplotlib_out() -> None:
    import subprocess

    code = (
        "import sys, track_analyser_tpu_torch.report, track_analyser_tpu_torch.rendering.outputs; "
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'; "
        "assert 'jax' not in sys.modules, 'jax imported'"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_analyse_track_with_output_dir_and_stems(source, tmp_path) -> None:
    """The call the reference CLI's ``analyze --stems -o out`` makes: the
    progress stages fire in the reference's order, the stems land beside
    the artefacts."""

    stages = []
    got = analyse_track(
        str(source), output_dir=tmp_path / "out", use_stems=True, device="cpu", progress_callback=stages.append
    )
    assert stages == [
        "audio", "beats", "structure", "loudness", "harmonic", "features", "stereo", "stems", "render",
    ]
    assert got.stems.model_name == "bandsplit-masknet-v5"
    assert sorted(p.name for p in got.stems.stems.values()) == sorted(STEM_FILES)
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(PLOTS + TABLES + STEM_FILES)
    report_json = json.loads((tmp_path / "out" / "report.json").read_text())
    assert report_json["audio"]["path"] == str(source)
    assert report_json["beat"]["bpm"] == got.beat.bpm


def test_analyse_track_stems_without_a_path_or_output_dir(source, result, tmp_path, monkeypatch) -> None:
    stages = []
    in_memory = analyse_track(
        AudioInput(samples=result.audio.samples, sample_rate=SR, stereo_samples=result.audio.stereo_samples),
        use_stems=True, device="cpu", progress_callback=stages.append,
    )
    assert in_memory.stems is None and stages[-1] == "stems" and "render" not in stages
    monkeypatch.chdir(tmp_path)  # without output_dir the stems go to ./stems
    on_disk = analyse_track(str(source), use_stems=True, device="cpu")
    assert sorted(p.name for p in (tmp_path / "stems").iterdir()) == sorted(STEM_FILES)
    assert all(p.parent == tmp_path / "stems" for p in on_disk.stems.stems.values())


def test_analyse_library_renders_one_subdirectory_per_track(source, result, tmp_path) -> None:
    other = tmp_path / "other_take.wav"
    write_wav(other, with_noise_floor(make_track(5.0, bpm=126.0, seed=5), 8).mean(axis=0), SR)
    in_memory = AudioInput(samples=result.audio.samples, sample_rate=SR, stereo_samples=result.audio.stereo_samples)
    outcome = tb.analyse_library(
        [str(source), str(other), in_memory], output_dir=tmp_path / "out", device="cpu", device_batch=2
    )
    assert all(isinstance(item, TrackAnalysisResult) for item in outcome)
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["other_take", "track", "track_00002"]
    for item, name in zip(outcome, ("track", "other_take", "track_00002")):
        folder = tmp_path / "out" / name
        assert sorted(p.name for p in folder.iterdir()) == sorted(PLOTS + TABLES), name
        assert json.loads((folder / "report.json").read_text())["beat"]["bpm"] == item.beat.bpm
    assert outcome[0].beat.bpm == pytest.approx(result.beat.bpm, abs=1e-3)


def test_render_all_cuda_raises_without_cuda(result, tmp_path) -> None:
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the error path needs a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_all(result, tmp_path)
    # the tables need no device: without plots the default device is not touched
    render_all(result, tmp_path, report_request=report.ReportRequest(include_plots=False))
    assert (tmp_path / "report.json").exists()
