"""The port's command line (``track_analyser_tpu_torch.cli``) on the CPU.

The commands are the JAX package's ``analyze`` and ``analyze-batch`` with
the same flags, skip sentinels, messages and exit codes, plus ``--device``
(here always ``cpu``). The port's CLI is built on ``argparse`` (the card's
machine has no command line package), so the tests call ``main(argv)``
and read its standard output; the JAX CLI runs through click's
``CliRunner``. On one short WAV, the port's report.json must equal the
JAX CLI's: the same keys, strings and counts, and every number within
``test_torch_pipeline``'s tolerance for its field.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import make_track, with_noise_floor
from track_analyser_tpu_torch.cli import main
from track_analyser_tpu_torch.io import write_wav

torch.set_num_threads(2)

SR = 44_100
PLOTS = ("waveform_beats.png", "tempogram.png", "novelty_boundaries.png", "ltas.png", "stereo_width.png")
TABLES = ("beats.csv", "sections.csv", "tracked_beats.csv")


def _wav(path: Path, seconds: float, seed: int, *, stereo: bool = True) -> Path:
    x = with_noise_floor(make_track(seconds, bpm=120.0 + seed, seed=seed), 50 + seed)
    write_wav(path, x if stereo else x.mean(axis=0), SR)
    return path


@pytest.fixture(scope="module")
def wav(tmp_path_factory) -> Path:
    return _wav(tmp_path_factory.mktemp("audio") / "clip.wav", 6.0, 0)


@pytest.fixture(scope="module")
def library(tmp_path_factory) -> "list[Path]":
    root = tmp_path_factory.mktemp("library")
    bad = root / "bad.wav"
    bad.write_bytes(b"RIFF this file is not audio " * 16)
    return [_wav(root / "a.wav", 4.0, 1), bad, _wav(root / "b_mono.wav", 3.0, 2, stereo=False)]


def _run(capsys, *argv: str) -> "tuple[int, str]":
    code = main([str(a) for a in argv])
    return code, capsys.readouterr().out


@pytest.mark.parametrize(
    "command, flags",
    [
        ("analyze", ("--out", "--plots", "--json", "--csv", "--device")),
        ("analyze-batch", ("--out", "--manifest", "--upload-streams", "--decode-workers", "--transport",
                           "--prewarm", "--device-batch", "--shard", "--plots", "--device")),
    ],
)
def test_help_lists_the_flags(command, flags, capsys) -> None:
    with pytest.raises(SystemExit) as exc:
        main([command, "--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    for flag in flags:
        assert flag in out, flag


def test_artefacts_land_at_custom_paths(wav, tmp_path, capsys) -> None:
    out_dir, plots_dir, csv_dir = tmp_path / "report", tmp_path / "plots", tmp_path / "tables"
    json_path = tmp_path / "custom" / "custom_report.json"
    code, out = _run(
        capsys, "analyze", wav, "--out", out_dir, "--plots", plots_dir, "--json", json_path,
        "--csv", csv_dir, "--device", "cpu",
    )
    assert code == 0, out
    assert json_path.exists()
    assert all((csv_dir / name).exists() for name in TABLES)
    assert all((plots_dir / name).exists() for name in PLOTS)
    assert all((out_dir / name).exists() for name in ("report.html", "hook.mid", "bass.mid"))
    assert f"JSON: {json_path}" in out and f"CSV: {csv_dir}" in out and f"Plots: {plots_dir}" in out
    assert out.startswith(f"Analysis completed -> {out_dir}\nBPM: ")


def test_relative_paths_resolve_against_out(wav, tmp_path, capsys) -> None:
    out_dir = tmp_path / "out"
    code, out = _run(capsys, "analyze", wav, "--out", out_dir, "--json", "sub/r.json", "--csv", "t",
                     "--plots", "skip", "--device", "cpu")
    assert code == 0, out
    assert (out_dir / "sub" / "r.json").exists() and (out_dir / "t" / "beats.csv").exists()


@pytest.mark.parametrize("sentinel", ["skip", "none", "false", "OFF"])
def test_skip_sentinels_suppress_artefact_families(sentinel, wav, tmp_path, capsys) -> None:
    out_dir = tmp_path / "out"
    code, out = _run(capsys, "analyze", wav, "--out", out_dir, "--plots", sentinel, "--csv", sentinel,
                     "--device", "cpu")
    assert code == 0, out
    assert (out_dir / "report.json").exists() and (out_dir / "report.html").exists()
    assert not list(out_dir.glob("*.csv")) and not list(out_dir.glob("*.png"))
    assert "CSV: skipped" in out and "Plots: skipped" in out
    code, out = _run(capsys, "analyze", wav, "--out", tmp_path / "nojson", "--json", sentinel,
                     "--plots", "skip", "--device", "cpu")
    assert code == 0 and "JSON: skipped" in out
    assert not (tmp_path / "nojson" / "report.json").exists()


def test_plots_without_matplotlib_fail_loudly(wav, tmp_path, capsys, monkeypatch) -> None:
    """A host without matplotlib: plots raise ImportError (exit 1, the
    error printed), never a silent skip; --plots skip gets through."""

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    code, out = _run(capsys, "analyze", wav, "--out", tmp_path / "a", "--device", "cpu")
    assert code == 1 and out.startswith("Error: ") and "matplotlib" in out
    code, out = _run(capsys, "analyze", wav, "--out", tmp_path / "b", "--plots", "skip", "--device", "cpu")
    assert code == 0, out
    assert json.loads((tmp_path / "b" / "report.json").read_text())["beat"]["bpm"] > 0


def test_decode_error_probe_exits_1(library, tmp_path, capsys) -> None:
    code, out = _run(capsys, "analyze", library[1], "--out", tmp_path / "o", "--device", "cpu")
    assert code == 1
    assert out == f"Error: Could not decode audio file: {library[1]}\n"


def test_usage_errors_exit_2(tmp_path, library, capsys) -> None:
    for argv in (
        ["analyze", tmp_path / "missing.wav", "--out", tmp_path],
        ["analyze", tmp_path, "--out", tmp_path],
        ["analyze", library[0]],
        ["analyze-batch", library[0], "--out", tmp_path, "--transport", "float64"],
        ["analyze-batch", library[0], "--out", tmp_path, "--shard", "one/two"],
        ["analyze-batch", library[0], "--out", tmp_path, "--plots", "pngs"],
    ):
        with pytest.raises(SystemExit) as exc:
            main([str(a) for a in argv])
        assert exc.value.code == 2, argv
    err = capsys.readouterr().err
    assert "does not exist" in err and "is a directory" in err and "expected 'i/n'" in err
    assert "takes only 'skip'" in err


def test_cuda_is_the_default_device(wav, tmp_path, capsys) -> None:
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the error path needs a host without it")
    code, out = _run(capsys, "analyze", wav, "--out", tmp_path, "--plots", "skip")
    assert code == 1 and "CUDA is not available" in out


def test_analyze_batch_with_a_manifest_resumes(library, tmp_path, capsys) -> None:
    out_dir, manifest = tmp_path / "out", tmp_path / "sweep.jsonl"
    argv = ["analyze-batch", *library, "--out", out_dir, "--manifest", manifest, "--transport", "ms5",
            "--device-batch", "2", "--device", "cpu"]
    code, out = _run(capsys, *argv)
    assert code == 0, out
    lines = out.splitlines()
    assert lines[0] == f"Library analysis completed -> {out_dir} (2 track(s), 1 failed)"
    assert lines[1].startswith("  a.wav: BPM ") and lines[2].startswith("  b_mono.wav: BPM ")
    assert lines[3] == "  bad.wav: Could not decode audio file: " + str(library[1])
    for stem in ("a", "b_mono"):
        assert (out_dir / stem / "report.json").exists() and (out_dir / stem / "waveform_beats.png").exists()
    records = [json.loads(line) for line in manifest.read_text().splitlines()]
    assert sorted(r["source"] for r in records) == sorted(str(p) for p in library)

    code, out = _run(capsys, *argv)
    assert code == 0, out
    assert out.splitlines()[0] == f"Library analysis completed -> {out_dir} (0 track(s), 2 already done, 1 failed)"


def test_analyze_batch_plots_skip(library, tmp_path, capsys, monkeypatch) -> None:
    """Without matplotlib a batch that renders plots fails loudly; with
    --plots skip every track renders its report, CSVs, HTML and MIDI."""

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    code, out = _run(capsys, "analyze-batch", library[0], "--out", tmp_path / "a", "--device", "cpu")
    assert code == 1 and out.startswith("Error: ") and "matplotlib" in out
    code, out = _run(capsys, "analyze-batch", library[0], library[2], "--out", tmp_path / "b",
                     "--plots", "skip", "--device", "cpu")
    assert code == 0, out
    for stem in ("a", "b_mono"):
        folder = tmp_path / "b" / stem
        assert all((folder / name).exists() for name in ("report.json", "report.html", "hook.mid") + TABLES)
        assert not list(folder.glob("*.png"))


def test_analyze_batch_shards(library, tmp_path, capsys) -> None:
    code, out = _run(capsys, "analyze-batch", *library, "--out", tmp_path, "--shard", "1/2", "--device", "cpu")
    assert code == 0, out
    assert out.splitlines()[0] == f"Library analysis completed -> {tmp_path} (0 track(s), 2 on other shards, 1 failed)"


# report.json: the tolerance of each numeric field, by its path with list
# indices dropped (test_torch_pipeline's tolerances).
REPORT_TOL = {
    "beat.bpm": 1e-3,
    "beat.confidence": 1e-3,
    "beat.tracked.times": 0.012,
    "structure.start": 1e-3,
    "structure.end": 1e-3,
    "structure.confidence": 1e-3,
    "loudness.integrated_lufs": 5e-3,
    "loudness.loudness_range": 5e-3,
    "loudness.true_peak_dbfs": 5e-3,
    "loudness.rms_dbfs": 5e-3,
    "harmonic.key_confidence": 1e-3,
    "harmonic.secondary_key.confidence": 1e-3,
    "harmonic.chord_change_points.time": 1e-4,
    "harmonic.chord_change_points.strength": 1e-2,
    "stereo.mid_rms": 1e-4,
    "stereo.side_rms": 1e-4,
    "stereo.correlation": 1e-3,
    "stereo.width.low": 1e-2,
    "stereo.width.mid": 1e-2,
    "stereo.width.high": 1e-2,
}
REPORT_RTOL = {
    "features.ltas.magnitude": 1e-3,
    "features.spectral_centroid.mean": 1e-3,
    "features.spectral_centroid.median": 1e-3,
    "features.spectral_rolloff.mean": 1e-3,
    "features.spectral_rolloff.median": 1e-3,
}


def _assert_report_equal(got, ref, path: str = "") -> None:
    assert type(got) is type(ref) or {type(got), type(ref)} <= {int, float}, path
    if isinstance(ref, dict):
        assert list(got) == list(ref), path
        for key in ref:
            _assert_report_equal(got[key], ref[key], f"{path}.{key}" if path else key)
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for g, r in zip(got, ref):
            _assert_report_equal(g, r, path)
    elif isinstance(ref, float) and path in REPORT_TOL:
        assert got == pytest.approx(ref, abs=REPORT_TOL[path]), path
    elif isinstance(ref, float) and path in REPORT_RTOL:
        # ltas: rtol 1e-3 plus atol 1e-3 on the magnitudes, as there
        atol = 1e-3 if path == "features.ltas.magnitude" else 0.0
        assert got == pytest.approx(ref, rel=REPORT_RTOL[path], abs=atol), path
    else:
        assert got == ref, path  # strings, counts, paths, the frequency axis


def test_report_json_equals_the_jax_cli(wav, tmp_path, capsys) -> None:
    from click.testing import CliRunner

    from track_analyser_tpu.cli import cli as jax_cli

    code, out = _run(capsys, "analyze", wav, "--out", tmp_path / "port", "--plots", "skip", "--device", "cpu")
    assert code == 0, out
    result = CliRunner().invoke(jax_cli, ["analyze", str(wav), "--out", str(tmp_path / "jax"), "--plots", "skip"])
    assert result.exit_code == 0, result.output
    got = json.loads((tmp_path / "port" / "report.json").read_text())
    ref = json.loads((tmp_path / "jax" / "report.json").read_text())
    _assert_report_equal(got, ref)
    assert got["downbeat"]["source"] == "rnn" and got["beat"]["tracked"]["count"] >= 8
    # the other artefacts of one result match by name
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert np.isfinite(got["beat"]["bpm"])
