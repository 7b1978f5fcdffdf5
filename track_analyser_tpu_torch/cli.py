"""Command line interface: ``analyze`` and ``analyze-batch``.

    python3 -m track_analyser_tpu_torch.cli analyze WAV --out DIR [--plots skip]
    python3 -m track_analyser_tpu_torch.cli analyze-batch A.wav B.wav --out DIR \\
        [--manifest M.jsonl] [--transport ms5] [--device-batch 4] [--plots skip]

The JAX package's commands with the same flags, skip sentinels
(skip|none|false|off), messages and exit codes: 0 on success, 1 when the
analysis or the rendering fails (``Error: ...``), 2 for a usage error.
Two options are the port's own: ``--device`` on both commands (default
``cuda``; ``cpu`` runs the plain PyTorch path), and ``--plots`` on
``analyze-batch``, which takes only a skip sentinel: it renders every
track without its plot PNGs, for a host without matplotlib (plots are
never skipped silently). The commands are built on ``argparse``, so the
port needs no command line package; there is no progress bar.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Iterable, Optional, Sequence, Tuple

SKIP_VALUES = {"skip", "none", "false", "off"}

_ARTEFACT_FLAGS = (
    ("plots", "plot PNGs", "directory"),
    ("json", "report.json", "file"),
    ("csv", "CSV tables", "directory"),
)


def _existing_file(value: str) -> Path:
    path = Path(value)
    if not path.exists():
        raise argparse.ArgumentTypeError(f"File '{value}' does not exist.")
    if path.is_dir():
        raise argparse.ArgumentTypeError(f"File '{value}' is a directory.")
    return path


def _route(value: Optional[str], out_dir: Path) -> Tuple[bool, Optional[Path]]:
    """Map a flag value to (enabled, destination): None keeps the default
    destination, a sentinel disables the artefact, anything else is a
    path override resolved against --out when relative."""

    if value is None:
        return True, None
    if value.lower() in SKIP_VALUES:
        return False, None
    path = Path(value)
    return True, path if path.is_absolute() else (out_dir / path).resolve()


def _where(paths: Iterable[Path]) -> str:
    """One directory when everything landed together, else the full list."""

    realised = list(paths)
    if not realised:
        return "skipped"
    parents = {p.parent for p in realised}
    return str(parents.pop()) if len(parents) == 1 else ", ".join(map(str, realised))


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="track-analyser-tpu-torch",
        description="Track analyser (PyTorch + CUDA) command line utilities.",
    )
    commands = parser.add_subparsers(dest="command", required=True)

    analyze = commands.add_parser("analyze", help="Analyse one file and render artefacts to disk.")
    analyze.add_argument("audio_path", type=_existing_file)
    analyze.add_argument(
        "--out", dest="output_dir", type=Path, required=True,
        help="Destination for generated artefacts (HTML, MIDI, tables, plots).",
    )
    for name, what, kind in _ARTEFACT_FLAGS:
        analyze.add_argument(
            f"--{name}", dest=f"{name}_option", default=None,
            help=f"Generate {what}. Provide a {kind} path or 'skip' to disable.",
        )

    batch = commands.add_parser("analyze-batch", help="Analyse a library of tracks.")
    batch.add_argument("audio_paths", type=_existing_file, nargs="+")
    batch.add_argument(
        "--out", dest="output_dir", type=Path, required=True,
        help="Destination root; each track renders into OUT/<stem>/.",
    )
    batch.add_argument(
        "--manifest", dest="manifest_path", type=Path, default=None,
        help="JSONL manifest for resumable sweeps (skips already-listed tracks).",
    )
    batch.add_argument(
        "--upload-streams", type=int, default=2,
        help="Concurrent host->device upload streams (default: 2).",
    )
    batch.add_argument(
        "--decode-workers", type=int, default=None,
        help="Host decode/quantise worker threads [default: cores-1, at most 4].",
    )
    batch.add_argument(
        "--transport", choices=["ms", "ms6", "ms5", "int8", "int16"], default="ms",
        help="Host->device payload: 'ms' ships the mid channel only as blockwise "
        "int8 (1 byte per stereo sample pair; stereo scalars and widths are "
        "host-exact); 'ms6' packs 6-bit mid codes, per block raw or delta-coded "
        "(0.75 B/pair); 'ms5' packs noise-shaped 5-bit codes on 1 024-sample "
        "blocks (0.63 B/pair); 'int8'/'int16' ship both channels (default: ms).",
    )
    batch.add_argument(
        "--prewarm", action=argparse.BooleanOptionalAction, default=None,
        help="Build the CUDA kernels while the first tracks decode "
        "(default: on for a CUDA device).",
    )
    batch.add_argument(
        "--device-batch", type=int, default=1,
        help="Tracks analysed per dispatch (default: 1).",
    )
    batch.add_argument(
        "--plots", dest="plots_option", default=None,
        help="'skip' renders every track without its plot PNGs (plots need matplotlib).",
    )
    batch.add_argument(
        "--shard", dest="shard_spec", default=None,
        help="'i/n' for multi-process sweeps: this process analyses every n-th "
        "source starting at i (0-based).",
    )

    for command in (analyze, batch):
        command.add_argument(
            "--device", default="cuda",
            help="Where the analysis runs: 'cuda' (default) or 'cpu'.",
        )
    return parser


def _analyze(args: argparse.Namespace) -> int:
    """Analyse one file and render its artefacts to disk."""

    from . import report as report_module
    from .pipeline import analyse_track
    from .rendering import outputs as outputs_module

    output_dir: Path = args.output_dir
    output_dir.mkdir(parents=True, exist_ok=True)
    try:
        result = analyse_track(args.audio_path, device=args.device)
        plots_on, plots_dest = _route(args.plots_option, output_dir)
        json_on, json_dest = _route(args.json_option, output_dir)
        csv_on, csv_dest = _route(args.csv_option, output_dir)
        artefacts = outputs_module.render_all(
            result,
            output_dir,
            report_request=report_module.ReportRequest(
                include_plots=plots_on,
                include_json=json_on,
                include_csv=csv_on,
                plots_dir=plots_dest,
                json_path=json_dest,
                csv_dir=csv_dest,
            ),
            device=args.device,
        )
        print(
            f"Analysis completed -> {output_dir}\n"
            f"BPM: {result.beat.bpm:.2f}, Key: {result.harmonic.key_estimate.key}\n"
            f"JSON: {artefacts.json if artefacts.json else 'skipped'}\n"
            f"CSV: {_where(artefacts.csv.values())}\n"
            f"Plots: {_where(artefacts.plots.values())}"
        )
    except Exception as exc:
        print(f"Error: {exc}")
        return 1
    return 0


def _analyze_batch(args: argparse.Namespace, parser: argparse.ArgumentParser) -> int:
    """Analyse a library of tracks through the batched sweep."""

    output_dir: Path = args.output_dir
    shard = None
    if args.shard_spec is not None:
        try:
            idx_s, count_s = args.shard_spec.split("/", 1)
            shard = (int(idx_s), int(count_s))
        except ValueError:
            parser.error("Invalid value for --shard: expected 'i/n', e.g. --shard 0/4")
    report_request = None
    if args.plots_option is not None:
        if args.plots_option.lower() not in SKIP_VALUES:
            parser.error("Invalid value for --plots: analyze-batch takes only 'skip' (or none|false|off)")
        from .report import ReportRequest

        report_request = ReportRequest(include_plots=False)
    output_dir.mkdir(parents=True, exist_ok=True)

    from .parallel.batch import SkippedTrack, TrackFailure, analyse_library

    try:
        outcomes = analyse_library(
            [str(p) for p in args.audio_paths],
            device=args.device,
            output_dir=output_dir,
            manifest_path=args.manifest_path,
            upload_streams=args.upload_streams,
            decode_workers=args.decode_workers,
            transport=args.transport,
            prewarm=args.prewarm,
            device_batch=args.device_batch,
            shard=shard,
            report_request=report_request,
        )
        results = [r for r in outcomes if not isinstance(r, (TrackFailure, SkippedTrack))]
        failures = [r for r in outcomes if isinstance(r, TrackFailure)]
        skipped = [r for r in outcomes if isinstance(r, SkippedTrack) and r.reason == "manifest"]
        elsewhere = [r for r in outcomes if isinstance(r, SkippedTrack) and r.reason == "other-shard"]
        print(
            f"Library analysis completed -> {output_dir} "
            f"({len(results)} track(s)"
            + (f", {len(skipped)} already done" if skipped else "")
            + (f", {len(elsewhere)} on other shards" if elsewhere else "")
            + (f", {len(failures)} failed" if failures else "")
            + ")"
        )
        for result in results:
            print(
                f"  {Path(result.audio.path or '?').name}: "
                f"BPM {result.beat.bpm:.2f}, key {result.harmonic.primary_key.key}"
            )
        for failure in failures:
            print(f"  {Path(failure.source).name}: {failure.error}")
    except Exception as exc:
        print(f"Error: {exc}")
        return 1
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run one command; returns its exit code (a usage error exits 2)."""

    parser = _parser()
    args = parser.parse_args(argv)
    if args.command == "analyze":
        return _analyze(args)
    return _analyze_batch(args, parser)


if __name__ == "__main__":
    sys.exit(main())
