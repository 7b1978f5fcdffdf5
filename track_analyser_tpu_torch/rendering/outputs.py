"""Rendering helpers: HTML report + MIDI suggestions + report artefacts.

``render_all`` produces report.json / CSVs / plots (via ``report.py``),
report.html, hook.mid and bass.mid, as the JAX package's does; the HTML
document is the same string for the same result.
"""

from __future__ import annotations

import html
from pathlib import Path
from typing import Iterable, Optional, Sequence

import torch

from .. import report as report_module
from ..pipeline import TrackAnalysisResult
from .midi import write_midi

__all__ = ["render_all"]


def render_all(
    result: TrackAnalysisResult,
    output_dir: Path,
    *,
    report_request: "report_module.ReportRequest | None" = None,
    device: "str | torch.device" = "cuda",
) -> report_module.ReportOutputs:
    """Write every artefact of ``result`` into ``output_dir``. ``device``
    is where the tempogram plot's graph runs (``report.generate_report``);
    plots need matplotlib and raise ImportError without it."""

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    report_outputs = report_module.generate_report(
        result, output_dir, report_request, device=device
    )
    plot_refs = [
        p.name
        for p in report_outputs.plots.values()
        if p.parent == output_dir and p.exists()
    ]
    (output_dir / "report.html").write_text(
        _html_document(result, plot_refs), encoding="utf-8"
    )
    _write_midi(result.harmonic.hook_suggestion, output_dir / "hook.mid")
    _write_midi(result.harmonic.bass_suggestion, output_dir / "bass.mid")
    return report_outputs


# ---------------------------------------------------------------------------
# HTML document builder
# ---------------------------------------------------------------------------

_CSS = """
:root {
  --page: #f9f9f7; --surface: #fcfcfb; --ink: #0b0b0b;
  --ink-2: #52514e; --muted: #898781; --hairline: #e1e0d9;
}
body { font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
       background: var(--page); color: var(--ink);
       margin: 0; padding: 2rem; }
main { max-width: 60rem; margin: 0 auto; }
h1 { font-size: 1.3rem; margin: 0 0 0.25rem; }
h2 { font-size: 1.0rem; color: var(--ink-2); margin: 2rem 0 0.5rem; }
p.sub { color: var(--muted); margin: 0 0 1.5rem; font-size: 0.85rem; }
.tiles { display: flex; flex-wrap: wrap; gap: 0.75rem; }
.tile { background: var(--surface); border: 1px solid var(--hairline);
        border-radius: 6px; padding: 0.75rem 1rem; min-width: 8rem; }
.tile .v { font-size: 1.4rem; font-weight: 600; }
.tile .k { font-size: 0.75rem; color: var(--muted); text-transform: uppercase;
           letter-spacing: 0.04em; }
.tile .s { font-size: 0.75rem; color: var(--ink-2); }
table { border-collapse: collapse; width: 100%; background: var(--surface);
        font-size: 0.85rem; font-variant-numeric: tabular-nums; }
th { text-align: left; color: var(--muted); font-weight: 500; }
th, td { border-bottom: 1px solid var(--hairline); padding: 0.4rem 0.6rem; }
img.plot { width: 100%; border: 1px solid var(--hairline); border-radius: 6px;
           background: var(--surface); margin-bottom: 0.75rem; }
"""


def _tile(label: str, value: str, sub: str = "") -> str:
    parts = [f'<div class="k">{html.escape(label)}</div>',
             f'<div class="v">{html.escape(value)}</div>']
    if sub:
        parts.append(f'<div class="s">{html.escape(sub)}</div>')
    return f'<div class="tile">{"".join(parts)}</div>'


def _table(headers: Sequence[str], rows: Iterable[Sequence[str]]) -> str:
    head = "".join(f"<th>{html.escape(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in row) + "</tr>"
        for row in rows
    )
    return f"<table><tr>{head}</tr>{body}</table>"


def _html_document(result: TrackAnalysisResult, plot_refs: Sequence[str]) -> str:
    beat, loud, harm, st = result.beat, result.loudness, result.harmonic, result.stereo

    tiles = "".join(
        (
            _tile("BPM", f"{beat.bpm:.2f}", f"confidence {beat.confidence:.2f}"),
            _tile(
                "Key",
                harm.primary_key.key,
                f"2nd: {harm.secondary_key.key} ({harm.secondary_key.confidence:.2f})",
            ),
            _tile("Integrated", f"{loud.integrated_lufs:.1f} LUFS", f"LRA {loud.loudness_range:.1f} LU"),
            _tile("True peak", f"{loud.true_peak_dbfs:.2f} dBTP", f"RMS {loud.rms_dbfs:.1f} dBFS"),
            _tile("Stereo corr.", f"{st.correlation:.2f}", f"M {st.mid_rms:.3f} / S {st.side_rms:.3f}"),
        )
    )

    sections = _table(
        ("Label", "Category", "Start (s)", "End (s)", "Confidence"),
        (
            (seg.label, seg.category, f"{seg.start:.2f}", f"{seg.end:.2f}", f"{seg.confidence:.2f}")
            for seg in result.structure.segments
        ),
    )
    widths = _table(
        ("Band", "Width"),
        (
            ("Low", f"{st.width.low:.3f}"),
            ("Mid", f"{st.width.mid:.3f}"),
            ("High", f"{st.width.high:.3f}"),
        ),
    )
    features = _table(
        ("Feature", "Mean", "Median"),
        (
            (
                "Spectral centroid (Hz)",
                f"{result.features.spectral_centroid.mean:.1f}",
                f"{result.features.spectral_centroid.median:.1f}",
            ),
            (
                "Spectral roll-off (Hz)",
                f"{result.features.spectral_rolloff.mean:.1f}",
                f"{result.features.spectral_rolloff.median:.1f}",
            ),
        ),
    )
    downbeats = (
        f"{len(result.downbeat.downbeat_times)} downbeats (source: {result.downbeat.source})"
        if result.downbeat
        else "no downbeat data"
    )
    tracked = result.beat.tracked_times or ()
    if tracked:
        downbeats += f" · {len(tracked)} tracked beats (drift-following)"
    plots = "".join(
        f'<img class="plot" src="{html.escape(name)}" alt="{html.escape(name)}"/>'
        for name in plot_refs
    )
    source = result.audio.path or "in-memory audio"

    body = [
        "<h1>Track analysis</h1>",
        f'<p class="sub">{html.escape(str(source))} · {result.audio.duration:.2f} s @ '
        f"{result.audio.sample_rate} Hz · {html.escape(downbeats)}</p>",
        f'<div class="tiles">{tiles}</div>',
        "<h2>Structure</h2>", sections,
        "<h2>Spectral features</h2>", features,
        "<h2>Stereo width</h2>", widths,
    ]
    if plots:
        body += ["<h2>Plots</h2>", plots]

    return (
        "<!doctype html><html><head><meta charset='utf-8'/>"
        "<title>Track analysis</title>"
        f"<style>{_CSS}</style></head><body><main>"
        + "".join(body)
        + "</main></body></html>"
    )


def _write_midi(suggestion: Optional[object], path: Path) -> None:
    if suggestion is None or len(suggestion.notes["start"]) == 0:
        return
    write_midi(suggestion.notes, path)
