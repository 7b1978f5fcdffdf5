"""Persisting analysis artefacts: report.json, CSV tables, PNG plots.

Counterpart of the JAX package's ``report.py``, with the same JSON keys
and the same beats.csv / sections.csv columns: those dicts are the
contract. CSVs are written with the stdlib writer, plots through one
shared panel helper with a single palette, the waveform as a per-pixel
min/max envelope, and the tempogram by ``_tempogram_graph`` on the
caller's device.

``matplotlib`` is imported inside ``_write_plots``, never at module
import: a host without it still writes report.json, the CSVs, the HTML
and the MIDI files, and a request for plots raises ``ImportError`` there
(plots are never skipped silently).
"""

from __future__ import annotations

import csv
import json
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from .device import check_nans, resolve_device
from .ops.mel import mel_filterbank, melspectrogram_from_power
from .ops.onset import onset_strength_from_mel, tempogram_prepadded
from .ops.stft import magnitude
from .pipeline import TrackAnalysisResult

__all__ = ["ReportRequest", "ReportOutputs", "generate_report"]


@dataclass(slots=True)
class ReportRequest:
    """Configuration describing which artefacts should be generated."""

    include_json: bool = True
    include_csv: bool = True
    include_plots: bool = True
    json_path: Path | None = None
    csv_dir: Path | None = None
    plots_dir: Path | None = None


@dataclass(slots=True)
class ReportOutputs:
    """Paths to the artefacts produced when generating a report."""

    json: Path | None
    csv: Dict[str, Path]
    plots: Dict[str, Path]


def generate_report(
    result: TrackAnalysisResult,
    output_dir: Path,
    request: ReportRequest | None = None,
    *,
    device: "str | torch.device" = "cuda",
) -> ReportOutputs:
    """Persist a structured analysis report to ``output_dir``. ``device``
    is where the tempogram plot's graph runs; without plots it is not
    touched."""

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    request = request or ReportRequest()

    outputs = ReportOutputs(json=None, csv={}, plots={})
    if request.include_json:
        outputs.json = request.json_path or output_dir / "report.json"
        outputs.json.parent.mkdir(parents=True, exist_ok=True)
        outputs.json.write_text(
            json.dumps(_report_dict(result), indent=2), encoding="utf-8"
        )
    if request.include_csv:
        csv_dir = request.csv_dir or output_dir
        csv_dir.mkdir(parents=True, exist_ok=True)
        outputs.csv = _write_csv_tables(result, csv_dir)
    if request.include_plots:
        plots_dir = request.plots_dir or output_dir
        plots_dir.mkdir(parents=True, exist_ok=True)
        outputs.plots = _write_plots(result, plots_dir, device)
    return outputs


# ---------------------------------------------------------------------------
# JSON: the key set below IS the parity contract
# ---------------------------------------------------------------------------


def _report_dict(result: TrackAnalysisResult) -> dict:
    downbeat = result.downbeat
    harmonic = result.harmonic
    return {
        "audio": {
            "path": result.audio.path,
            "sample_rate": result.audio.sample_rate,
            "duration": result.audio.duration,
        },
        "beat": {
            "bpm": result.beat.bpm,
            "confidence": result.beat.confidence,
            "count": len(result.beat.beat_times),
            # The drift-following DP-tracked beats (tempo.track_beats),
            # beside the constant grid above.
            "tracked": {
                "count": len(result.beat.tracked_times or ()),
                "times": [float(t) for t in (result.beat.tracked_times or ())],
            },
        },
        "downbeat": {
            "source": downbeat.source if downbeat else None,
            "count": len(downbeat.downbeat_times) if downbeat else 0,
        },
        "structure": [
            {
                "label": seg.label,
                "category": seg.category,
                "start": seg.start,
                "end": seg.end,
                "confidence": seg.confidence,
            }
            for seg in result.structure.segments
        ],
        "loudness": {
            "integrated_lufs": result.loudness.integrated_lufs,
            "loudness_range": result.loudness.loudness_range,
            "true_peak_dbfs": result.loudness.true_peak_dbfs,
            "rms_dbfs": result.loudness.rms_dbfs,
        },
        "harmonic": {
            "key": harmonic.primary_key.key,
            "key_confidence": harmonic.primary_key.confidence,
            "secondary_key": {
                "key": harmonic.secondary_key.key,
                "confidence": harmonic.secondary_key.confidence,
            },
            "chord_change_points": [
                {"time": point.time, "strength": point.strength}
                for point in harmonic.chord_change_points
            ],
        },
        "features": {
            "ltas": result.features.ltas.as_dict(),
            "spectral_centroid": {
                "mean": result.features.spectral_centroid.mean,
                "median": result.features.spectral_centroid.median,
            },
            "spectral_rolloff": {
                "mean": result.features.spectral_rolloff.mean,
                "median": result.features.spectral_rolloff.median,
            },
        },
        "stereo": {
            "mid_rms": result.stereo.mid_rms,
            "side_rms": result.stereo.side_rms,
            "correlation": result.stereo.correlation,
            "width": result.stereo.width.as_dict(),
        },
    }


# ---------------------------------------------------------------------------
# CSV: the column sets are the parity contract; written with the stdlib
# csv module.
# ---------------------------------------------------------------------------

_SECTION_COLUMNS = (
    "label",
    "category",
    "start",
    "end",
    "confidence",
    "percussive_energy",
    "harmonic_energy",
    "percussive_ratio",
)


def _write_rows(path: Path, header: Sequence[str], rows) -> None:
    with path.open("w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh)
        writer.writerow(header)
        writer.writerows(rows)


def _write_csv_tables(result: TrackAnalysisResult, output_dir: Path) -> Dict[str, Path]:
    beat_times = np.asarray(result.beat.beat_times, dtype=float)
    beat_frames = np.asarray(result.beat.beat_frames, dtype=int)
    downbeat_times = (
        np.asarray(result.downbeat.downbeat_times, dtype=float)
        if result.downbeat
        else np.zeros(0, dtype=float)
    )
    flags = _flag_downbeats(beat_times, downbeat_times)

    beats_path = output_dir / "beats.csv"
    _write_rows(
        beats_path,
        ("index", "time", "frame", "is_downbeat"),
        (
            (i + 1, float(beat_times[i]), int(beat_frames[i]), bool(flags[i]))
            for i in range(beat_times.size)
        ),
    )

    sections_path = output_dir / "sections.csv"
    _write_rows(
        sections_path,
        _SECTION_COLUMNS,
        (tuple(getattr(seg, col) for col in _SECTION_COLUMNS) for seg in result.structure.segments),
    )
    tables = {"beats": beats_path, "sections": sections_path}

    # The drift-following tracked beats, kept out of beats.csv: its
    # column set is the parity contract and its rows are the constant grid.
    tracked = result.beat.tracked_times
    if tracked:
        tracked_path = output_dir / "tracked_beats.csv"
        _write_rows(
            tracked_path,
            ("index", "time"),
            ((i + 1, float(t)) for i, t in enumerate(tracked)),
        )
        tables["tracked_beats"] = tracked_path
    return tables


def _flag_downbeats(beat_times: np.ndarray, downbeat_times: np.ndarray) -> np.ndarray:
    if beat_times.size == 0:
        return np.zeros(0, dtype=bool)
    if downbeat_times.size == 0:
        return np.zeros_like(beat_times, dtype=bool)
    # np.isclose, not a bare atol: its default rtol=1e-5 adds
    # time-proportional slack (a 12 ms-off model downbeat at t=600 s flags
    # True), as in the JAX package.
    close = np.isclose(beat_times[:, None], downbeat_times[None, :], atol=1e-2)
    return np.any(close, axis=1)


# ---------------------------------------------------------------------------
# Plots — five PNGs through one shared panel helper. Palette: one validated
# categorical pair (blue = data, orange = event markers), a single-hue blue
# sequential ramp for magnitude, neutral chrome tokens for ink/grid/axes.
# ---------------------------------------------------------------------------

_SURFACE = "#fcfcfb"
_INK = "#0b0b0b"
_MUTED = "#898781"
_GRID = "#e1e0d9"
_AXIS = "#c3c2b7"
_DATA = "#2a78d6"  # categorical slot 1 (blue): the measured curve/bars
_EVENT = "#eb6834"  # categorical slot 2 (orange): beat/boundary markers


def _pyplot():
    """matplotlib.pyplot on the Agg backend, imported at first use."""

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


@lru_cache(maxsize=1)
def _seq_cmap():
    """Single-hue sequential ramp (blue 100..700) anchored at the surface
    colour: magnitude reads as ink density, light -> dark."""

    from matplotlib.colors import LinearSegmentedColormap

    return LinearSegmentedColormap.from_list(
        "ta_blue_seq",
        [_SURFACE, "#cde2fb", "#9ec5f4", "#6da7ec", "#3987e5", "#256abf", "#184f95", "#0d366b"],
    )


@contextmanager
def _panel(
    path: Path,
    *,
    title: str,
    xlabel: str,
    ylabel: str,
    size: Tuple[float, float] = (9.0, 3.4),
) -> "Iterator":
    """One styled figure: surface colour, hairline grid, recessive axes."""

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=size, dpi=110)
    fig.patch.set_facecolor(_SURFACE)
    ax.set_facecolor(_SURFACE)
    try:
        yield ax
        ax.set_title(title, color=_INK, fontsize=11, loc="left")
        ax.set_xlabel(xlabel, color=_MUTED, fontsize=9)
        ax.set_ylabel(ylabel, color=_MUTED, fontsize=9)
        ax.tick_params(colors=_MUTED, labelsize=8)
        ax.grid(True, color=_GRID, linewidth=0.6)
        ax.set_axisbelow(True)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        for side in ("left", "bottom"):
            ax.spines[side].set_color(_AXIS)
        if ax.get_legend_handles_labels()[0]:
            ax.legend(
                loc="upper right",
                frameon=False,
                fontsize=8,
                labelcolor=_INK,
            )
        fig.tight_layout()
        fig.savefig(path, facecolor=_SURFACE)
    finally:
        plt.close(fig)


def _write_plots(
    result: TrackAnalysisResult, output_dir: Path, device: "str | torch.device" = "cuda"
) -> Dict[str, Path]:
    """The five PNGs. Raises ImportError on a host without matplotlib."""

    _pyplot()
    dev = resolve_device(device)
    return {
        "waveform_beats": _plot_waveform_beats(result, output_dir),
        "tempogram": _plot_tempogram(result, output_dir, dev),
        "novelty": _plot_novelty(result, output_dir),
        "ltas": _plot_ltas(result, output_dir),
        "stereo_width": _plot_stereo_width(result, output_dir),
    }


def _minmax_envelope(y: np.ndarray, columns: int = 1800):
    """Per-column (lo, hi) of the waveform — the visual a sample-accurate
    plot would produce, at 1/step the render cost."""

    step = max(1, y.size // columns)
    m = (y.size // step) * step
    blocks = y[:m].reshape(-1, step)
    return blocks.min(axis=1), blocks.max(axis=1), step


def _plot_waveform_beats(result: TrackAnalysisResult, output_dir: Path) -> Path:
    path = output_dir / "waveform_beats.png"
    y = np.asarray(result.audio.samples, dtype=float)
    if y.ndim > 1:
        y = y.mean(axis=0)
    with _panel(path, title="Waveform & beat grid", xlabel="Time (s)", ylabel="Amplitude") as ax:
        if y.size:
            lo, hi, step = _minmax_envelope(y)
            t = (np.arange(lo.size) + 0.5) * step / result.audio.sample_rate
            ax.fill_between(t, lo, hi, color=_DATA, linewidth=0.0, label="waveform")
            beats = np.asarray(result.beat.beat_times, dtype=float)
            if beats.size:
                ax.vlines(
                    beats,
                    ymin=float(lo.min()),
                    ymax=float(hi.max()),
                    colors=_EVENT,
                    alpha=0.75,
                    linewidth=1.1,
                    label="beats",
                )
        else:
            ax.annotate("no audio samples", (0.5, 0.5), ha="center", color=_MUTED)
    return path


def _tempogram_graph(y: torch.Tensor, n_valid, *, sr: int, hop_length: int) -> torch.Tensor:
    """Tempogram (384, frames) of a bucket-padded mono signal ``y`` (n,)
    with ``n_valid`` true samples, on ``y``'s device; columns at or beyond
    1 + n_valid // hop_length are padding for the caller to trim.

    The exact-shape tempogram pads the envelope with a linear ramp from its
    LAST VALID value (``ops/onset.tempogram``); hard zeros beyond f_valid
    instead would change the final ~pad columns. So the FULLY padded
    envelope is built by hand, both boundary ramps at their exact-shape
    positions: the right ramp starts at f_valid, not at the bucket end, and
    the extended buffer lets it complete even when the bucket adds fewer
    than win // 2 padding frames."""

    power = magnitude(y, 2048, hop_length, power=2.0)
    fb = mel_filterbank(sr, 2048, 128)
    env = onset_strength_from_mel(
        melspectrogram_from_power(power, fb), n_fft=2048, hop_length=hop_length
    )
    f_valid = 1 + torch.as_tensor(n_valid, device=y.device) // hop_length
    pad = 384 // 2  # tempogram win_length // 2
    fi = torch.arange(env.shape[-1] + 2 * pad, device=y.device) - pad  # envelope-frame index
    last = env[torch.clamp_min(f_valid - 1, 0)]
    left = env[0] * torch.clamp((fi + pad) / pad, 0.0, 1.0)
    right = last * torch.clamp(1.0 - (fi - (f_valid - 1)) / pad, 0.0, 1.0)
    body = torch.nn.functional.pad(env, (pad, pad))
    envp = torch.where(fi < 0, left, torch.where(fi < f_valid, body, right))
    return tempogram_prepadded(envp)


def _plot_tempogram(result: TrackAnalysisResult, output_dir: Path, device: torch.device) -> Path:
    path = output_dir / "tempogram.png"
    y = np.asarray(result.audio.samples, dtype=np.float32)
    if y.ndim > 1:
        y = y.mean(axis=0)
    sr, hop = result.audio.sample_rate, 512
    if y.size:
        # Bucket-padded like every other device graph; padded tempogram
        # columns beyond the valid frames are trimmed here.
        from .substrate import pad_to_bucket

        padded, f_valid = pad_to_bucket(y, hop=hop)
        with torch.inference_mode():
            tgram = check_nans(
                "report._tempogram_graph",
                _tempogram_graph(torch.from_numpy(padded).to(device), y.size, sr=sr, hop_length=hop),
            )[:, :f_valid]
        tgram = tgram.cpu().numpy().astype(float)
    else:
        tgram = np.zeros((2, 1))
    if tgram.shape[0] < 2 or tgram.shape[1] < 1:
        tgram = np.zeros((2, 1))
    with _panel(path, title="Tempogram", xlabel="Time (s)", ylabel="Tempo (BPM)") as ax:
        # Rows are autocorrelation lags; draw in lag space (row 1 up — lag 0
        # is the trivial peak), label the y axis at musically useful BPMs
        # mapped back to their lag rows, and window the view to the
        # 40-250 BPM band (longer lags are sub-musical and would squash
        # the useful range into a sliver).
        body = tgram[1:]
        dur = tgram.shape[1] * hop / sr
        im = ax.imshow(
            body,
            aspect="auto",
            origin="lower",
            extent=(0.0, dur, 1.0, float(tgram.shape[0])),
            cmap=_seq_cmap(),
        )
        lag_of = lambda bpm: 60.0 * sr / (hop * bpm)  # noqa: E731
        lo_lag = max(1.0, lag_of(250.0))
        hi_lag = min(float(tgram.shape[0]), lag_of(40.0))
        if hi_lag > lo_lag:
            ax.set_ylim(hi_lag, lo_lag)  # inverted: faster tempo at the top
        ticks, labels = [], []
        for bpm in (240, 200, 160, 120, 90, 60, 40):
            lag = lag_of(bpm)
            if lo_lag <= lag <= hi_lag:
                ticks.append(lag)
                labels.append(str(bpm))
        if ticks:
            ax.set_yticks(ticks, labels)
        cbar = ax.figure.colorbar(im, ax=ax, pad=0.01)
        cbar.set_label("Onset autocorrelation", color=_MUTED, fontsize=8)
        cbar.ax.tick_params(colors=_MUTED, labelsize=7)
        cbar.outline.set_visible(False)
        ax.grid(False)
    return path


def _plot_novelty(result: TrackAnalysisResult, output_dir: Path) -> Path:
    path = output_dir / "novelty_boundaries.png"
    novelty = np.asarray(result.structure.novelty_curve, dtype=float)
    with _panel(
        path, title="Novelty & structural boundaries", xlabel="Time (s)", ylabel="Novelty"
    ) as ax:
        if novelty.size:
            t = np.linspace(0.0, result.audio.duration, num=novelty.size)
            ax.fill_between(t, 0.0, novelty, color=_DATA, alpha=0.25, linewidth=0.0)
            ax.plot(t, novelty, color=_DATA, linewidth=1.2, label="novelty")
            segs = result.structure.segments
            starts = [seg.start for seg in segs[1:]]  # first starts at 0
            if starts:
                ax.vlines(
                    starts,
                    ymin=0.0,
                    ymax=float(novelty.max() or 1.0),
                    colors=_EVENT,
                    linewidth=1.0,
                    label="boundaries",
                )
            top = float(novelty.max() or 1.0)
            for seg in segs:
                ax.annotate(
                    seg.label,
                    ((seg.start + seg.end) / 2.0, top),
                    ha="center",
                    va="bottom",
                    fontsize=8,
                    color=_MUTED,
                )
        else:
            ax.annotate("no novelty data", (0.5, 0.5), ha="center", color=_MUTED)
    return path


def _plot_ltas(result: TrackAnalysisResult, output_dir: Path) -> Path:
    path = output_dir / "ltas.png"
    freqs = np.asarray(result.features.ltas.frequencies, dtype=float)
    mags = np.asarray(result.features.ltas.magnitude, dtype=float)
    with _panel(
        path,
        title="Long-term average spectrum",
        xlabel="Frequency (Hz)",
        ylabel="Level (dB re max)",
    ) as ax:
        if freqs.size and mags.size:
            keep = freqs >= 20.0  # sub-20 Hz carries no audible programme
            f, m = freqs[keep], mags[keep]
            ref = float(m.max()) or 1.0
            db = 20.0 * np.log10(np.maximum(m, ref * 1e-6) / ref)
            ax.semilogx(f, db, color=_DATA, linewidth=1.4)
            ax.set_ylim(max(-90.0, float(db.min()) - 3.0), 3.0)
        else:
            ax.annotate("no LTAS data", (0.5, 0.5), ha="center", color=_MUTED)
    return path


def _plot_stereo_width(result: TrackAnalysisResult, output_dir: Path) -> Path:
    path = output_dir / "stereo_width.png"
    width = result.stereo.width
    bands = ("Low", "Mid", "High")
    values = (width.low, width.mid, width.high)
    with _panel(
        path,
        title="Stereo width by band",
        xlabel="Side/Mid energy ratio (sqrt)",
        ylabel="",
        size=(6.5, 3.0),
    ) as ax:
        ypos = np.arange(len(bands))
        ax.barh(ypos, values, height=0.55, color=_DATA)
        ax.set_yticks(ypos, bands)
        ax.set_ylim(-0.6, len(bands) - 0.1)
        ax.axvline(1.0, color=_AXIS, linewidth=1.0, linestyle="--")
        ax.annotate(
            "equal M/S", (1.0, len(bands) - 0.28), fontsize=7, color=_MUTED,
            ha="center", va="top",
        )
        ax.set_xlim(0.0, max(1.1, max(values) * 1.15))
        for y, v in zip(ypos, values):
            ax.annotate(f"{v:.2f}", (v, y), xytext=(4, 0), textcoords="offset points",
                        va="center", fontsize=8, color=_INK)
    return path
