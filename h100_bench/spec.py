"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration, whose ``file`` holds
its corpus, format and limits, and a traffic mix, read from
``h100_bench/traffic/<traffic>.json``. Every metric, end-to-end or
per-layer, is read by ``h100_bench/metrics/<name>.py``, a module with one
function ``read(ctx)`` that returns a number or None. A configuration
may name plain references of its own (``"references"``), each read from
``h100_bench/reference/<name>.py`` (``correct`` says what such a module
gives). A later cell, metric or reference is therefore added by adding
files and entries, never by editing one that is here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import correct

BENCH_DIR = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    end_to_end: bool
    workloads: Optional[List[str]]

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]


class Spec:
    """The benchmark as ``BENCHMARK.json`` at ``root`` states it; ``bench_dir``
    is where its configurations, traffic and metric readers lie."""

    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.metrics = [
            Metric(m["name"], m["unit"], kind == "end_to_end", m.get("workloads"))
            for kind in ("end_to_end", "per_layer")
            for m in self.data[kind]
        ]

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.data["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in self.data["configs"] if c["name"] == entry["config"])
        config = json.loads((self.root / conf["file"]).read_text())
        traffic = json.loads((self.bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())
        mine = [m for m in self.metrics if m.applies_to(name)]
        return Cell(
            name=name,
            config=config,
            traffic=traffic,
            chips=int(entry["chips"]),
            end_to_end=[m for m in mine if m.end_to_end],
            per_layer=[m for m in mine if not m.end_to_end],
        )

    def reader(self, metric: Metric) -> Callable:
        """``read(ctx)`` of ``metrics/<name>.py``."""

        path = self.bench_dir / "metrics" / f"{metric.name}.py"
        spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{metric.name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def references(self, cell: Cell) -> List[correct.Reference]:
        """The analysis reference, then each that the cell's configuration
        names, loaded; raises where one is missing or does not load, or a
        number they compare by has no limit in the configuration."""

        refs = [correct.ANALYSIS] + [self.reference(name) for name in cell.config.get("references", [])]
        correct.require_limits(correct.numbers_of(refs), cell.config["limits"])
        return refs

    def reference(self, name: str) -> correct.Reference:
        """The module ``reference/<name>.py``, loaded as a submodule of the
        reference package, so that its relative imports find the
        package's own modules; ``sys.modules`` is left as it was."""

        path = self.bench_dir / "reference" / f"{name}.py"
        if not name.isidentifier() or not path.is_file():
            raise FileNotFoundError(f"the configuration names reference {name!r}: there is no {path}")
        qualified = f"{__package__}.reference.{name}"
        spec = importlib.util.spec_from_file_location(qualified, path)
        module = importlib.util.module_from_spec(spec)
        held = sys.modules.get(qualified)
        sys.modules[qualified] = module  # while it runs: dataclasses look their module up
        try:
            spec.loader.exec_module(module)
        except Exception as e:
            raise ImportError(f"reference {name!r} ({path}) does not load: {e!r}") from e
        finally:
            if held is None:
                sys.modules.pop(qualified, None)
            else:
                sys.modules[qualified] = held
        return correct.Reference.of_module(name, module)


def read_metrics(spec: Spec, metrics: List[Metric], ctx) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader finds
    something to read."""

    out: Dict[str, dict] = {}
    for m in metrics:
        value = spec.reader(m)(ctx)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
