"""The comparison that decides ``correct``: what a served call produced
against plain references' answers for the same file, leaf by leaf.

A reference's answer is a nested dict of leaves. Every configuration has
the analysis reference (``ANALYSIS``, ``reference.analyse``), which
answers under the result's field names; each of its leaves is read from
the served result by the same path, so the served result may carry more
fields than are compared. A configuration may name more references
(``"references": [name, ...]``, each a module ``reference/<name>.py``
that ``spec.Spec.reference`` loads), each giving:

- ``analyse(path, *, device, control) -> dict``: its answer for one
  source file, computed from the file alone (``control``: in the
  precision control's precision);
- ``served(result, *, source_path, run_dir) -> dict``: the same leaves,
  read from what the served call produced: its result and the files it
  wrote under ``run_dir``, the directory that call ran in;
- ``LEAVES``: {leaf, or a group of leaves by its path: number}, naming
  every leaf of its answer (a leaf it does not name stops the run at the
  comparison; only the analysis falls back to ``value_gap``);
- ``NUMBERS``: {number: gap(got, ref) -> float} for each number it adds.

A number is the worst gap over the run's leaves of that number, held
against the configuration's ``limits``. The analysis has two:

- ``value_gap`` (the default): the largest gap as a share of the
  reference's scale (an array's largest magnitude, so a list of beat
  times is read against the last beat's time; a scalar's magnitude, at
  least 1); a list of another length reads 1;
- ``half_steps``: a curve the device ships at float16, by its largest gap
  in steps of that format at the reference's value (rounding on either
  side of one step reads 1).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _arrays(got, ref):
    return np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)


def value_gap(got, ref) -> float:
    a, b = _arrays(got, ref)
    if a.shape != b.shape:
        return 1.0
    if b.size == 0:
        return 0.0
    gap = np.abs(a - b)
    if not np.all(np.isfinite(gap)):
        return 1e9
    scale = float(np.abs(b).max()) if b.ndim else max(abs(float(b)), 1.0)
    return float(gap.max() / scale) if scale > 0 else float(gap.max())


def half_steps(got, ref) -> float:
    a, b = _arrays(got, ref)
    if a.shape != b.shape:
        return 1e9
    if b.size == 0:
        return 0.0
    gap = np.abs(a - b)
    if not np.all(np.isfinite(gap)):
        return 1e9
    step = np.spacing(np.abs(b).astype(np.float16)).astype(np.float64)
    return float((gap / step).max())


GAPS: Dict[str, Callable] = {"value_gap": value_gap, "half_steps": half_steps}


def _analysis_answer(path: str, *, device: str, control: bool) -> dict:
    # Imported when first asked: keeps torch out of the harness's import,
    # so the corpus renders while torch loads.
    from .reference import analyse

    return analyse(path, device=device, control=control)


@dataclasses.dataclass(frozen=True)
class Reference:
    """One plain reference: its answer for a source file, the same leaves
    read from a served call, and the number each leaf is compared by."""

    name: str
    analyse: Callable[..., dict]
    served: Callable[..., object]
    leaves: Dict[str, str]
    # every number it compares by, in order, with its gap function
    gaps: Dict[str, Callable]
    # the number of a leaf that ``leaves`` does not name; None: no such leaf
    default: Optional[str] = None

    @property
    def numbers(self) -> Tuple[str, ...]:
        return tuple(self.gaps)

    def number_of(self, leaf: str) -> str:
        for key, number in self.leaves.items():
            if leaf == key or leaf.startswith(key + "."):
                return number
        if self.default is None:
            raise ValueError(f"reference {self.name!r} names no number for its leaf {leaf!r} in LEAVES")
        return self.default

    @classmethod
    def of_module(cls, name: str, module) -> "Reference":
        """The reference a module ``reference/<name>.py`` gives; raises
        ValueError where it lacks a part, names no leaf, or a number has
        no gap."""

        for part in ("analyse", "served"):
            if not callable(getattr(module, part, None)):
                raise ValueError(f"reference {name!r} gives no function {part!r}")
        leaves = dict(getattr(module, "LEAVES", {}))
        if not leaves:
            raise ValueError(f"reference {name!r} names no leaf in LEAVES")
        added = dict(getattr(module, "NUMBERS", {}))
        clash = sorted(set(added) & set(GAPS))
        if clash:
            raise ValueError(f"reference {name!r} redefines {clash}")
        gaps: Dict[str, Callable] = {}
        for number in leaves.values():
            gap = added.get(number, GAPS.get(number))
            if not NAME.fullmatch(number) or not callable(gap):
                raise ValueError(f"reference {name!r}: number {number!r} is not a name with a gap function")
            gaps[number] = gap
        return cls(name, module.analyse, module.served, leaves, gaps)


ANALYSIS = Reference(
    name="analysis",
    analyse=_analysis_answer,
    served=lambda result, **_: result,
    # the curves the device ships at float16; every other field is a value
    leaves={"structure.novelty_curve": "half_steps", "features.spectral_centroid.values": "half_steps"},
    gaps=dict(GAPS),
    default="value_gap",
)


def numbers_of(references: Sequence[Reference]) -> List[str]:
    """Every number the references compare by, in order, each once."""

    return list(dict.fromkeys(n for r in references for n in r.numbers))


def require_limits(numbers: Iterable[str], limits: Dict[str, float]) -> None:
    """Raises ValueError where one of ``numbers`` has no limit."""

    missing = [n for n in numbers if n not in limits]
    if missing:
        raise ValueError(f"no limit for {missing} in the configuration's limits")


def _read(obj, key: str):
    return obj[key] if isinstance(obj, dict) else getattr(obj, key)


def _leaves(ref: dict, got, path: str = ""):
    for key, r in ref.items():
        where = f"{path}.{key}" if path else key
        g = _read(got, key)
        if isinstance(r, dict):
            yield from _leaves(r, g, where)
        else:
            yield where, g, r


def field_gaps(got, ref: dict, reference: Reference = ANALYSIS) -> Dict[str, Tuple[str, float]]:
    """{leaf: (number, gap)} for every leaf of the reference's ``ref``."""

    out = {}
    for where, g, r in _leaves(ref, got):
        number = reference.number_of(where)
        out[where] = (number, float(reference.gaps[number](g, r)))
    return out


class Numbers:
    """The compared numbers over a run: each the worst over every served
    result, with the leaf and the source where it lies, by reference and
    over them all."""

    def __init__(self, references: Iterable[Reference] = (ANALYSIS,)):
        references = list(references)
        self._numbers = numbers_of(references)
        # {reference: {number: (its worst gap, where it lies)}}
        self.by_reference: Dict[str, Dict[str, Tuple[float, str]]] = {
            r.name: {n: (0.0, "") for n in r.numbers} for r in references}
        # {reference: {leaf: [its number, its worst gap, the result where it lies]}}
        self.fields: Dict[str, Dict[str, list]] = {r.name: {} for r in references}
        self._labels: set = set()

    @property
    def compared(self) -> int:
        """How many results were compared."""

        return len(self._labels)

    @property
    def worst(self) -> Dict[str, Tuple[float, str]]:
        """{number: (its worst gap over every reference, where it lies)}."""

        return {n: max((w[n] for w in self.by_reference.values() if n in w), key=lambda v: (v[0], bool(v[1])))
                for n in self._numbers}

    def _fold(self, reference: str, number: str, value: float, where: str) -> None:
        mine = self.by_reference[reference]
        worst, at = mine[number]
        if value > worst or not at:
            mine[number] = (value, where)

    def add(self, got, ref: dict, label: str, reference: Reference = ANALYSIS) -> None:
        self._labels.add(label)
        fields = self.fields[reference.name]
        for where, (number, value) in field_gaps(got, ref, reference).items():
            row = fields.setdefault(where, [number, value, label])
            if value > row[1]:
                row[1:] = [value, label]
            self._fold(reference.name, number, value, f"{label}: {where}")

    def unread(self, label: str, reference: Reference, why: str) -> None:
        """A served call whose leaves could not be read: every number of
        the reference reads as failed there."""

        self._labels.add(label)
        for number in reference.numbers:
            self._fold(reference.name, number, 1e9, f"{label}: {reference.name} unread ({why})")

    def verdict(self, limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
        """(every number within its limit, {name: {value, limit}})."""

        require_limits(self.worst, limits)
        table = {k: {"value": v, "limit": float(limits[k])} for k, (v, _) in self.worst.items()}
        return all(v["value"] <= v["limit"] for v in table.values()), table

    def where(self, key: str) -> Optional[str]:
        return self.worst[key][1] or None
