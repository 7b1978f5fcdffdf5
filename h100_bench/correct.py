"""The comparison that decides ``correct``: a served result against the
plain reference's answer for the same file, field by field.

The reference's answer is a nested dict under the result's field names
(``reference.analyse``); each of its leaves is read from the served
result by the same path, so the served result may carry more fields than
are compared. ``KINDS`` says how a leaf is compared:

- ``value`` (the default): the largest gap as a share of the reference's
  scale (an array's largest magnitude, so a list of beat times is read
  against the last beat's time; a scalar's magnitude, at least 1); a
  list of another length reads 1;
- ``half``: a curve the device ships at float16, by its largest gap in
  steps of that format at the reference's value (rounding on either side
  of one step reads 1).

``gaps`` returns the worst of each kind for one pair; ``Numbers`` folds
them over a run and holds them against the configuration's limits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# Curves the device ships at float16; every other field is a "value".
# (Importing nothing of the reference keeps torch out of the harness's
# import, so the corpus renders while torch loads.)
KINDS = {
    "structure.novelty_curve": "half",
    "features.spectral_centroid.values": "half",
}

NUMBERS = ("value_gap", "half_steps")
_OF_KIND = {"value": "value_gap", "half": "half_steps"}
# what a leaf of another shape reads, in each number's unit
_MISSHAPEN = {"value_gap": 1.0, "half_steps": 1e9}


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


def _gap(kind: str, got, ref) -> float:
    a = np.asarray(got, dtype=np.float64)
    b = np.asarray(ref, dtype=np.float64)
    if a.shape != b.shape:
        return _MISSHAPEN[_OF_KIND[kind]]
    if b.size == 0:
        return 0.0
    gap = np.abs(a - b)
    if not np.all(np.isfinite(gap)):
        return 1e9
    if kind == "half":
        step = np.spacing(np.abs(b).astype(np.float16)).astype(np.float64)
        return float((gap / step).max())
    scale = float(np.abs(b).max()) if b.ndim else max(abs(float(b)), 1.0)
    return float(gap.max() / scale) if scale > 0 else float(gap.max())


def field_gaps(got, ref: dict) -> Dict[str, Tuple[str, float]]:
    """{field: (number, gap)} for every compared field."""

    out = {}
    for where, g, r in _leaves(ref, got):
        kind = KINDS.get(where, "value")
        out[where] = (_OF_KIND[kind], _gap(kind, g, r))
    return out


def gaps(got, ref: dict) -> Dict[str, Tuple[float, str]]:
    """The worst gap of each number between the served ``got`` and the
    reference's ``ref``, each with the field where it lies."""

    worst = {k: (0.0, "") for k in NUMBERS}
    for where, (number, value) in field_gaps(got, ref).items():
        if value > worst[number][0] or not worst[number][1]:
            worst[number] = (value, where)
    return worst


@dataclasses.dataclass
class Numbers:
    """The compared numbers over a run: each the worst over every served
    result, with the field and the source where it lies."""

    worst: Dict[str, Tuple[float, str]] = dataclasses.field(
        default_factory=lambda: {k: (0.0, "") for k in NUMBERS}
    )
    compared: int = 0

    def add(self, got, ref: dict, label: str) -> None:
        self.compared += 1
        for key, (value, where) in gaps(got, ref).items():
            if value > self.worst[key][0] or not self.worst[key][1]:
                self.worst[key] = (value, f"{label}: {where}")

    def verdict(self, limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
        """(every number within its limit, {name: {value, limit}})."""

        table = {k: {"value": self.worst[k][0], "limit": float(limits[k])} for k in NUMBERS}
        return all(v["value"] <= v["limit"] for v in table.values()), table

    def where(self, key: str) -> Optional[str]:
        return self.worst[key][1] or None
