"""A fixture reference for the CPU tests of configurations that bring
their own references: a property that every correct stem separation
has, not the separator's values. Each of the four stems is written as a
16-bit WAV under the calls' working directory, with the source's
channels and frames, and its samples are finite and not all zero.

The tests copy it to ``reference/written_stems.py`` of a copy of the
benchmark, as a later configuration would add its own reference.
"""

from pathlib import Path

import numpy as np

from h100_bench.reference.audio import read_wav

STEMS = ("drums", "bass", "other", "vocals")


def stem_mismatch(got, ref) -> float:
    """0 where the written stem has every property the reference states, else 1."""

    return 0.0 if int(got) == int(ref) else 1.0


LEAVES = {"stems": "stem_mismatch"}
NUMBERS = {"stem_mismatch": stem_mismatch}


def analyse(path, *, device, control):
    x, _ = read_wav(path)
    one = {"channels": x.shape[0], "frames": x.shape[1], "sound": 1, "in_run_dir": 1}
    return {"stems": {name: dict(one) for name in STEMS}}


def served(result, *, source_path, run_dir):
    out = {}
    for name in STEMS:
        path = Path(result.stems.stems[name])
        x, _ = read_wav(path)
        out[name] = {
            "channels": x.shape[0],
            "frames": x.shape[1],
            "sound": int(bool(np.all(np.isfinite(x)) and np.any(x != 0))),
            "in_run_dir": int(path.resolve().is_relative_to(Path(run_dir).resolve())),
        }
    return {"stems": out}
