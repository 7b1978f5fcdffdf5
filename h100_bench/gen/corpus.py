"""One deployment's audio corpus, drawn from a seed and written as WAVs.

A configuration's ``corpus`` block names the tracks by recipe and
duration; the seed draws only what varies within that fixed set (which
tempo and key each track gets, and the second engine's own seeds), so
every seed asks the program for the same amount of audio of the same
kinds. Tracks render in a pool of spawned processes, one a spare core (the
second engine's many small numpy calls would hold one interpreter's
lock), and each worker writes its file as 16-bit PCM WAV, the format the
configuration states.
"""

from __future__ import annotations

import multiprocessing
import os
import struct
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

from . import engine, recipes


@dataclass(frozen=True)
class Track:
    """One file of the corpus."""

    index: int
    path: str
    recipe: str
    seconds: float
    sample_rate: int
    channels: int
    frames: int


@dataclass(frozen=True)
class _Plan:
    recipe: str
    seconds: float
    bpm: float
    transpose: int
    seed: int


def plan(corpus: dict, seed: int) -> List[_Plan]:
    """The tracks of ``corpus`` for ``seed``: for each entry of
    ``tracks`` (recipe, seconds, count), ``count`` tracks. The tempi of
    the recipe tracks are ``tempos_bpm`` dealt from a deck shuffled by
    the seed (a fresh shuffle when it runs out, so each tempo is used
    equally often), keys a seeded draw from ``transposes``, and the
    engine's songs (recipe ``engine``) get seeds of their own, with
    tempo, meter and key drawn inside."""

    rng = np.random.default_rng(seed)
    deck: list = []
    out: List[_Plan] = []
    for entry in corpus["tracks"]:
        for _ in range(int(entry.get("count", 1))):
            bpm = 0.0
            if entry["recipe"] != "engine":
                if not deck:
                    deck = [float(b) for b in rng.permutation(corpus["tempos_bpm"])]
                bpm = deck.pop()
            out.append(_Plan(
                recipe=entry["recipe"],
                seconds=float(entry["seconds"]),
                bpm=bpm,
                transpose=int(rng.choice(corpus["transposes"])),
                seed=int(rng.integers(0, 2**31)),
            ))
    return out


def render(p: _Plan, sample_rate: int, channels: int) -> np.ndarray:
    """(channels, n) float32 samples of one planned track."""

    if p.recipe == "engine":
        x = engine.render_random_song(p.seed, sample_rate, p.seconds)[None, :]
    else:
        x = recipes.RECIPES[p.recipe](p.seconds, sample_rate, p.bpm, p.transpose, np.random.default_rng(p.seed))
    if channels == 1 and x.shape[0] == 2:
        x = x.mean(axis=0, keepdims=True)
    return x


def write_wav(path: Path, x: np.ndarray, sample_rate: int) -> None:
    """16-bit PCM WAV of channel-major float samples in [-1, 1) (full scale
    32 768, the convention of the program's decoder)."""

    pcm = np.clip(np.rint(x.T * 32768.0), -32768, 32767).astype("<i2")
    channels = x.shape[0]
    data = pcm.tobytes()
    header = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, sample_rate * channels * 2, channels * 2, 16)
    header += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(data)
        # On disk before the window opens: write-back of the corpus must
        # not share the measured window with the program.
        fh.flush()
        os.fsync(fh.fileno())


def _write_one(i: int, p: _Plan, name: str, sr: int, channels: int, out_dir: str) -> Track:
    x = render(p, sr, channels)
    path = Path(out_dir) / f"{name}_{i:03d}.wav"
    write_wav(path, x, sr)
    return Track(i, str(path), p.recipe, p.seconds, sr, channels, x.shape[1])


def build(config: dict, seed: int, out_dir: Path, workers: "int | None" = None) -> List[Track]:
    """Render and write the corpus of ``config`` for ``seed`` into
    ``out_dir``; returns its tracks in plan order."""

    fmt = config["format"]
    sr, channels = int(fmt["sample_rate"]), int(fmt["channels"])
    plans = plan(config["corpus"], seed)
    # Two cores stay with the main process, which imports torch and the
    # program meanwhile.
    workers = workers or max(1, min(len(plans), (os.cpu_count() or 1) - 2, 8))
    with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_write_one, i, p, config["name"], sr, channels, str(out_dir)) for i, p in enumerate(plans)]
        return [f.result() for f in futures]
