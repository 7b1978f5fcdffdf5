"""Dependency-free standard MIDI file writer.

A type-1 SMF with one track, a 120 BPM set_tempo meta event, and
delta-encoded note on/off pairs at 480 ticks per beat: byte for byte what
the JAX package's writer gives for the same notes. The note table is the
port's ``dict[str, np.ndarray]`` (columns start, duration, pitch,
velocity), not a ``pd.DataFrame``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["write_midi", "encode_var_len"]

TICKS_PER_BEAT = 480
_TEMPO_USEC = 500_000  # 120 BPM


def encode_var_len(value: int) -> bytes:
    """Encode ``value`` as a MIDI variable-length quantity."""

    if value < 0:
        raise ValueError("delta times must be non-negative")
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(chunks))


def _note_events(notes: Dict[str, np.ndarray]) -> List[Tuple[float, bool, int, int]]:
    """Time-sorted (time_beats, is_note_on, pitch, velocity) events."""

    events: List[Tuple[float, bool, int, int]] = []
    for start, duration, pitch, velocity in zip(
        notes["start"], notes["duration"], notes["pitch"], notes["velocity"]
    ):
        start = float(start)
        events.append((start, True, int(pitch), int(velocity)))
        events.append((start + float(duration), False, int(pitch), 0))
    events.sort(key=lambda item: item[0])
    return events


def write_midi(notes: Dict[str, np.ndarray], path: "str | Path") -> None:
    """Write the note table (columns start/duration/pitch/velocity) to SMF."""

    track = bytearray()
    # set_tempo meta event at t=0
    track += b"\x00\xff\x51\x03" + _TEMPO_USEC.to_bytes(3, "big")

    last_tick = 0
    for time_beats, note_on, pitch, velocity in _note_events(notes):
        tick = int(round(time_beats * TICKS_PER_BEAT))
        delta = max(0, tick - last_tick)
        last_tick = tick
        status = 0x90 if note_on else 0x80
        track += encode_var_len(delta)
        track += bytes([status, pitch & 0x7F, velocity & 0x7F])

    track += b"\x00\xff\x2f\x00"  # end of track

    header = (
        b"MThd"
        + (6).to_bytes(4, "big")
        + (1).to_bytes(2, "big")  # format 1
        + (1).to_bytes(2, "big")  # one track
        + TICKS_PER_BEAT.to_bytes(2, "big")
    )
    track_chunk = b"MTrk" + len(track).to_bytes(4, "big") + bytes(track)
    Path(path).write_bytes(header + track_chunk)
