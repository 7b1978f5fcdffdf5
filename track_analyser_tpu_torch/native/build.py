"""Build the native host libraries at first use.

Two libraries, as the JAX package builds them:

- ``libta_native``: ``src/decoder.cpp``, ``src/transport.cpp`` and
  ``src/flac.cpp`` (WAV and FLAC decode, the transport quantisers). The
  port needs it: without a C++ compiler, or when the build fails,
  ``build_native`` raises with the compiler's log.
- ``libta_ffmpeg``: ``src/ffmpeg.cpp`` linked against libavformat,
  libavcodec, libavutil and libswresample, the decode ladder's catch-all
  tier. It is absent only where the libav* headers or libraries are
  (``ffmpeg_absent_reason``); with both present a failed build raises.

Both compile with the system C++ compiler (``g++``, else ``clang++``;
never ``nvcc``: this is host code) into ``build/torch_kernels/`` through
``ops/cuda_build.build_library``, named by a hash of the sources, the
flags and the host CPU (``-march=native`` code runs only on a CPU like
the one that built it). Nothing builds at import time.
"""

from __future__ import annotations

import ctypes.util
import functools
import shutil
import subprocess
from pathlib import Path
from typing import Optional

from ..ops import cuda_build

__all__ = ["SRC", "FLAGS", "cxx", "build_native", "build_ffmpeg", "ffmpeg_absent_reason"]

SRC = Path(__file__).resolve().parent / "src"
NATIVE_SOURCES = ("decoder.cpp", "transport.cpp", "flac.cpp")
FFMPEG_SOURCE = "ffmpeg.cpp"
FFMPEG_LIBS = ("avformat", "avcodec", "avutil", "swresample")
# The JAX package's flags, exactly. -ffp-contract=off keeps the ms6/ms5
# error-feedback chain a multiply then an add, bit for bit the numpy
# quantiser's float32 law; -fno-math-errno and -fno-trapping-math let
# nearbyintf vectorise without relaxing any arithmetic.
FLAGS = (
    "-O3", "-march=native", "-ffp-contract=off", "-fno-math-errno", "-fno-trapping-math",
    "-shared", "-fPIC", "-std=c++17",
)


def cxx() -> str:
    """The system C++ compiler; raises when there is none."""

    found = shutil.which("g++") or shutil.which("clang++")
    if found is None:
        raise RuntimeError(
            "no C++ compiler (g++ or clang++) on PATH: the port's native host library "
            "(WAV/FLAC decode and the transport quantisers) cannot be built"
        )
    return found


def _host_cpu() -> str:
    """The CPU's model name and feature flags, part of each library's
    name: ``-march=native`` code from one CPU may not run on another."""

    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return ""
    keep = {}
    for line in lines:
        key, _, value = line.partition(":")
        key = key.strip()
        if key in ("model name", "flags", "Features") and key not in keep:
            keep[key] = value.strip()
    return "\n".join(f"{k}: {v}" for k, v in sorted(keep.items()))


def build_native() -> "tuple[Path, str]":
    """Build ``libta_native`` unless it is built. Returns (library path,
    compiler log; "" if cached); raises with the log when it fails."""

    return cuda_build.build_library(
        "ta_native", [SRC / s for s in NATIVE_SOURCES], cxx, FLAGS, key=_host_cpu()
    )


@functools.cache
def ffmpeg_absent_reason() -> Optional[str]:
    """Why the ffmpeg tier cannot be built here, or None when the libav*
    libraries and a compiler that finds ``<libavformat/avformat.h>`` are
    present. Probed once per process (a preprocessor run)."""

    return _probe_ffmpeg()


def _probe_ffmpeg() -> Optional[str]:
    missing = [name for name in FFMPEG_LIBS if ctypes.util.find_library(name) is None]
    if missing:
        return "no system " + ", ".join(f"lib{name}" for name in missing)
    proc = subprocess.run(
        [cxx(), "-E", "-x", "c++", "-", "-o", "/dev/null"],
        input="#include <libavformat/avformat.h>\n", capture_output=True, text=True,
    )
    if proc.returncode != 0:
        return "the libav* development headers are absent (<libavformat/avformat.h> not found)"
    return None


def build_ffmpeg() -> "tuple[Path, str]":
    """Build ``libta_ffmpeg`` unless it is built. Call only where
    ``ffmpeg_absent_reason()`` is None; raises with the log when it fails."""

    return cuda_build.build_library(
        "ta_ffmpeg", [SRC / FFMPEG_SOURCE], cxx, FLAGS,
        link=tuple(f"-l{name}" for name in FFMPEG_LIBS), key=_host_cpu(),
    )
