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

``python -m track_analyser_tpu_torch.native.build`` builds both now: it
exits 0 when ``libta_native`` builds, 1 with the compiler's log when it
does not, and prints whether ``libta_ffmpeg`` is built or absent, and
why (a failed ffmpeg build is reported, with the head of its log, and
does not change the exit code).
"""

from __future__ import annotations

import argparse
import ctypes.util
import functools
import shutil
import subprocess
import sys
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


def main(argv: "list[str] | None" = None) -> int:
    argparse.ArgumentParser(
        prog="python -m track_analyser_tpu_torch.native.build",
        description="Build the native host libraries into build/torch_kernels/.",
    ).parse_args(argv)
    try:
        path, _log = build_native()
    except RuntimeError as exc:  # no compiler, or a failed build: the message holds the log
        print(f"build failed: {exc}", file=sys.stderr)
        return 1
    print(f"libta_native: built ({path})")
    reason = ffmpeg_absent_reason()
    if reason is None:
        try:  # the decode ladder's last tier: best effort, as in the JAX package
            path, _log = build_ffmpeg()
        except RuntimeError as exc:
            reason = f"build failed: {str(exc).strip()[:500]}"
    if reason is None:
        print(f"libta_ffmpeg: built ({path})")
    else:
        print(f"libta_ffmpeg: absent ({reason})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
