"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` (named by a hash of the source and the flags, so
an edited source builds anew) and loaded with ``ctypes``. Nothing here
runs at import time; a host without ``nvcc`` raises when a kernel is
first needed. ``build_library`` is the same scheme for any compiler: the
native host library (``native/build.py``) builds through it with the
system C++ compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Sequence

__all__ = [
    "CSRC", "SOURCES", "nvcc", "build", "build_text", "build_all", "load",
    "build_library",
]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = ("median31.cu", "stft_mag.cu")
_loaded: dict = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""

    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _compile_library(
    command: "Sequence[str]", sources: "Sequence[Path]", lib_path: Path, link: "Sequence[str]" = ()
) -> str:
    """Run ``command -o <tmp> sources link`` and rename the output to
    ``lib_path``: a half-written library is never loaded, and several
    processes building at once (test workers) do not collide. Raises with
    the compiler's log on failure; returns the log."""

    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*command, "-o", str(tmp), *(str(s) for s in sources), *link]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        names = " ".join(Path(s).name for s in sources)
        raise RuntimeError(
            f"{Path(command[0]).name} {names} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return proc.stdout + proc.stderr


def build_library(
    stem: str,
    sources: "Sequence[Path]",
    compiler: "Callable[[], str]",
    flags: "Sequence[str]",
    link: "Sequence[str]" = (),
    key: str = "",
) -> tuple[Path, str]:
    """Compile ``sources`` with ``compiler()`` and ``flags`` into
    ``build/torch_kernels/lib<stem>_<hash>.so`` unless it exists, the hash
    taken over the sources' bytes, the flags, ``link`` and ``key`` (what
    else the build depends on); the compiler is looked up only to build.
    Returns (library path, compiler log; "" if cached)."""

    digest = hashlib.sha256()
    for src in sources:
        digest.update(Path(src).read_bytes())
    digest.update("\0".join([*flags, *link, key]).encode())
    lib_path = _BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, ""
    return lib_path, _compile_library([compiler(), *flags], sources, lib_path, link)


def _compile(src: Path, lib_path: Path) -> str:
    """nvcc ``src`` into ``lib_path``. Returns the log."""

    return _compile_library([nvcc(), *_NVCC_FLAGS], [src], lib_path)


def build(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless a library of this exact source
    and these flags already exists. Returns (library path, compiler log;
    "" if cached)."""

    return build_library(Path(source).stem, [CSRC / source], nvcc, _NVCC_FLAGS)


def build_text(stem: str, text: str) -> tuple[Path, str]:
    """Compile CUDA source ``text`` (``profile_stft`` builds edited copies
    of a kernel this way): the text is written to
    ``build/torch_kernels/<stem>_<hash>.cu`` and compiled unless its library
    already exists. Returns (library path, compiler log; "" if cached)."""

    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"lib{stem}_{digest}.so"
    if lib_path.exists():
        return lib_path, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _BUILD_DIR / f"{stem}_{digest}.cu"
    src.write_text(text)
    return lib_path, _compile(src, lib_path)


def build_all(sources: "tuple[str, ...]" = SOURCES) -> "dict[str, tuple[Path, str]]":
    """Build every source in ``sources`` at once, one ``nvcc`` process
    each, all started together. Returns {source: (library path, log)};
    raises if any build fails."""

    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        futures = {source: pool.submit(build, source) for source in sources}
        return {source: future.result() for source, future in futures.items()}


def load(source: str, symbol: str, argtypes: list) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, with ``symbol`` bound to
    ``argtypes`` and an int return (the kernel's cudaGetLastError)."""

    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib_path, _log = build(source)
            lib = ctypes.CDLL(str(lib_path))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[source] = lib
    return lib
