"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each library is compiled for Hopper (``sm_90a``) into a shared object with a
plain C interface, under ``layoutdm_tpu_torch/_build/`` (git-ignored), named
by a hash of its sources, the shared headers and the flags: a changed source
builds anew, an unchanged one loads the cached file.  Nothing is downloaded and no PyTorch
header is compiled, so a build takes seconds.  ``compile_cached`` is the
build step itself; the host-side metric engine (``native/``, g++) uses it
too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when a cached build was loaded
    log: str  # nvcc's output (ptxas resource usage)


# one lock per library, so that two libraries can build at the same time
_LOCKS_GUARD = threading.Lock()
_LOCKS: Dict[str, threading.Lock] = {}
_LOADED: Dict[str, BuiltLibrary] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return nvcc


def load_library(name: str, sources: Sequence[str]) -> BuiltLibrary:
    """Compile ``csrc/<sources>`` into one shared library (cached by content)
    and load it.  Raises RuntimeError with nvcc's output if the build fails."""
    # the shared headers (``csrc/*.cuh``) are part of every source
    return compile_cached(name, find_nvcc, NVCC_FLAGS, [CSRC_DIR / s for s in sources],
                          sorted(CSRC_DIR.glob("*.cuh")))


def compile_cached(name: str, compiler: Callable[[], str], flags: Sequence[str],
                   sources: Sequence[Path], headers: Sequence[Path] = ()) -> BuiltLibrary:
    """Compile ``sources`` with ``compiler()`` and ``flags`` into one shared
    library under ``_build/``, named by a hash of the flags, the sources and
    the ``headers`` they include, and load it: an unchanged library loads
    the cached file (and the compiler is not looked for).  Raises
    RuntimeError with the compiler's output if the build fails."""
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LOADED:
            return _LOADED[name]
        digest = hashlib.sha256(" ".join(flags).encode())
        for p in [*sources, *headers]:
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
        seconds, log = 0.0, ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [compiler(), *flags, "-o", tmp, *map(str, sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"build failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, so)
        built = BuiltLibrary(ctypes.CDLL(str(so)), so, seconds, log)
        _LOADED[name] = built
        return built
