"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each library is compiled for Hopper (``sm_90a``) into a shared object with a
plain C interface, under ``layoutdm_tpu_torch/_build/`` (git-ignored), named
by a hash of its sources, the shared headers and the flags: a changed source
builds anew, an unchanged one loads the cached file.  Nothing is downloaded and no PyTorch
header is compiled, so a build takes seconds.
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
from typing import Dict, Sequence

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
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LOADED:
            return _LOADED[name]
        paths = [CSRC_DIR / s for s in sources]
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        # the shared headers (``csrc/*.cuh``) are part of every source
        for p in paths + sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
        seconds, log = 0.0, ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, so)
        built = BuiltLibrary(ctypes.CDLL(str(so)), so, seconds, log)
        _LOADED[name] = built
        return built
