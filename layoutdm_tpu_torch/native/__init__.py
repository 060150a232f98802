"""ctypes bindings for the host-side metric engine (port of
``layoutdm_tpu/native``).

``lsap.cpp`` holds the Hungarian solver, the maximum-IoU score matrix and
the DocSim pair scores.  It is built with ``g++`` at first use into
``layoutdm_tpu_torch/_build/`` (git-ignored), named by a hash of the source
and the flags, as the CUDA kernels are (``ops/cuda_build.py``).  A failed
build raises: there is no silent fallback.  The Python versions in
``eval/metrics.py`` (``_max_iou_two_layouts``, ``_docsim_pair``) and scipy's
solver are the plain versions the tests hold the engine to.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Tuple

import numpy as np

from layoutdm_tpu_torch.ops.cuda_build import BuiltLibrary, compile_cached

SOURCE = Path(__file__).resolve().parent / "lsap.cpp"
GXX_FLAGS = ("-fopenmp", "-O3", "-shared", "-fPIC", "-std=c++17")

_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)
_I32 = ctypes.POINTER(ctypes.c_int)
_INT = ctypes.c_int
_SIGNATURES = {
    "solve_lsap": (ctypes.c_double, [_F64, _INT, _INT, _I32, _INT]),
    "max_iou_score_matrix": (None, [_F32, _I32, _I32, _INT, _F32, _I32, _I32, _INT, _F64]),
    "docsim_pairs": (None, [_F32, _I32, _I32, _F32, _I32, _I32, _INT, _INT, _F64]),
}


@functools.lru_cache(maxsize=1)
def library() -> BuiltLibrary:
    """The engine, built with OpenMP on first use.  Raises RuntimeError
    with g++'s output if it cannot be built."""
    built = compile_cached("lsap", lambda: "g++", GXX_FLAGS, [SOURCE])
    for fn, (restype, argtypes) in _SIGNATURES.items():
        getattr(built.lib, fn).restype = restype
        getattr(built.lib, fn).argtypes = argtypes
    return built


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _pack(group) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Layouts (bbox (n, 4), label (n,)) -> concatenated float32 boxes,
    int32 labels and the (len + 1,) offsets of each layout."""
    boxes = np.concatenate(
        [np.asarray(b, np.float32).reshape(-1, 4) for b, _ in group]
        or [np.zeros((0, 4), np.float32)]
    )
    labels = np.concatenate(
        [np.asarray(l, np.int32).reshape(-1) for _, l in group]
        or [np.zeros((0,), np.int32)]
    )
    offsets = np.zeros((len(group) + 1,), np.int32)
    np.cumsum([len(l) for _, l in group], out=offsets[1:])
    return (np.ascontiguousarray(boxes), np.ascontiguousarray(labels),
            np.ascontiguousarray(offsets))


def linear_sum_assignment(cost: np.ndarray, maximize: bool = False
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """scipy.optimize.linear_sum_assignment on the native solver."""
    lib = library().lib
    c = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = c.shape
    col4row = np.full((n,), -1, dtype=np.int32)
    lib.solve_lsap(_ptr(c, _F64), n, m, _ptr(col4row, _I32), 1 if maximize else 0)
    rows = np.nonzero(col4row >= 0)[0]
    return rows, col4row[rows]


def docsim_pairs(layouts_1: List, layouts_2: List, max_diff_thresh: int = 3) -> np.ndarray:
    """DocSim score of each aligned pair (layouts_1[i], layouts_2[i])."""
    lib = library().lib
    b1, l1, o1 = _pack(layouts_1)
    b2, l2, o2 = _pack(layouts_2)
    n = min(len(layouts_1), len(layouts_2))
    out = np.zeros((n,), np.float64)
    lib.docsim_pairs(_ptr(b1, _F32), _ptr(l1, _I32), _ptr(o1, _I32),
                     _ptr(b2, _F32), _ptr(l2, _I32), _ptr(o2, _I32),
                     n, max_diff_thresh, _ptr(out, _F64))
    return out


def max_iou_score_matrix(group1: List, group2: List) -> np.ndarray:
    """(N, M) maximum-IoU pair scores of two layout groups that share one
    label multiset."""
    lib = library().lib
    b1, l1, o1 = _pack(group1)
    b2, l2, o2 = _pack(group2)
    N, M = len(group1), len(group2)
    out = np.zeros((N, M), np.float64)
    lib.max_iou_score_matrix(_ptr(b1, _F32), _ptr(l1, _I32), _ptr(o1, _I32), N,
                             _ptr(b2, _F32), _ptr(l2, _I32), _ptr(o2, _I32), M,
                             _ptr(out, _F64))
    return out
