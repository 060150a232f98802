"""Pairwise layout relations: enums, detectors, and padded edge sampling.

Parity: `data/util.py:14-69` (enums + detectors) and the
`AddRelationConstraints` transform (`data/util.py:128-177`), re-expressed on
dense arrays with STATIC edge padding so relation-conditioned sampling can
run inside jit.
"""

from __future__ import annotations

from enum import IntEnum
from itertools import combinations, product
import random as _random
from typing import Dict, Tuple

import numpy as np


class RelSize(IntEnum):
    UNKNOWN = 0
    SMALLER = 1
    EQUAL = 2
    LARGER = 3


class RelLoc(IntEnum):
    UNKNOWN = 4
    LEFT = 5
    TOP = 6
    RIGHT = 7
    BOTTOM = 8
    CENTER = 9


REL_SIZE_ALPHA = 0.1


def detect_size_relation(b1, b2) -> RelSize:
    a1, a2 = b1[2] * b1[3], b2[2] * b2[3]
    if (1 - REL_SIZE_ALPHA) * a1 < a2 < (1 + REL_SIZE_ALPHA) * a1:
        return RelSize.EQUAL
    return RelSize.LARGER if a1 < a2 else RelSize.SMALLER


def detect_loc_relation(b1, b2, is_canvas: bool = False) -> RelLoc:
    if is_canvas:
        yc = b2[1]
        if yc < 1 / 3:
            return RelLoc.TOP
        if yc < 2 / 3:
            return RelLoc.CENTER
        return RelLoc.BOTTOM
    l1, t1, r1, bb1 = _ltrb(b1)
    l2, t2, r2, bb2 = _ltrb(b2)
    if bb2 <= t1:
        return RelLoc.TOP
    if bb1 <= t2:
        return RelLoc.BOTTOM
    if r2 <= l1:
        return RelLoc.LEFT
    if r1 <= l2:
        return RelLoc.RIGHT
    return RelLoc.CENTER


def _ltrb(b):
    return b[0] - b[2] / 2, b[1] - b[3] / 2, b[0] + b[2] / 2, b[1] + b[3] / 2


REL_UNK = (1 << RelSize.UNKNOWN) | (1 << RelLoc.UNKNOWN)


def sample_relations(
    bbox: np.ndarray,  # (N, 4) — index 0 is the canvas if has_canvas
    label: np.ndarray,
    edge_ratio: float = 0.1,
    seed: int = 0,
    has_canvas: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample ~edge_ratio of ordered (size, loc) relation slots among element
    pairs and bit-encode them (`data/util.py:136-177`).  Returns
    (edge_index (E,2), edge_attr (E,)) with i<j pairs.

    Always seeded (default 0): two runs with the same seed produce identical
    constraint graphs — never the process-global RNG."""
    N = bbox.shape[0]
    gen = _random.Random(seed)
    rel_all = list(product(range(2), combinations(range(N), 2)))
    size = int(len(rel_all) * edge_ratio)
    rel_sample = set(gen.sample(rel_all, size))

    edge_index, edge_attr = [], []
    for i, j in combinations(range(N), 2):
        bi, bj = bbox[i], bbox[j]
        is_canvas = bool(label[i] == 0) and has_canvas
        rel_size = (
            1 << detect_size_relation(bi, bj)
            if (0, (i, j)) in rel_sample
            else 1 << RelSize.UNKNOWN
        )
        rel_loc = (
            1 << detect_loc_relation(bi, bj, is_canvas)
            if (1, (i, j)) in rel_sample
            else 1 << RelLoc.UNKNOWN
        )
        rel = rel_size | rel_loc
        if rel != REL_UNK:
            edge_index.append((i, j))
            edge_attr.append(rel)
    return (
        np.asarray(edge_index, np.int32).reshape(-1, 2),
        np.asarray(edge_attr, np.int32),
    )


def pad_edges(
    edge_index: np.ndarray, edge_attr: np.ndarray, max_edges: int
) -> Dict[str, np.ndarray]:
    """Pad to static (max_edges,) with a validity mask for in-jit use."""
    E = min(len(edge_attr), max_edges)
    ei = np.zeros((max_edges, 2), np.int32)
    ea = np.zeros((max_edges,), np.int32)
    m = np.zeros((max_edges,), bool)
    ei[:E] = edge_index[:E]
    ea[:E] = edge_attr[:E]
    m[:E] = True
    return {"edge_index": ei, "edge_attr": ea, "edge_mask": m}
