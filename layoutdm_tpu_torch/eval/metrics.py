"""Layout metrics (port of ``layoutdm_tpu/eval/metrics.py``, which holds
them all; reference `trainer/helpers/metric.py`).  Only the relation
violation rate is ported so far: ``sample_cli`` and the service report it
for relation-constrained generation.  The rest of the evaluation port is
later work (ROADMAP Queue 2)."""

from __future__ import annotations

import numpy as np

from layoutdm_tpu_torch.data.relations import (
    RelLoc,
    RelSize,
    detect_loc_relation,
    detect_size_relation,
)


def compute_violation(
    bbox: np.ndarray,  # (B, S, 4) generated boxes (canvas at index 0)
    label: np.ndarray,  # (B, S)
    edge_index: np.ndarray,  # (B, E, 2)
    edge_attr: np.ndarray,  # (B, E) bit flags
    edge_mask: np.ndarray,  # (B, E)
) -> np.ndarray:
    """Per-layout share of the imposed relations that the boxes break
    (`metric.py:62-95`), NaN for a layout with no active relation."""
    B = bbox.shape[0]
    out = np.full((B,), np.nan)
    for b in range(B):
        fail = valid = 0
        for e in range(edge_index.shape[1]):
            if not edge_mask[b, e]:
                continue
            i, j = edge_index[b, e]
            gt = int(edge_attr[b, e])
            b1, b2 = bbox[b, i], bbox[b, j]
            if ~gt & (1 << RelSize.UNKNOWN):
                pred = detect_size_relation(b1, b2)
                fail += int((gt & (1 << pred)) == 0)
                valid += 1
            if ~gt & (1 << RelLoc.UNKNOWN):
                pred = detect_loc_relation(b1, b2, label[b, i] == 0)
                fail += int((gt & (1 << pred)) == 0)
                valid += 1
        if valid:
            out[b] = fail / valid
    return out
