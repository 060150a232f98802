"""Taps on the program's reverse chain: they record, for chosen rows, the
ids each step starts from, the ids the chain returns, and the generator's
state before each step's draw, so that the reference can follow the chain
step by step.  They wrap two of the model's own attributes
(``sample_ids``, called once a chain, and ``_predict_start``, called once
a step) and add one row gather a step; the program's path is otherwise
untouched.  A program whose chain no longer calls them so (a chain
captured in a CUDA graph, say) is reported by `ChainTap.faults` and fails
the comparison: the tap has to follow such a change first."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch


class ChainTap:
    """``rows(batch)`` picks the rows to record of a chain of ``batch``
    rows (None: every row)."""

    def __init__(self, model, rows: Optional[Callable[[int], np.ndarray]] = None):
        self.model = model
        self.rows = rows
        self.records: List[Dict] = []
        self.on = True
        self._cur: Optional[Dict] = None
        self._ps = model._predict_start
        self._sample_ids = model.sample_ids
        model._predict_start = self._predict_start
        model.sample_ids = self._sample

    def remove(self) -> None:
        self.model._predict_start = self._ps
        self.model.sample_ids = self._sample_ids

    def faults(self, chains: int, steps: int) -> List[str]:
        """What the taps missed of ``chains`` chains of ``steps`` steps each."""
        out = []
        if len(self.records) != chains:
            out.append(f"{chains} chains ran, the tap on sample_ids saw {len(self.records)}")
        for i, r in enumerate(self.records):
            if len(r["steps"]) != steps:
                out.append(f"chain {i}: {steps} steps, the tap on _predict_start saw "
                           f"{len(r['steps'])}")
                break
        return out

    def _sample(self, rng, batch_size, *args, **kw):
        if not self.on:
            return self._sample_ids(rng, batch_size, *args, **kw)
        if not isinstance(rng, torch.Generator):
            raise TypeError("the chain tap follows a chain drawn from one torch.Generator")
        picked = np.arange(batch_size) if self.rows is None else self.rows(batch_size)
        idx = torch.as_tensor(picked, device=self.model.device)
        cur = {"rows": [int(r) for r in picked], "batch": batch_size, "steps": [],
               "states": [], "gen": rng, "idx": idx}
        self._cur = cur
        try:
            ids = self._sample_ids(rng, batch_size, *args, **kw)
        finally:
            self._cur = None
        cur["final"] = ids.index_select(0, idx)
        del cur["gen"], cur["idx"]
        self.records.append(cur)
        return ids

    def _predict_start(self, ids, t, *rest):
        cur = self._cur
        if cur is not None:
            cur["steps"].append(ids.index_select(0, cur["idx"]).to(torch.uint8))
            cur["states"].append(cur["gen"].get_state())
        return self._ps(ids, t, *rest)
