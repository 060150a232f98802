"""Layout transforms on dense batches — numpy, host-side, per-epoch.

Parity: `data/util.py:111-267`.  Each transform is
``(rng, {bbox,label,mask}[, extras]) -> batch`` over PADDED dense arrays;
`compose_transform` resolves the same config-string pipeline syntax
(including ``AddRelationConstraints(edge_ratio=0.1)``) without ``eval`` on
arbitrary strings.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List

import numpy as np

from layoutdm_tpu_torch.data.relations import pad_edges, sample_relations


def _per_layout_perm(rng, mask, keyfn=None):
    """Permute valid elements per layout; padding stays at the tail."""
    B, S = mask.shape
    perms = np.tile(np.arange(S), (B, 1))
    for b in range(B):
        n = int(mask[b].sum())
        if n > 1:
            perms[b, :n] = rng.permutation(n)
    return perms


def _apply_perm(batch, perms):
    out = dict(batch)
    out["bbox"] = np.take_along_axis(batch["bbox"], perms[..., None], axis=1)
    out["label"] = np.take_along_axis(batch["label"], perms, axis=1)
    return out


class RandomOrder:
    def __call__(self, rng, batch):
        return _apply_perm(batch, _per_layout_perm(rng, batch["mask"]))


class SortByLabel:
    def __call__(self, rng, batch):
        B, S = batch["label"].shape
        key = np.where(batch["mask"], batch["label"], np.iinfo(np.int32).max)
        perms = np.argsort(key, axis=1, kind="stable")
        return _apply_perm(batch, perms)


class LexicographicOrder:
    """Sort by (top, left) (`data/util.py:198-206`)."""

    def __call__(self, rng, batch):
        bbox, mask = batch["bbox"], batch["mask"]
        x = bbox[..., 0] - bbox[..., 2] / 2
        y = bbox[..., 1] - bbox[..., 3] / 2
        big = np.where(mask, 0.0, 1e9)
        key = (y + big) * 1e4 + (x + big)
        perms = np.argsort(key, axis=1, kind="stable")
        return _apply_perm(batch, perms)


class AddNoiseToBBox:
    def __init__(self, std: float = 0.05):
        self.std = float(std)

    def __call__(self, rng, batch):
        out = dict(batch)
        out["bbox_orig"] = batch["bbox"].copy()
        noise = rng.normal(0, self.std, size=batch["bbox"].shape).astype(
            np.float32
        )
        out["bbox"] = (batch["bbox"] + noise) * batch["mask"][..., None]
        return out


class AddCanvasElement:
    """Prepend the canvas box [0.5,0.5,1,1] with label 0; shift labels +1
    (`data/util.py:111-125`).  Output has S+1 element slots."""

    x = np.array([0.5, 0.5, 1.0, 1.0], np.float32)

    def __call__(self, rng, batch):
        B, S = batch["label"].shape
        bbox = np.concatenate(
            [np.tile(self.x, (B, 1, 1)), batch["bbox"]], axis=1
        )
        label = np.concatenate(
            [
                np.zeros((B, 1), batch["label"].dtype),
                batch["label"] + batch["mask"],
            ],
            axis=1,
        )
        mask = np.concatenate([np.ones((B, 1), bool), batch["mask"]], axis=1)
        out = dict(batch)
        out.update(bbox=bbox, label=label, mask=mask, has_canvas=True)
        return out


class AddRelationConstraints:
    def __init__(self, edge_ratio: float = 0.1, seed=None, max_edges: int = 64):
        self.edge_ratio = edge_ratio
        self.seed = seed
        self.max_edges = max_edges

    def __call__(self, rng, batch):
        B = batch["label"].shape[0]
        has_canvas = bool(batch.get("has_canvas", False))
        ei, ea, em = [], [], []
        for b in range(B):
            n = int(batch["mask"][b].sum())
            # explicit seed wins; otherwise draw from the pipeline's
            # config-seeded RandomState (never the process-global RNG)
            e = sample_relations(
                batch["bbox"][b, :n],
                batch["label"][b, :n],
                edge_ratio=self.edge_ratio,
                seed=self.seed + b
                if self.seed is not None
                else int(rng.randint(0, 2**31 - 1)),
                has_canvas=has_canvas,
            )
            p = pad_edges(e[0], e[1], self.max_edges)
            ei.append(p["edge_index"])
            ea.append(p["edge_attr"])
            em.append(p["edge_mask"])
        out = dict(batch)
        out["edge_index"] = np.stack(ei)
        out["edge_attr"] = np.stack(ea)
        out["edge_mask"] = np.stack(em)
        return out


class HorizontalFlip:
    def __call__(self, rng, batch):
        out = dict(batch)
        bbox = batch["bbox"].copy()
        bbox[..., 0] = (1 - bbox[..., 0]) * batch["mask"]
        out["bbox"] = bbox
        return out


_TRANSFORMS = {
    "RandomOrder": RandomOrder,
    "SortByLabel": SortByLabel,
    "LexicographicOrder": LexicographicOrder,
    "AddNoiseToBBox": AddNoiseToBBox,
    "AddCanvasElement": AddCanvasElement,
    "AddRelationConstraints": AddRelationConstraints,
    "HorizontalFlip": HorizontalFlip,
}

_ARG_RE = re.compile(r"(\w+)\s*=\s*([^,)]+)")


def compose_transform(specs: List[str]) -> Callable:
    """Build a pipeline from config strings (`data/util.py:256-267`)."""
    fns = []
    for spec in specs:
        name = spec.split("(")[0]
        kwargs = {}
        if "(" in spec:
            for k, v in _ARG_RE.findall(spec[spec.index("(") :]):
                try:
                    kwargs[k] = float(v) if "." in v else int(v)
                except ValueError:
                    kwargs[k] = v.strip("\"'")
        fns.append(_TRANSFORMS[name](**kwargs))

    def apply(rng: np.random.RandomState, batch: Dict) -> Dict:
        for fn in fns:
            batch = fn(rng, batch)
        return batch

    return apply
