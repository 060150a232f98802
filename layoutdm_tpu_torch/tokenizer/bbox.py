"""Bbox coordinate quantization (port of ``layoutdm_tpu/tokenizer/bbox.py``).

The tokenizer is a (4, num_bins) array of sorted bin centers plus static
offset/permutation metadata; encode is the closed-form linear rounding or a
nearest-center argmin, decode one gather (reference
`helpers/bbox_tokenizer.py:28-221`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

VAR_NAMES = ("x", "y", "w", "h")

# per-coordinate vocabulary offsets (in units of num_bins)
KEY_MULT = {
    "x-y-w-h": {"x": 0, "y": 1, "w": 2, "h": 3},
    "xywh": {"x": 0, "y": 0, "w": 0, "h": 0},
}


def linear_centers(num_bins: int) -> np.ndarray:
    """(4, num_bins) uniform-grid centers (`bbox_tokenizer.py:71-82`)."""
    d = 1.0 / num_bins
    xy = np.linspace(0.0, 1.0 - d, num_bins)
    wh = np.linspace(d, 1.0, num_bins)
    return np.stack([xy, xy, wh, wh]).astype(np.float32)


@dataclass(frozen=True)
class BboxTokenizer:
    """Immutable quantizer for (..., 4) xywh boxes."""

    num_bins: int
    var_order: Tuple[str, ...] = VAR_NAMES
    shared_vocab: str = "xywh"
    quantization: str = "linear"
    # (4, num_bins) float32, rows in canonical x,y,w,h order, sorted ascending
    centers: np.ndarray = None

    def __post_init__(self):
        if self.shared_vocab not in KEY_MULT:
            raise ValueError(f"shared_vocab={self.shared_vocab!r}")
        if self.quantization not in ("linear", "kmeans", "percentile"):
            raise ValueError(f"quantization={self.quantization!r}")
        if self.centers is None:
            object.__setattr__(self, "centers", linear_centers(self.num_bins))
        if self.centers.shape != (4, self.num_bins):
            raise ValueError(f"centers shape {self.centers.shape}")

    @property
    def offsets(self) -> np.ndarray:
        """(4,) vocab offset per canonical coordinate."""
        mult = KEY_MULT[self.shared_vocab]
        return np.array(
            [mult[k] * self.num_bins for k in VAR_NAMES], dtype=np.int64
        )

    @property
    def order_perm(self) -> np.ndarray:
        """canonical xywh column -> position in var_order (encode gather)."""
        return np.array([VAR_NAMES.index(k) for k in self.var_order])

    @property
    def inv_order_perm(self) -> np.ndarray:
        return np.array([self.var_order.index(k) for k in VAR_NAMES])

    @property
    def vocab_len(self) -> int:
        n_vocab = len(set(KEY_MULT[self.shared_vocab].values()))
        return self.num_bins * n_vocab

    def encode(self, bbox: torch.Tensor) -> torch.Tensor:
        """(..., 4) float xywh -> (..., 4) int64 token ids (with offsets,
        in var_order)."""
        dev = bbox.device
        if self.quantization == "linear":
            d = 1.0 / self.num_bins
            xy = torch.clamp(bbox[..., :2], 0.0, 1.0 - d)
            wh = torch.clamp(bbox[..., 2:], d, 1.0) - d
            q = torch.cat([xy, wh], dim=-1)
            idx = torch.round(self.num_bins * q).to(torch.int64)
        else:
            centers = torch.as_tensor(self.centers, device=dev)
            dist = torch.abs(bbox[..., :, None] - centers)  # (..., 4, nbins)
            idx = torch.argmin(dist, dim=-1)
        idx = idx + torch.as_tensor(self.offsets, device=dev)
        return idx[..., torch.as_tensor(self.order_perm, device=dev)]

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """(..., 4) int token ids -> (..., 4) float32 xywh."""
        dev = ids.device
        arr = ids[..., torch.as_tensor(self.inv_order_perm, device=dev)]
        arr = arr - torch.as_tensor(self.offsets, device=dev)
        arr = torch.clamp(arr, 0, self.num_bins - 1)  # avoid OOV
        if self.quantization == "linear":
            d = 1.0 / self.num_bins
            xy = arr[..., :2].to(torch.float32) * d
            wh = (arr[..., 2:] + 1).to(torch.float32) * d
            return torch.cat([xy, wh], dim=-1)
        centers = torch.as_tensor(self.centers, device=dev)  # (4, nbins)
        vals = torch.gather(
            centers.expand(arr.shape[:-1] + centers.shape),
            -1,
            arr[..., None],
        )[..., 0]
        return torch.clamp(vals, 0.0, 1.0)

    def token_masks(self) -> Dict[str, np.ndarray]:
        """Per-coordinate legality over the bbox vocab
        (`bbox_tokenizer.py:198-216`)."""
        masks = {}
        if self.shared_vocab == "xywh":
            for key in self.var_order:
                masks[key] = np.full((self.num_bins,), True)
        else:
            S = self.num_bins * 4
            for key in self.var_order:
                m = np.full((S,), False)
                i = KEY_MULT["x-y-w-h"][key]
                m[i * self.num_bins : (i + 1) * self.num_bins] = True
                masks[key] = m
        return masks


def load_kmeans_centers(
    path: str, num_bins: int, keys: Tuple[str, ...] = VAR_NAMES
) -> np.ndarray:
    """Per-coordinate cluster centers, sorted ascending (the reference sorts
    them in place, `bbox_tokenizer.py:52-70`), from (a) an ``.npz`` with
    arrays named ``{key}-{num_bins}`` or (b) the reference's pickle of
    sklearn-like objects exposing ``cluster_centers_``, read without
    sklearn (`_tolerant_unpickle`)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            rows = [
                np.sort(np.asarray(data[f"{k}-{num_bins}"]).reshape(-1))
                for k in keys
            ]
    else:
        models = _tolerant_unpickle(path)
        rows = []
        for k in keys:
            m = models[f"{k}-{num_bins}"]
            centers = (
                m.cluster_centers_
                if hasattr(m, "cluster_centers_")
                else m.__dict__["cluster_centers_"]
            )
            rows.append(np.sort(np.asarray(centers).reshape(-1)))
    return np.stack(rows).astype(np.float32)


def _tolerant_unpickle(path: str):
    """Unpickle the reference's clustering weights without sklearn: the
    reference pickles sklearn KMeans objects (`bbox_tokenizer.py:56-58`),
    of which only ``cluster_centers_`` is needed, so a class that cannot be
    imported becomes an attribute bucket during the load."""
    import pickle

    class _Bucket:
        def __setstate__(self, state):
            if isinstance(state, dict):
                self.__dict__.update(state)

    class _TolerantUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (_Bucket,), {"__module__": module})

    with open(path, "rb") as f:
        return _TolerantUnpickler(f).load()
