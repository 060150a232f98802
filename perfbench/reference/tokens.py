"""The layout vocabulary of LayoutDM, written out plainly from the
configuration (reference implementation; no import of the program).

A layout of E elements is the sequence ``c1 x1 y1 w1 h1 c2 ...`` of
``5 E`` tokens.  The vocabulary is the categories, then 32 bins for each
of x, y, w and h (``shared_bbox_vocab = "x-y-w-h"``), then PAD and MASK.
Boxes are quantized linearly: x and y to ``round(32 * clip(v, 0, 1 - 1/32))``,
w and h to ``round(32 * (clip(v, 1/32, 1) - 1/32))``; a bin decodes to its
grid point (x, y: ``i / 32``; w, h: ``(i + 1) / 32``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

ATTRS = ("c", "x", "y", "w", "h")


@dataclass(frozen=True)
class Vocab:
    num_categories: int
    max_elements: int
    num_bins: int = 32

    @classmethod
    def of(cls, cfg: Dict) -> "Vocab":
        if cfg["shared_bbox_vocab"] != "x-y-w-h" or cfg["var_order"] != "c-x-y-w-h":
            raise ValueError("the reference spells out the x-y-w-h vocabulary in c-x-y-w-h order")
        if cfg["bbox_quantization"] != "linear" or list(cfg["special_tokens"]) != ["pad", "mask"]:
            raise ValueError("the reference spells out linear bins and (pad, mask)")
        return cls(cfg["num_categories"], cfg["max_elements"], cfg["num_bins"])

    @property
    def size(self) -> int:
        return self.num_categories + 4 * self.num_bins + 2

    @property
    def pad(self) -> int:
        return self.size - 2

    @property
    def mask(self) -> int:
        return self.size - 1

    @property
    def seq_len(self) -> int:
        return 5 * self.max_elements

    def attr_tokens(self, a: int) -> List[int]:
        """The tokens attribute ``a`` may hold besides MASK: its own, then PAD."""
        if a == 0:
            own = list(range(self.num_categories))
        else:
            lo = self.num_categories + (a - 1) * self.num_bins
            own = list(range(lo, lo + self.num_bins))
        return own + [self.pad]

    def encode(self, label: torch.Tensor, bbox: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, E) labels, (B, E, 4) boxes, (B, E) validity -> (B, 5E) ids."""
        n, d = self.num_bins, 1.0 / self.num_bins
        bbox = bbox.float()
        xy = bbox[..., :2].clamp(0.0, 1.0 - d)
        wh = bbox[..., 2:].clamp(d, 1.0) - d
        bins = torch.round(n * torch.cat([xy, wh], -1)).long()
        bins = bins + self.num_categories + n * torch.arange(4, device=bins.device)
        ids = torch.cat([label.long()[..., None], bins], -1)
        ids = torch.where(mask.bool()[..., None], ids, self.pad)
        return ids.reshape(ids.shape[0], -1)

    def decode(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, 5E) ids -> label, bbox and the mask of well-formed elements
        (a category, then one bin of each coordinate in order)."""
        n = self.num_bins
        el = ids.reshape(ids.shape[0], -1, 5)
        label = el[..., 0]
        bins = el[..., 1:] - self.num_categories - n * torch.arange(4, device=ids.device)
        ok = (label >= 0) & (label < self.num_categories) & ((bins >= 0) & (bins < n)).all(-1)
        grid = bins.float() / n + torch.tensor([0.0, 0.0, 1.0, 1.0], device=ids.device) / n
        return {"label": torch.where(ok, label, 0),
                "bbox": torch.where(ok[..., None], grid, 0.0), "mask": ok}
