"""Layout <-> flat token sequence (port of
``layoutdm_tpu/tokenizer/sequence.py``: `LayoutSequenceTokenizer` and
`LayoutDictTokenizer`).

A layout batch {label (B,S), bbox (B,S,4), mask (B,S)} maps to one token
sequence ``(c1 x1 y1 w1 h1 c2 ...)`` of length S*C (+1 with BOS) over the
vocabulary

    [0, N_cat) categories | [N_cat, N_cat+N_bbox) bbox bins | specials

with MASK the last id (reference `helpers/layout_tokenizer.py:38-313`).
Token ids are int64 tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from layoutdm_tpu_torch.tokenizer.bbox import BboxTokenizer

SPECIAL_TOKENS = ("pad", "bos", "eos", "mask")


@dataclass(frozen=True)
class LayoutSequenceTokenizer:
    bbox_tokenizer: BboxTokenizer
    num_categories: int
    max_elements: int  # dataset max_seq_length (elements per layout)
    special_tokens: Tuple[str, ...] = ("pad", "mask")
    pad_until_max: bool = False
    sort_by: Optional[str] = None  # None | "category_alphabetical"

    def __post_init__(self):
        for tok in self.special_tokens:
            if tok not in SPECIAL_TOKENS:
                raise ValueError(f"unknown special token {tok!r}")
        if "mask" in self.special_tokens and (
            self.special_tokens.index("mask") != len(self.special_tokens) - 1
        ):
            # MASK must be the final vocabulary id (`layout_tokenizer.py:61-62`)
            raise ValueError("'mask' must be the last special token")

    # ---- vocab layout -----------------------------------------------------
    @property
    def N_category(self) -> int:
        return self.num_categories

    @property
    def N_bbox(self) -> int:
        return self.bbox_tokenizer.vocab_len

    @property
    def N_bbox_per_var(self) -> int:
        return self.bbox_tokenizer.num_bins

    @property
    def N_sp_token(self) -> int:
        return len(self.special_tokens)

    @property
    def N_total(self) -> int:
        return self.N_category + self.N_bbox + self.N_sp_token

    @property
    def N_var_per_element(self) -> int:
        return 1 + len(self.bbox_tokenizer.var_order)

    @property
    def var_names(self) -> Tuple[str, ...]:
        return ("c",) + tuple(self.bbox_tokenizer.var_order)

    @property
    def max_token_length(self) -> int:
        n = self.max_elements * self.N_var_per_element
        if "bos" in self.special_tokens:
            n += 1
        return n

    def name_to_id(self, name: str) -> int:
        if name not in self.special_tokens:
            raise KeyError(name)
        return self.N_category + self.N_bbox + self.special_tokens.index(name)

    def id_to_name(self, id_: int) -> str:
        return self.special_tokens[id_ - self.N_category - self.N_bbox]

    # ---- encode -----------------------------------------------------------
    def encode(self, inputs: Dict) -> Dict[str, torch.Tensor]:
        """{label (B,S), bbox (B,S,4), mask (B,S)} -> {seq, mask}
        (`layout_tokenizer.py:208-253`).  Inputs may be numpy or tensors;
        outputs live on the bbox tensor's device."""
        bbox = torch.as_tensor(inputs["bbox"], dtype=torch.float32)
        dev = bbox.device
        label = torch.as_tensor(inputs["label"], device=dev).long()
        mask = torch.as_tensor(inputs["mask"], device=dev).bool()
        bbox_ids = self.bbox_tokenizer.encode(bbox)
        C = self.N_var_per_element

        if self.pad_until_max:
            padn = self.max_elements - label.shape[1]
            if padn > 0:
                label = F.pad(label, (0, padn))
                bbox_ids = F.pad(bbox_ids, (0, 0, 0, padn))
                mask = F.pad(mask, (0, padn))

        bbox_ids = bbox_ids + self.N_category

        if "pad" in self.special_tokens:
            pad_id = self.name_to_id("pad")
            label = torch.where(mask, label, pad_id)
            bbox_ids = torch.where(mask[..., None], bbox_ids, pad_id)

        if self.sort_by == "category_alphabetical":
            order = torch.argsort(label, dim=1, stable=True)
            label = torch.gather(label, 1, order)
            bbox_ids = torch.gather(
                bbox_ids, 1, order[..., None].expand_as(bbox_ids)
            )
            mask = torch.gather(mask, 1, order)

        B, S = label.shape
        seq = torch.cat([label[..., None], bbox_ids], dim=-1).reshape(B, S * C)
        tok_mask = torch.repeat_interleave(mask, C, dim=1)

        if "bos" in self.special_tokens and "eos" in self.special_tokens:
            seq_len = mask.sum(dim=1, keepdim=True)
            pos = torch.arange(S * C, device=dev)[None, :]
            seq = torch.where(pos == seq_len * C, self.name_to_id("eos"), seq)
            bos = torch.full((B, 1), self.name_to_id("bos"), device=dev)
            seq = torch.cat([bos, seq], dim=-1)
            tok_mask = torch.cat(
                [torch.ones((B, 1), dtype=torch.bool, device=dev), tok_mask],
                dim=-1,
            )
        return {"seq": seq, "mask": tok_mask}

    # ---- decode -----------------------------------------------------------
    def decode(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, S*C) token ids -> {bbox, label, mask}; corrupted elements are
        zeroed and masked (`layout_tokenizer.py:255-266`)."""
        C = self.N_var_per_element
        B = ids.shape[0]
        ids = ids.reshape(B, -1, C)
        label, bbox_ids = ids[..., 0], ids[..., 1:] - self.N_category

        invalid = self._filter_eos(label)
        label_valid = (0 <= label) & (label < self.N_category)
        bbox_valid = torch.all((0 <= bbox_ids) & (bbox_ids < self.N_bbox), -1)
        invalid = invalid | ~(label_valid & bbox_valid)

        bbox = self.bbox_tokenizer.decode(bbox_ids)
        label = torch.where(invalid, 0, label)
        bbox = torch.where(invalid[..., None], 0.0, bbox)
        return {"bbox": bbox, "label": label, "mask": ~invalid}

    def _filter_eos(self, label: torch.Tensor) -> torch.Tensor:
        if "bos" in self.special_tokens and "eos" in self.special_tokens:
            return torch.cumsum(label == self.name_to_id("eos"), dim=1) > 0
        return torch.zeros_like(label, dtype=torch.bool)

    # ---- legality mask ----------------------------------------------------
    def token_mask(self) -> np.ndarray:
        """(max_token_length_wo_bos, N_total) legal-vocabulary mask per slot
        (`layout_tokenizer.py:269-294`)."""
        bb = self.bbox_tokenizer.token_masks()
        last = np.array(
            [tok not in ("bos", "mask") for tok in self.special_tokens]
        )
        rows = []
        for key in self.var_names:
            if key == "c":
                row = np.concatenate(
                    [
                        np.full((self.N_category,), True),
                        np.full((self.N_bbox,), False),
                        last,
                    ]
                )
            else:
                row = np.concatenate(
                    [np.full((self.N_category,), False), bb[key], last]
                )
            rows.append(row)
        return np.tile(np.stack(rows, axis=0), (self.max_elements, 1))

    def get_slice(self, name: str) -> slice:
        """Vocab id range of one attribute (`layout_tokenizer.py:296-313`)."""
        if not (name == "special" or name in self.var_names):
            raise KeyError(name)
        if name == "special":
            return slice(self.N_category + self.N_bbox, self.N_total)
        if name == "c":
            return slice(0, self.N_category)
        start = self.N_category
        if self.bbox_tokenizer.shared_vocab == "x-y-w-h":
            start += ("x", "y", "w", "h").index(name) * self.N_bbox_per_var
        return slice(start, start + self.N_bbox_per_var)


@dataclass(frozen=True)
class LayoutDictTokenizer(LayoutSequenceTokenizer):
    """Layout -> a dict of per-element sequences instead of one flat
    sequence (`layout_tokenizer.py:316-396`, JAX `LayoutDictTokenizer`):
    {label (B, S[+1]), bbox ids (B, S[+1], 4), mask}, with BOS and EOS
    rows for element-wise autoregressive models when the vocabulary has
    both."""

    def __post_init__(self):
        super().__post_init__()
        if self.bbox_tokenizer.var_order != ("x", "y", "w", "h"):
            raise ValueError("LayoutDictTokenizer needs the x-y-w-h variable order")
        if self.bbox_tokenizer.shared_vocab != "xywh":
            raise ValueError("LayoutDictTokenizer needs the shared 'xywh' box vocabulary")

    def encode(self, inputs: Dict) -> Dict[str, torch.Tensor]:
        bbox = self.bbox_tokenizer.encode(torch.as_tensor(inputs["bbox"], dtype=torch.float32))
        dev = bbox.device
        label = torch.as_tensor(inputs["label"], device=dev).long()
        mask = torch.as_tensor(inputs["mask"], device=dev).bool()
        if self.pad_until_max:
            padn = self.max_elements - label.shape[1]
            if padn > 0:
                label = F.pad(label, (0, padn))
                bbox = F.pad(bbox, (0, 0, 0, padn))
                mask = F.pad(mask, (0, padn))
        bbox = bbox + self.N_category
        if "pad" in self.special_tokens:
            pad_id = self.name_to_id("pad")
            label = torch.where(mask, label, pad_id)
            bbox = torch.where(mask[..., None], bbox, pad_id)
        out = {"label": label, "bbox": bbox, "mask": mask}
        if "bos" in self.special_tokens and "eos" in self.special_tokens:
            B, S = label.shape
            label = torch.cat([torch.full((B, 1), self.name_to_id("bos"), device=dev), label], 1)
            bbox = torch.cat([torch.zeros((B, 1, 4), dtype=bbox.dtype, device=dev), bbox], 1)
            mask = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev), mask], 1)
            eos_here = torch.arange(S + 1, device=dev)[None, :] == mask.sum(dim=1, keepdim=True)
            out = {"label": torch.where(eos_here, self.name_to_id("eos"), label),
                   "bbox": bbox, "mask": mask | eos_here}
        return out

    def decode(self, inputs: Dict) -> Dict[str, torch.Tensor]:
        label = torch.as_tensor(inputs["label"])
        bbox_ids = torch.as_tensor(inputs["bbox"]) - self.N_category
        if "mask" in inputs:
            invalid = ~torch.as_tensor(inputs["mask"]).bool()
        else:
            invalid = torch.zeros_like(label, dtype=torch.bool)
        invalid = invalid | self._filter_eos(label)
        label_valid = (0 <= label) & (label < self.N_category)
        bbox_valid = torch.all((0 <= bbox_ids) & (bbox_ids < self.N_bbox), -1)
        invalid = invalid | ~(label_valid & bbox_valid)
        bbox = self.bbox_tokenizer.decode(bbox_ids)
        return {"bbox": torch.where(invalid[..., None], 0.0, bbox),
                "label": torch.where(invalid, 0, label), "mask": ~invalid}
