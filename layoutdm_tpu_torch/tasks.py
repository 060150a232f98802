"""Conditional-generation task conditions (port of ``layoutdm_tpu/tasks.py``;
reference `helpers/task.py:27-248`).

``get_cond`` turns a dense (label, bbox, mask) batch into a token-level
condition for unconditional / c / cwh / partial / refinement / gt / random;
``to_sampler_cond`` lowers it into `SamplerCond`.  The random tasks draw
from a ``torch.Generator``, or take their draws injected through ``noise``
(``{"scores", "topk"}`` for partial, ``{"bbox"}`` standard normals for
refinement, ``{"ratio", "scores"}`` for random) so a test can feed both
packages the same numbers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from layoutdm_tpu_torch.configs import SamplingConfig
from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond
from layoutdm_tpu_torch.ops.masking import batch_topk_mask, sample_mask
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer

MAX_PARTIAL_RATIO = 0.3  # `task.py:15`
COND_TYPES = ("c", "cwh", "partial", "gt", "random", "refinement", "relation")


def _as_tensor(x, device) -> torch.Tensor:
    """An injected draw (numpy or a tensor on any device) on ``device``."""
    return (x if torch.is_tensor(x) else torch.tensor(np.asarray(x))).to(device)


def get_cond(
    batch: Dict[str, Any],
    tokenizer: LayoutSequenceTokenizer,
    cond_type: str = "c",
    model_type: str = "LayoutDM",
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Build the task condition from a ground-truth batch (`task.py:27-151`).
    Only the no-BOS (diffusion) layout and the BOS compaction of partial are
    handled, as in the JAX package."""
    if cond_type not in COND_TYPES:
        raise ValueError(f"unknown cond_type {cond_type!r}")
    noise = noise or {}
    pad_id = tokenizer.name_to_id("pad")
    mask_id = (
        tokenizer.name_to_id("mask") if "mask" in tokenizer.special_tokens else -1
    )
    C = tokenizer.N_var_per_element
    has_bos = "bos" in tokenizer.special_tokens
    start = 1 if has_bos else 0

    cond = dict(tokenizer.encode(batch))
    dev = cond["seq"].device
    elem_mask = torch.as_tensor(batch["mask"], device=dev).bool()
    B, S = cond["seq"].shape

    def draw(key, make):
        if key in noise:
            return _as_tensor(noise[key], dev)
        return make()

    if cond_type == "partial":
        # keep a random <=30% prefix-worth of valid elements (`task.py:62-92`)
        n_elem = (S - start) // C
        scores = draw("scores", lambda: torch.rand(
            (B, n_elem), generator=generator).to(dev))
        topk_raw = draw("topk", lambda: torch.randint(
            1, 10_000, (B,), generator=generator).to(dev))
        mask_e = cond["mask"][:, start::C]
        n_valid = mask_e.sum(dim=1)
        vmax = torch.clamp(
            ((n_valid - 1) * MAX_PARTIAL_RATIO).to(torch.int64), min=1
        )
        topk = topk_raw.long() % vmax + 1
        topk = torch.minimum(topk, torch.clamp(n_valid, min=1))
        keep_e, _ = batch_topk_mask(scores, topk, mask=mask_e)
        keep = torch.repeat_interleave(keep_e, C, dim=1)
        if has_bos:
            # order-sensitive models: shift kept tokens to the front
            keep_full = torch.cat(
                [torch.ones((B, 1), dtype=torch.bool, device=dev), keep], dim=1
            )
            order = torch.argsort((~keep_full).to(torch.int8), dim=1, stable=True)
            compacted = torch.gather(cond["seq"], 1, order)
            counts = keep_full.sum(dim=1, keepdim=True)
            new_mask = torch.arange(keep_full.shape[1], device=dev)[None] < counts
            cond["seq"] = torch.where(new_mask, compacted, mask_id)
            cond["mask"] = new_mask
        else:
            cond["seq"] = torch.where(keep, cond["seq"], mask_id)
            cond["mask"] = keep

    elif cond_type in ("c", "cwh", "relation"):
        given = {"c": ("c",), "cwh": ("c", "w", "h"), "relation": ("c",)}[cond_type]
        attr_ind = (torch.arange(S, device=dev) - start) % C
        keep = torch.zeros((B, S), dtype=torch.bool, device=dev)
        for name in given:
            keep = keep | (attr_ind == tokenizer.var_names.index(name))[None, :]
        if has_bos:
            keep[:, 0] = True
        seq = torch.where(keep, cond["seq"], mask_id)
        # element count is known: write PAD into empty elements
        seq = torch.where(cond["mask"], seq, pad_id)
        cond["seq"] = seq
        cond["mask"] = (cond["mask"] & keep) | ~cond["mask"]

    elif cond_type == "gt":
        pass

    elif cond_type == "random":
        ratio = draw("ratio", lambda: torch.rand((B,), generator=generator).to(dev))
        scores = noise.get("scores")
        if scores is not None:
            scores = _as_tensor(scores, dev)
        loss_mask = sample_mask(
            torch.ones((B, S), dtype=torch.bool, device=dev), ratio,
            generator=generator, scores=scores,
        )
        cond["seq"] = torch.where(loss_mask, mask_id, cond["seq"])
        cond["mask"] = ~loss_mask

    elif cond_type == "refinement":
        # category kept, position/size re-encoded from noisy boxes
        # (`task.py:126-140`)
        bbox = torch.as_tensor(batch["bbox"], dtype=torch.float32, device=dev)
        normal = draw("bbox", lambda: torch.randn(
            bbox.shape, generator=generator).to(dev))
        noisy = tokenizer.encode(
            {"label": batch["label"], "bbox": bbox + 0.1 * normal,
             "mask": batch["mask"]}
        )
        idx = (torch.arange(S, device=dev) - start) % C
        keep = (noisy["mask"] & (idx == 0)[None, :]) | ~noisy["mask"]
        if has_bos:
            keep[:, 0] = True
        if model_type in ("LayoutDM", "ElemWiseAutoreg", "layoutdm", "autoreg",
                          "elem_wise_autoreg"):
            seq = torch.where(keep, noisy["seq"], mask_id)
            seq = torch.where(noisy["mask"], seq, pad_id)
        else:
            seq = noisy["seq"]
        cond = {"seq": seq, "mask": keep, "seq_orig": noisy["seq"]}

    cond["type"] = cond_type
    if cond_type in ("c", "cwh", "refinement", "relation"):
        cond["num_element"] = elem_mask.sum(dim=1)
    return cond


def smoothed_onehot_matrix(
    tokenizer: LayoutSequenceTokenizer,
    mode: str = "uniform",
    offset_ratio: float = 0.2,
) -> np.ndarray:
    """(Vf, Vf) prior kernel: identity plus, within each coordinate's
    sub-vocabulary, a neighborhood on the bin CENTERS (`task.py:154-201`)."""
    if mode not in ("uniform", "gaussian", "negative"):
        raise ValueError(f"refine mode {mode!r}")
    V = tokenizer.N_total
    N = tokenizer.N_bbox_per_var
    logits = np.eye(V, dtype=np.float32)

    bb = tokenizer.bbox_tokenizer
    for key in bb.var_order:
        if bb.shared_vocab == "xywh":
            sl = slice(tokenizer.N_category, tokenizer.N_category + N)
        else:
            mult = ("x", "y", "w", "h").index(key)
            sl = slice(
                tokenizer.N_category + mult * N,
                tokenizer.N_category + (mult + 1) * N,
            )
        centers = bb.centers[("x", "y", "w", "h").index(key)]
        ii, jj = np.meshgrid(centers, centers, indexing="ij")
        if mode == "uniform":
            block = (np.abs(ii - jj) < offset_ratio).astype(np.float32)
        elif mode == "negative":
            block = (np.abs(ii - jj) >= offset_ratio).astype(np.float32)
        else:  # gaussian
            block = -1.0 * (ii - jj) ** 2
        logits[sl, sl] = block
    return logits


def refinement_weak_logits(
    cond: Dict[str, Any],
    tokenizer: LayoutSequenceTokenizer,
    sampling: SamplingConfig,
) -> torch.Tensor:
    """(B, S, Vf) additive prior for refinement (`task.py:204-224`)."""
    w = sampling.refine_lambda
    if sampling.refine_mode == "negative":
        w = -w
    table = smoothed_onehot_matrix(
        tokenizer, mode=sampling.refine_mode,
        offset_ratio=sampling.refine_offset_ratio,
    )
    seq_orig = torch.as_tensor(cond["seq_orig"])
    return torch.as_tensor(table, device=seq_orig.device)[seq_orig] * w


def to_sampler_cond(
    cond: Optional[Dict[str, Any]],
    tokenizer: LayoutSequenceTokenizer,
    sampling: SamplingConfig,
    batch_size: Optional[int] = None,
    device=None,
) -> SamplerCond:
    """Lower a task cond dict into `SamplerCond` (on ``device``, default the
    cond's); ``cond=None`` is unconditional.  A single-example cond is
    broadcast to ``batch_size`` (`task.py:235-248`)."""
    S = tokenizer.max_token_length
    if cond is None:
        if batch_size is None:
            raise ValueError("unconditional lowering needs batch_size")
        return SamplerCond.empty(batch_size, S, device or "cpu")

    seq = torch.as_tensor(cond["seq"], device=device).long()
    dev = seq.device
    strong = torch.as_tensor(cond["mask"], device=dev).bool()
    B = seq.shape[0]
    if batch_size and B == 1 and batch_size > 1:
        seq = seq.repeat(batch_size, 1)
        strong = strong.repeat(batch_size, 1)
        B = batch_size

    ctype = cond.get("type", "gt")
    pad_id = tokenizer.name_to_id("pad")
    C = tokenizer.N_var_per_element

    weak_logits = torch.zeros((B, S, tokenizer.N_total), device=dev)
    weak_mask = torch.zeros((B, S), dtype=torch.bool, device=dev)
    if ctype == "refinement":
        wl = refinement_weak_logits(cond, tokenizer, sampling).to(dev)
        if wl.shape[0] == 1 and B > 1:
            wl = wl.repeat(B, 1, 1)
        weak_logits = wl
        weak_mask = ~strong

    pad_suppress = torch.zeros((B, S), dtype=torch.bool, device=dev)
    if ctype in ("c", "cwh", "refinement", "relation"):
        start = 1 if "bos" in tokenizer.special_tokens else 0
        attr_idx = (torch.arange(S, device=dev) - start) % C
        pad_suppress = (attr_idx != 0)[None, :] & (seq != pad_id)
        if start:
            pad_suppress[:, 0] = False

    return SamplerCond(
        seq=seq,
        strong_mask=strong,
        weak_logits=weak_logits,
        weak_mask=weak_mask,
        pad_suppress=pad_suppress,
        init_from_seq=True,
    )
