"""Relation-constraint gradient guidance inside the reverse chain (port of
``layoutdm_tpu/relation/guidance.py``; reference
`categorical_diffusion/logit_adjustment.py:16-126`).

At each step with t >= 10 the step's log-probs take K =
``relation_num_update`` gradient steps of size ``relation_lambda`` on the
mean of the 14 constraint penalties of the layout they decode to (Eq. 7).
The gradient is taken with respect to the log-probs only, never through
the denoiser, so no attention backward runs.  The reference mutates a
parameter with an SGD optimizer; the JAX package takes ``jax.grad``; here
it is ``torch.autograd.grad``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from layoutdm_tpu_torch.configs import SamplingConfig
from layoutdm_tpu_torch.ops.samplers import gumbel_noise
from layoutdm_tpu_torch.relation.const import relation_losses
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer

GUIDED_FROM_T = 10  # guidance runs at model timesteps t >= 10 (`logit_adjustment.py:107`)

# gumbel(t, k, coord, shape) -> noise for coordinate ``coord`` at update k of step t
GumbelSource = Callable[[int, int, int, tuple], torch.Tensor]


class RelationData(NamedTuple):
    """A batch's padded relation graphs over the canvas-prepended element
    indexing (canvas = element 0)."""

    edge_index: torch.Tensor  # (B, E, 2) int64
    edge_attr: torch.Tensor  # (B, E) int64 bit flags
    edge_mask: torch.Tensor  # (B, E) bool
    src_is_canvas: torch.Tensor  # (B, E) bool

    @classmethod
    def from_batch(cls, batch: dict) -> "RelationData":
        """From a batch with the canvas element and the relation edges added
        (`data.transforms.AddCanvasElement`, `AddRelationConstraints`)."""
        ei = torch.as_tensor(np.asarray(batch["edge_index"]), dtype=torch.int64)
        label = torch.as_tensor(np.asarray(batch["label"]), dtype=torch.int64)
        return cls(
            edge_index=ei,
            edge_attr=torch.as_tensor(np.asarray(batch["edge_attr"]), dtype=torch.int64),
            edge_mask=torch.as_tensor(np.asarray(batch["edge_mask"]), dtype=torch.bool),
            src_is_canvas=torch.gather(label, 1, ei[..., 0]) == 0,
        )

    def to(self, device) -> "RelationData":
        return RelationData(*(x.to(device) for x in self))

    @classmethod
    def cat(cls, parts) -> "RelationData":
        return cls(*(torch.cat(xs) for xs in zip(*parts)))

    @classmethod
    def empty(cls, n: int, max_edges: int) -> "RelationData":
        """``n`` rows with no active edge (padding rows of a guided run)."""
        z = lambda *shape, dtype: torch.zeros(shape, dtype=dtype)
        return cls(z(n, max_edges, 2, dtype=torch.int64), z(n, max_edges, dtype=torch.int64),
                   z(n, max_edges, dtype=torch.bool), z(n, max_edges, dtype=torch.bool))


def quantized_canvas_bbox(tokenizer: LayoutSequenceTokenizer) -> torch.Tensor:
    """The canvas box [0.5, 0.5, 1, 1] after encode -> decode, (1, 1, 4)."""
    bb = tokenizer.bbox_tokenizer
    return bb.decode(bb.encode(torch.tensor([[0.5, 0.5, 1.0, 1.0]]))).reshape(1, 1, 4)


def expected_bbox(
    log_prob: torch.Tensor,  # (B, S_tok, Vf)
    tokenizer: LayoutSequenceTokenizer,
    elem_mask: torch.Tensor,  # (B, S_elem) valid (non-PAD) elements
    canvas: Optional[torch.Tensor] = None,  # (1, 1, 4)
    mode: str = "average",
    tau: float = 1.0,
    gumbels=None,  # mode "gumbel": one noise tensor per coordinate, var order
) -> torch.Tensor:
    """Differentiable decode of per-coordinate bin log-probs to boxes
    (`logit_adjustment.py:16-85`), (B, S_elem + 1, 4) with the canvas box
    prepended.  "average": the expectation of the bin centers under the
    softmax over each coordinate's bins.  "gumbel": a straight-through
    Gumbel-softmax hard sample at temperature ``tau`` (the forward value
    one bin center, the gradient the relaxed softmax's)."""
    if mode not in ("average", "gumbel"):
        raise ValueError(f"relation_mode must be 'average' or 'gumbel', got {mode!r}")
    if mode == "gumbel" and gumbels is None:
        raise ValueError("mode='gumbel' needs Gumbel noise")
    C = tokenizer.N_var_per_element
    B, S_tok, Vf = log_prob.shape
    bb = tokenizer.bbox_tokenizer
    lp4 = log_prob.reshape(B, S_tok // C, C, Vf)
    coords = []
    for k, key in enumerate(bb.var_order):
        logits = lp4[:, :, k + 1, tokenizer.get_slice(key)]  # (B, S, nbins)
        if mode == "gumbel":
            y_soft = torch.softmax((logits + gumbels[k]) / tau, dim=-1)
            y_hard = F.one_hot(y_soft.argmax(dim=-1), logits.shape[-1]).to(y_soft.dtype)
            probs = y_hard + y_soft - y_soft.detach()  # hard forward, soft backward
        else:
            probs = torch.softmax(logits, dim=-1)
        centers = torch.as_tensor(bb.centers[("x", "y", "w", "h").index(key)],
                                  dtype=probs.dtype, device=probs.device)
        coords.append((probs * centers).sum(-1))
    order = [tuple(bb.var_order).index(k) for k in ("x", "y", "w", "h")]
    elem = torch.stack([coords[i] for i in order], dim=-1)  # (B, S, 4)
    elem = torch.where(elem_mask[..., None], elem, torch.zeros_like(elem))
    if canvas is None:
        canvas = quantized_canvas_bbox(tokenizer)
    canvas = canvas.to(elem.device, elem.dtype).expand(B, 1, 4)
    return torch.cat([canvas, elem], dim=1)


def make_relation_guidance(
    tokenizer: LayoutSequenceTokenizer,
    sampling: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[GumbelSource] = None,
):
    """``guidance_fn(log_probs, t, cond)`` for `sample_chain`: reads the
    graph from ``cond.relation`` (no graph, no change) and, at t >= 10,
    takes ``relation_num_update`` steps of size ``relation_lambda`` down
    the gradient of the mean penalty (`guidance.py:126-200`).

    ``sampling.relation_mode`` "gumbel" draws fresh noise for every update
    from ``generator`` (on any device), or takes it from ``gumbel`` (tests
    inject the JAX package's draws: its streams cannot be reproduced)."""
    K = sampling.relation_num_update
    lr = sampling.relation_lambda
    mode, tau = sampling.relation_mode, sampling.relation_tau
    if mode not in ("average", "gumbel"):
        raise ValueError(f"sampling.relation_mode must be 'average' or 'gumbel', got {mode!r}")
    if mode == "gumbel" and gumbel is None:
        generator = generator or torch.Generator().manual_seed(0)
        gumbel = lambda t, k, coord, shape: gumbel_noise(generator, shape)
    pad_id = tokenizer.name_to_id("pad")
    C = tokenizer.N_var_per_element
    canvas = quantized_canvas_bbox(tokenizer)
    n_coords = len(tokenizer.bbox_tokenizer.var_order)

    def guidance(log_prob: torch.Tensor, t: int, cond) -> torch.Tensor:
        r = cond.relation
        if r is None or t < GUIDED_FROM_T:
            return log_prob
        elem_mask = cond.seq[:, ::C] != pad_id
        lp = log_prob.detach()
        with torch.enable_grad():
            for k in range(K):
                lp = lp.detach().requires_grad_()
                gumbels = None
                if mode == "gumbel":
                    shape = (lp.shape[0], lp.shape[1] // C, tokenizer.N_bbox_per_var)
                    gumbels = [gumbel(t, k, i, shape).to(lp.device, lp.dtype)
                               for i in range(n_coords)]
                bbox_all = expected_bbox(lp, tokenizer, elem_mask, canvas, mode, tau, gumbels)
                loss = relation_losses(bbox_all, *r).mean()
                (grad,) = torch.autograd.grad(loss, lp)
                lp = lp - lr * grad
        return lp.detach()

    return guidance
