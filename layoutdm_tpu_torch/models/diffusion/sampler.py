"""The T-step reverse diffusion for every task (port of
``layoutdm_tpu/models/diffusion/sampler.py``; reference
`categorical_diffusion/base.py:205-371`).

Each conditional task is a branch-free logit manipulation inside the chain:
strong constraints by replacement, the refinement prior by addition,
relation guidance by a few gradient steps on the log-probs (a
``guidance_fn``, `relation.guidance`), PAD suppression by a mask write.
The JAX package runs the chain as one ``lax.scan``; here it is a Python
loop over a host-side timestep ladder.

Randomness: ``rng`` is either a ``torch.Generator`` (whole-batch noise) or a
(B,) int64 tensor of row seeds (the per-row regime the server coalesces
with): row b's Gumbel draws at step i come from `row_gumbel` keyed by
(seed b, counter i), so a row's trajectory never depends on its batch-mates.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from layoutdm_tpu_torch.configs import SamplingConfig
from layoutdm_tpu_torch.ops.log_math import LOG_EPS, log_onehot
from layoutdm_tpu_torch.ops.samplers import (
    gumbel_noise,
    num_draws,
    row_gumbel,
    sample_tokens,
)
from layoutdm_tpu_torch.utils.profiling import span


@dataclass
class SamplerCond:
    """Conditioning inputs of the reverse chain.  A no-op cond (all-False
    masks, zero weak logits) is unconditional sampling.  ``weak_logits`` is
    (B, S, V), or a broadcastable (B, 1, 1) zero when no prior applies.
    ``relation`` (a `relation.guidance.RelationData`) carries the rows'
    constraint graphs for relation guidance."""

    seq: torch.Tensor  # (B, S) int64 — user-specified token values
    strong_mask: torch.Tensor  # (B, S) bool — hard replacement positions
    weak_logits: torch.Tensor  # (B, S, V) or (B, 1, 1) f32 — additive prior
    weak_mask: torch.Tensor  # (B, S) bool — where the prior applies
    pad_suppress: torch.Tensor  # (B, S) bool — forbid PAD here
    init_from_seq: bool = False
    relation: Optional[tuple] = None  # RelationData, (B, E, ...) tensors

    TENSORS = ("seq", "strong_mask", "weak_logits", "weak_mask", "pad_suppress")

    @classmethod
    def empty(cls, batch_size: int, seq_len: int, device):
        B, S = batch_size, seq_len
        return cls(
            seq=torch.zeros((B, S), dtype=torch.int64, device=device),
            strong_mask=torch.zeros((B, S), dtype=torch.bool, device=device),
            weak_logits=torch.zeros((B, 1, 1), device=device),
            weak_mask=torch.zeros((B, S), dtype=torch.bool, device=device),
            pad_suppress=torch.zeros((B, S), dtype=torch.bool, device=device),
        )

    def to(self, device) -> "SamplerCond":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in self.TENSORS},
            relation=None if self.relation is None else self.relation.to(device),
        )

    @classmethod
    def cat(cls, conds: Sequence["SamplerCond"]) -> "SamplerCond":
        """Stack row groups (same init mode, weak-logit width and, where
        the rows carry graphs, edge capacity); graphs stay with their rows."""
        graphs = [c.relation for c in conds]
        if any(g is None for g in graphs) and any(g is not None for g in graphs):
            raise ValueError("rows with and without relation graphs in one batch")
        return cls(
            **{k: torch.cat([getattr(c, k) for c in conds]) for k in cls.TENSORS},
            init_from_seq=conds[0].init_from_seq,
            relation=None if graphs[0] is None else type(graphs[0]).cat(graphs),
        )


def timestep_ladder(
    num_timesteps: int,
    num_timesteps_eval: Optional[int] = None,
    time_difference: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side schedule of (model_t, posterior_t) per reverse step
    (`base.py:310-315` skip-step ladder, `base.py:218-240` time difference)."""
    T = num_timesteps
    T_eval = num_timesteps_eval or T
    if T_eval > T:
        raise ValueError(f"num_timesteps_eval {T_eval} > num_timesteps {T}")
    idxs = [int(i * T / T_eval) for i in range(T_eval - 1, -1, -1)]
    model_t, post_t = [], []
    prev = T
    for idx in idxs:
        skip = (prev - idx) - 1
        if time_difference > 0.0:
            noise = int(np.clip(idx - int(T * time_difference), 0, T - 1))
        else:
            noise = idx
        pt = noise - skip if (skip > 0 and noise > skip) else noise
        model_t.append(idx)
        post_t.append(pt)
        prev = idx
    return np.asarray(model_t, np.int32), np.asarray(post_t, np.int32)


def make_predict_start(apply_fn: Callable, num_classes: int):
    """Wrap the denoiser into p(x0 | x_t): log-softmax over the non-MASK
    classes, MASK lane pinned at -70, clipped to [-70, 0] (`base.py:127-146`).
    Takes x_t as token ids (B, S); a ``dropout`` (`models.nn.Dropout`) runs
    the denoiser in training mode."""

    def predict_start(ids: torch.Tensor, t: torch.Tensor, dropout=None) -> torch.Tensor:
        # (B, S, V) float32
        with span("layoutdm.denoise"):
            logits = apply_fn(ids, t) if dropout is None else apply_fn(ids, t, dropout)
        log_pred = torch.log_softmax(logits[..., :-1], dim=-1)
        mask_lane = torch.full_like(log_pred[..., :1], -70.0)
        return torch.clamp(torch.cat([log_pred, mask_lane], dim=-1), -70.0, 0.0)

    return predict_start


def sample_chain(
    predict_start: Callable,
    q,
    rng: Union[torch.Generator, torch.Tensor],
    cond: SamplerCond,
    sampling: SamplingConfig,
    pad_id: int,
    num_timesteps_eval: Optional[int] = None,
    get_intermediates: bool = False,
    guidance_fn: Optional[Callable] = None,
):
    """Run the reverse chain; returns final token ids (B, S) [and the
    stacked per-step ids if requested].  ``guidance_fn(log_probs, t, cond)``
    adjusts each step's log-probs after the task constraints and before the
    PAD suppression, ``t`` the step's model timestep."""
    V = q.num_classes
    B, S = cond.seq.shape
    dev = cond.seq.device
    per_row = isinstance(rng, torch.Tensor)
    if per_row and rng.shape[0] != B:
        raise ValueError(f"per-row seed batch {rng.shape[0]} != cond batch {B}")

    model_t, post_t = timestep_ladder(
        q.num_timesteps, num_timesteps_eval, sampling.time_difference
    )
    if cond.init_from_seq:
        ids = cond.seq.long()
    else:
        ids = torch.full((B, S), V - 1, dtype=torch.int64, device=dev)

    strong_log = log_onehot(cond.seq, V)
    strong = cond.strong_mask[..., None]
    weak = torch.where(cond.weak_mask[..., None], cond.weak_logits, 0.0)
    lane_is_pad = torch.arange(V, device=dev) == pad_id
    pad_off = cond.pad_suppress[..., None] & lane_is_pad
    n_draw = num_draws(sampling.name)

    steps = []
    for i, (mt, pt) in enumerate(zip(model_t.tolist(), post_t.tolist())):
        with span("layoutdm.step"):
            log_x_recon = predict_start(
                ids, torch.full((B,), mt, dtype=torch.int64, device=dev)
            )
            mlp = q.q_posterior_ids(
                log_x_recon, ids, torch.full((B,), pt, dtype=torch.int64, device=dev)
            )
            mlp = torch.where(strong, strong_log, mlp)  # `base.py:246-251`
            mlp = mlp + weak  # `base.py:254-258`
            if guidance_fn is not None:
                mlp = guidance_fn(mlp, mt, cond)  # `base.py:261-269`
            mlp = torch.where(pad_off, LOG_EPS, mlp)  # `base.py:272-284`

            noise = None
            if n_draw and per_row:
                noise = torch.stack(
                    [row_gumbel(rng, i * n_draw + d, mlp.shape) for d in range(n_draw)]
                )
            elif n_draw:
                noise = gumbel_noise(rng, (n_draw,) + tuple(mlp.shape), device=dev)
            ids = sample_tokens(
                mlp, sampling.name, temperature=sampling.temperature,
                top_k=sampling.top_k, top_p=sampling.top_p, noise=noise,
            )
            if get_intermediates:
                steps.append(ids)
    if get_intermediates:
        return ids, torch.stack(steps)
    return ids
