"""Vanilla (VQDiffusion) mask-and-replace transition over the full
vocabulary (port of ``layoutdm_tpu/models/diffusion/vanilla.py``;
reference `models/categorical_diffusion/vanilla.py:20-240`).

One transition matrix whose action is closed-form in log space, vocabulary
LAST.  Per step t (classes 0..V-2 real, V-1 = [MASK]): a real class is
kept with probability at, replaced uniformly by one of the N = V-1 real
classes with bt each, or masked with ct; MASK is absorbing.  The forward
process (`q_sample`, `corrupt`) draws x_t by Gumbel-argmax; its noise is
an argument, or comes from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from layoutdm_tpu_torch.ops.log_math import (
    LOG_EPS,
    ScheduleTables,
    log_add_exp,
    log_onehot,
    posterior_tail,
)
from layoutdm_tpu_torch.ops.samplers import RowShard, draw_rows, gumbel_noise


def _at(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(T,) table gathered at t (B,) -> (B, 1, 1) (the reference's
    `extract`, `util.py:24-27`)."""
    return table[t][:, None, None]


class VanillaQ:
    def __init__(
        self,
        num_classes: int,
        num_timesteps: int = 100,
        att_1: float = 0.99999,
        att_T: float = 0.000009,
        ctt_1: float = 0.000009,
        ctt_T: float = 0.99999,
        *,
        device,
    ):
        self.num_classes = num_classes
        self.num_timesteps = num_timesteps
        tabs = ScheduleTables(
            num_timesteps, N=num_classes - 1,
            att_1=att_1, att_T=att_T, ctt_1=ctt_1, ctt_T=ctt_T,
        ).stacked()
        self.tables = {k: torch.as_tensor(v, device=device) for k, v in tabs.items()}

    def q_pred_one_timestep(self, log_x_t: torch.Tensor, t: torch.Tensor):
        """q(x_t | x_{t-1}) applied to a log distribution (`vanilla.py:74-88`)."""
        tb = self.tables
        real = log_add_exp(log_x_t[..., :-1] + _at(tb["log_at"], t), _at(tb["log_bt"], t))
        mask = log_add_exp(
            log_x_t[..., -1:] + _at(tb["log_1_min_ct"], t), _at(tb["log_ct"], t)
        )
        return torch.cat([real, mask], dim=-1)

    def q_pred(self, log_x_start: torch.Tensor, t: torch.Tensor):
        """q(x_t | x_0) (`vanilla.py:90-110`); t = -1 wraps to the identity
        row T."""
        tb = self.tables
        t = (t + (self.num_timesteps + 1)) % (self.num_timesteps + 1)
        real = log_add_exp(
            log_x_start[..., :-1] + _at(tb["log_cumprod_at"], t),
            _at(tb["log_cumprod_bt"], t),
        )
        mask = log_add_exp(
            log_x_start[..., -1:] + _at(tb["log_1_min_cumprod_ct"], t),
            _at(tb["log_cumprod_ct"], t),
        )
        return torch.cat([real, mask], dim=-1)

    def q_posterior_ids(
        self, log_x_start: torch.Tensor, xt_ids: torch.Tensor, t: torch.Tensor
    ) -> torch.Tensor:
        """q(x_{t-1} | x_t, x̂_0), VQDiffusion Eq. 5 in log space
        (`vanilla.py:112-151`), for observed x_t ids (B, S): both q_pred
        evaluations on the one-hot x_t reduce to per-timestep scalars
        selected by lane (hot, cold or MASK)."""
        tb = self.tables
        V = self.num_classes
        is_mask = (xt_ids == V - 1)[..., None]  # (B, S, 1)
        lanes = torch.arange(V - 1, device=xt_ids.device)
        hot = lanes == xt_ids[..., None]  # (B, S, V-1)

        lcat, lcbt = _at(tb["log_cumprod_at"], t), _at(tb["log_cumprod_bt"], t)
        lcct = _at(tb["log_cumprod_ct"], t)
        hot_c = log_add_exp(lcat, lcbt)
        cold_c = log_add_exp(LOG_EPS + lcat, lcbt)
        log_qt = torch.where(is_mask, lcct, torch.where(hot, hot_c, cold_c))

        lat, lbt, lct = _at(tb["log_at"], t), _at(tb["log_bt"], t), _at(tb["log_ct"], t)
        hot_1 = log_add_exp(lat, lbt)
        cold_1 = log_add_exp(LOG_EPS + lat, lbt)
        log_qt1_real = torch.where(is_mask, lct, torch.where(hot, hot_1, cold_1))
        log_qt1_mask = torch.where(
            is_mask,
            torch.zeros((), device=is_mask.device),
            torch.full((), LOG_EPS, device=is_mask.device),
        )
        log_qt1 = torch.cat([log_qt1_real, log_qt1_mask], dim=-1)
        return posterior_tail(self.q_pred, log_x_start, log_qt, log_qt1, t)

    def q_sample(
        self,
        log_x_start: torch.Tensor,
        t: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        rows: Optional[RowShard] = None,
    ) -> torch.Tensor:
        """x_t ~ q(x_t | x_0) by Gumbel-argmax; returns ids
        (`vanilla.py:153-158`).  ``noise``: Gumbel noise of the logits'
        shape, drawn from ``generator`` when omitted."""
        logits = self.q_pred(log_x_start, t)
        if noise is None:
            noise = draw_rows(rows, lambda sh: gumbel_noise(generator, sh, device=logits.device),
                              logits.shape)
        return torch.argmax(logits + noise, dim=-1)

    def corrupt(
        self,
        seq: torch.Tensor,
        t: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        rows: Optional[RowShard] = None,
    ) -> torch.Tensor:
        """Clean ids (B, S) -> corrupted ids x_t, the interface of
        `ConstrainedQ.corrupt` (the JAX package also returns x_t's log
        one-hot; the loss reads only the ids)."""
        return self.q_sample(log_onehot(seq, self.num_classes), t, generator, noise, rows)
