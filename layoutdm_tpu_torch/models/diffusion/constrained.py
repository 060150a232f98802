"""Constrained mask-and-replace diffusion — LayoutDM's per-attribute Q
(port of ``layoutdm_tpu/models/diffusion/constrained.py``;
reference `models/categorical_diffusion/constrained.py:27-333`).

The layout lives as one (B, S_elem, A, Vp) tensor in the converter's padded
partial-lane space and the per-attribute schedules are stacked into
(A, T[+1]) tables, so every q_* op is one broadcasted computation over the
attribute axis.  Dead lanes stay pinned to LOG_EPS.  The forward process
(`q_sample`, `corrupt`) draws x_t by Gumbel-argmax; its noise is an argument,
or comes from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from layoutdm_tpu_torch.ops.log_math import (
    LOG_EPS,
    ScheduleTables,
    log_add_exp,
    log_onehot,
    posterior_tail,
)
from layoutdm_tpu_torch.ops.samplers import gumbel_noise
from layoutdm_tpu_torch.tokenizer.converter import Converter
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer


def _at(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(A, T) table gathered at t (B,) -> (B, 1, A, 1)."""
    return table[:, t].T[:, None, :, None]


class ConstrainedQ:
    def __init__(
        self,
        tokenizer: LayoutSequenceTokenizer,
        num_timesteps: int = 100,
        att_1: float = 0.99999,
        att_T: float = 0.000009,
        ctt_1: float = 0.000009,
        ctt_T: float = 0.99999,
        *,
        device,
    ):
        self.tokenizer = tokenizer
        self.converter = Converter.build(tokenizer)
        self.num_timesteps = num_timesteps
        self.num_classes = tokenizer.N_total
        cv = self.converter
        self.A, self.Vp, self.Vf = cv.A, cv.Vp, cv.Vf
        self.mask_id = tokenizer.name_to_id("mask")

        # one schedule per attribute with N = mat_size - 1
        # (`constrained.py:56-90`), stacked over the attribute axis
        stacked: dict = {}
        for a in range(cv.A):
            tabs = ScheduleTables(
                num_timesteps, N=int(cv.n_normal[a]),
                att_1=att_1, att_T=att_T, ctt_1=ctt_1, ctt_T=ctt_T,
            ).stacked()
            for k, v in tabs.items():
                stacked.setdefault(k, []).append(v)
        self.tables = {
            k: torch.as_tensor(np.stack(v), device=device)
            for k, v in stacked.items()
        }
        # (1, 1, A, Vp-1): which non-MASK lanes are real for each attribute
        self.normal_valid = torch.as_tensor(
            cv.lane_valid[:, :-1][None, None], device=device
        )

    def _mask_dead(self, normal: torch.Tensor) -> torch.Tensor:
        return torch.where(self.normal_valid, normal, LOG_EPS)

    def q_pred_one_timestep(self, log_x_t: torch.Tensor, t: torch.Tensor):
        """q(x_t | x_{t-1}) per attribute (`constrained.py:92-110`)."""
        tb = self.tables
        real = log_add_exp(
            log_x_t[..., :-1] + _at(tb["log_at"], t), _at(tb["log_bt"], t)
        )
        mask = log_add_exp(
            log_x_t[..., -1:] + _at(tb["log_1_min_ct"], t), _at(tb["log_ct"], t)
        )
        return torch.cat([self._mask_dead(real), mask], dim=-1)

    def q_pred(self, log_x_start: torch.Tensor, t: torch.Tensor):
        """q(x_t | x_0) per attribute (`constrained.py:112-133`); t = -1 wraps
        to the identity column T."""
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
        return torch.cat([self._mask_dead(real), mask], dim=-1)

    def q_posterior_ids(
        self, log_x_start: torch.Tensor, xt_ids: torch.Tensor, t: torch.Tensor
    ) -> torch.Tensor:
        """q(x_{t-1} | x_t, x̂_0) over the FULL vocab (B, S_tok, Vf), for
        observed x_t ids (B, S_tok): both q_pred evaluations on the one-hot
        x_t reduce to per-timestep scalars selected by lane."""
        cv = self.converter
        B, S_tok, _ = log_x_start.shape
        S = S_tok // cv.A

        log_x_start_p = cv.f_to_p_log(log_x_start.reshape(B, S, cv.A, self.Vf))
        ids_full = xt_ids.reshape(B, S, cv.A)
        is_mask = (ids_full == self.mask_id)[..., None]  # (B, S, A, 1)
        ids_p = cv.f_to_p_id(ids_full)
        lanes = torch.arange(self.Vp - 1, device=ids_p.device)
        hot = lanes == ids_p[..., None]  # (B, S, A, Vp-1)

        tb = self.tables
        lcat, lcbt = _at(tb["log_cumprod_at"], t), _at(tb["log_cumprod_bt"], t)
        lcct = _at(tb["log_cumprod_ct"], t)
        hot_c = log_add_exp(lcat, lcbt)
        cold_c = log_add_exp(LOG_EPS + lcat, lcbt)
        log_qt = torch.where(is_mask, lcct, torch.where(hot, hot_c, cold_c))
        log_qt = self._mask_dead(log_qt)

        lat, lbt, lct = _at(tb["log_at"], t), _at(tb["log_bt"], t), _at(tb["log_ct"], t)
        hot_1 = log_add_exp(lat, lbt)
        cold_1 = log_add_exp(LOG_EPS + lat, lbt)
        log_qt1_real = torch.where(is_mask, lct, torch.where(hot, hot_1, cold_1))
        log_qt1_real = self._mask_dead(log_qt1_real)
        log_qt1_mask = torch.where(
            is_mask,
            torch.zeros((), device=is_mask.device),
            torch.full((), LOG_EPS, device=is_mask.device),
        )
        log_qt1 = torch.cat([log_qt1_real, log_qt1_mask], dim=-1)

        out = posterior_tail(
            self.q_pred, log_x_start_p, log_qt, log_qt1, t,
            valid=self.normal_valid,
        )
        return cv.p_to_f_log(out).reshape(B, S_tok, self.Vf)

    def q_sample(
        self,
        log_x_start_p: torch.Tensor,
        t: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Sample x_t ~ q(x_t | x_0) in partial-lane space; returns lane ids
        (B, S, A).  Dead lanes sit at -1e9 and are never drawn.  ``noise``:
        Gumbel noise of the logits' shape, drawn from ``generator`` when
        omitted."""
        logits = self.q_pred(log_x_start_p, t)
        logits = torch.cat(
            [torch.where(self.normal_valid, logits[..., :-1], -1e9), logits[..., -1:]],
            dim=-1,
        )
        if noise is None:
            noise = gumbel_noise(generator, logits.shape, device=logits.device)
        return torch.argmax(logits + noise, dim=-1)

    def corrupt(
        self,
        seq_full: torch.Tensor,
        t: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Clean full-vocab ids (B, S_tok) -> corrupted ids x_t (B, S_tok):
        per-attribute `q_sample`, merged back to the full vocabulary
        (`constrained.py:243-260`).  The JAX package also returns x_t's log
        one-hot; the loss reads only the ids, so it is not built here."""
        cv = self.converter
        B, S_tok = seq_full.shape
        ids_p = cv.f_to_p_id(seq_full.reshape(B, S_tok // cv.A, cv.A))
        lanes = self.q_sample(log_onehot(ids_p, self.Vp), t, generator, noise)
        return cv.p_to_f_id(lanes).reshape(B, S_tok)
