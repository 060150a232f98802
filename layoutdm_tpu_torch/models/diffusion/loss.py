"""Training objective of mask-and-replace diffusion (port of
``layoutdm_tpu/models/diffusion/loss.py``; reference
`categorical_diffusion/vanilla.py:160-240`, `constrained.py:232-333`).

Reweighted KL(q_post(x0, xt) || q_post(x̂0, xt)) + decoder NLL at t=0 +
auxiliary KL on x̂0, importance-weighted by 1/pt, with timesteps
importance-sampled from an EMA of squared losses.  The EMA buffers are an
explicit ``LtState`` carried by the caller: ``(losses, new_state) =
diffusion_loss(..., state)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from layoutdm_tpu_torch.ops.log_math import log_onehot


@dataclass
class LtState:
    """Importance-sampling EMA buffers (`base.py:106-107`)."""

    history: torch.Tensor  # (T,) float32
    count: torch.Tensor  # (T,) float32

    @classmethod
    def init(cls, num_timesteps: int, device) -> "LtState":
        z = torch.zeros((num_timesteps,), dtype=torch.float32, device=device)
        return cls(history=z, count=z.clone())


def importance_weights(state: LtState) -> torch.Tensor:
    """(T,) sampling probabilities ∝ sqrt(EMA of squared loss), with the
    decoder term's weight set to L1's (`base.py:179-200`)."""
    lt_sqrt = torch.sqrt(state.history + 1e-10) + 1e-4
    lt_sqrt = torch.cat([lt_sqrt[1:2], lt_sqrt[1:]])
    return lt_sqrt / lt_sqrt.sum()


def sample_time(
    generator: torch.Generator, state: LtState, batch_size: int, num_timesteps: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, pt): importance-sampled once every bucket has >10 visits, else
    uniform.  Both draws are made and one is selected on the device, so
    the step never waits on the host.  ``generator`` lives on the state's
    device."""
    dev = state.history.device
    pt_all = importance_weights(state)
    use_importance = (state.count > 10).all()
    t_imp = torch.multinomial(pt_all, batch_size, replacement=True, generator=generator)
    t_unif = torch.randint(
        0, num_timesteps, (batch_size,), generator=generator, device=dev
    )
    t = torch.where(use_importance, t_imp, t_unif)
    pt = torch.where(
        use_importance, pt_all[t], torch.full_like(pt_all[t], 1.0 / num_timesteps)
    )
    return t, pt


def update_lt_state(state: LtState, t: torch.Tensor, lt2: torch.Tensor) -> LtState:
    """One EMA step per visited t by the MEAN of the batch's squared losses
    at that t (`loss.py:117-127` of the JAX package); the reference's
    scatter keeps whichever write lands last.  Segment sums go through a
    one-hot product, which has a fixed summation order on any device."""
    onehot = F.one_hot(t, state.history.shape[0]).to(lt2.dtype)  # (B, T)
    sum_t = lt2 @ onehot
    cnt_t = onehot.sum(dim=0)
    mean_t = sum_t / torch.clamp(cnt_t, min=1.0)
    history = torch.where(
        cnt_t > 0, 0.1 * mean_t + 0.9 * state.history, state.history
    )
    return LtState(history=history, count=state.count + cnt_t)


def diffusion_loss(
    q,  # ConstrainedQ
    predict_start: Callable,  # (ids, t, dropout) -> log p(x0 | x_t)
    seq: torch.Tensor,  # (B, S) clean token ids
    lt_state: LtState,
    generator: Optional[torch.Generator] = None,
    dropout=None,
    auxiliary_loss_weight: float = 1e-1,
    is_train: bool = True,
    t: Optional[torch.Tensor] = None,
    pt: Optional[torch.Tensor] = None,
    xt: Optional[torch.Tensor] = None,
):
    """Returns (losses dict, new LtState).

    ``t``/``pt``/``xt`` may be injected (``t`` and ``pt`` together) to pin
    the timesteps, their importance weights and the corrupted sequence;
    otherwise they are drawn from ``generator``.  ``dropout`` (a
    `models.nn.Dropout`) runs the denoiser in training mode; the auxiliary
    loss is on whenever ``is_train``."""
    B, S = seq.shape
    V, T = q.num_classes, q.num_timesteps
    if t is None:
        t, pt = sample_time(generator, lt_state, B, T)
    if xt is None:
        xt = q.corrupt(seq, t, generator)

    log_x_start = log_onehot(seq, V)
    log_x0_recon = predict_start(xt, t, dropout)
    log_model_prob = q.q_posterior_ids(log_x0_recon, xt, t)
    log_true_prob = q.q_posterior_ids(log_x_start, xt, t)

    # KL between the two posteriors (`vanilla.py:197-206`), mean over positions
    kl = (torch.exp(log_true_prob) * (log_true_prob - log_model_prob)).sum(-1).mean(-1)
    decoder_nll = -(torch.exp(log_x_start) * log_model_prob).sum(-1).mean(-1)
    is_t0 = (t == 0).to(torch.float32)
    kl_loss = is_t0 * decoder_nll + (1.0 - is_t0) * kl

    new_state = update_lt_state(lt_state, t, kl_loss.detach() ** 2)

    losses = {"kl_loss": (kl_loss / pt).mean()}
    if auxiliary_loss_weight > 0 and is_train:
        x0 = log_x_start[..., :-1]
        kl_aux = (torch.exp(x0) * (x0 - log_x0_recon[..., :-1])).sum(-1).mean(-1)
        kl_aux_loss = is_t0 * decoder_nll + (1.0 - is_t0) * kl_aux
        weight = (1 - t / T) + 1.0  # adaptive (`vanilla.py:230-233`)
        losses["aux_loss"] = (weight * auxiliary_loss_weight * kl_aux_loss / pt).mean()
    return losses, new_state
