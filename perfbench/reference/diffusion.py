"""LayoutDM's constrained mask-and-replace diffusion, written out plainly
(reference implementation in float32; no import of the program).

Each attribute of an element (category, x, y, w, h) diffuses over its own
tokens plus PAD (``N`` normal classes) and MASK, with the VQ-Diffusion
schedule: per step a token stays with probability ``a_t``, moves to any
normal class with ``b_t`` each, and becomes MASK with ``c_t``
(LayoutDM, Inoue et al. 2023, section 3; VQ-Diffusion, Gu et al. 2022,
eq. 5 for the posterior).  Probabilities are kept as logs; ``log 0`` is
``log 1e-30``, and results are clipped to [-70, 0] as in the paper's code.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference.tokens import Vocab

LOG0 = math.log(1e-30)


def schedule(T: int, N: int, att_1: float, att_T: float, ctt_1: float, ctt_T: float) -> Dict:
    """float64 log tables of one attribute: per step ``at, bt, ct`` (index
    t = 0..T-1) and cumulative ``catt, cbtt, cctt`` (index T stands for
    t = -1: nothing corrupted)."""
    att = np.concatenate(([1.0], np.linspace(att_1, att_T, T)))
    ctt = np.concatenate(([0.0], np.linspace(ctt_1, ctt_T, T)))
    at = att[1:] / att[:-1]
    ct = 1.0 - (1.0 - ctt[1:]) / (1.0 - ctt[:-1])
    bt = (1.0 - at - ct) / N
    catt = np.concatenate((att[1:], [1.0]))
    cctt = np.concatenate((ctt[1:], [0.0]))
    cbtt = (1.0 - catt - cctt) / N
    with np.errstate(divide="ignore"):
        out = {k: np.log(v) for k, v in dict(at=at, bt=bt, ct=ct, catt=catt, cbtt=cbtt,
                                              cctt=cctt).items()}
    out["1_ct"] = np.log(1.0 - ct + 1e-40)
    out["1_cctt"] = np.log(1.0 - cctt + 1e-40)
    return out


def _lae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp a + exp b), with -inf on both sides giving -inf."""
    m = torch.maximum(a, b)
    m0 = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.where(torch.isfinite(m), m0 + torch.log(torch.exp(a - m0) + torch.exp(b - m0)), m)


class Diffusion:
    """The schedule of every attribute and the operations the chain and the
    loss need, over the full vocabulary (B, S, V)."""

    def __init__(self, cfg: Dict, device):
        self.vocab = Vocab.of(cfg)
        self.T = cfg["num_timesteps"]
        self.device = device
        v = self.vocab
        self.lanes: List[torch.Tensor] = []
        self.tabs: List[Dict[str, torch.Tensor]] = []
        for a in range(5):
            toks = v.attr_tokens(a)
            self.lanes.append(torch.tensor(toks + [v.mask], device=device))
            s = schedule(self.T, len(toks), cfg["att_1"], cfg["att_T"], cfg["ctt_1"], cfg["ctt_T"])
            self.tabs.append({k: torch.tensor(x, dtype=torch.float32, device=device)
                              for k, x in s.items()})

    def _attr(self, x: torch.Tensor, a: int) -> torch.Tensor:
        """(B, S, ...) -> the positions of attribute ``a``: (B, E, ...)."""
        return x[:, a::5]

    def _q_pred(self, lx: torch.Tensor, tab: Dict, t: torch.Tensor, cum: bool) -> torch.Tensor:
        """q(x_t | x_0) (``cum``) or q(x_t | x_{t-1}) on (B, E, K+1) attribute
        log-probs; ``t`` (B,), -1 allowed for the cumulative form."""
        if cum:
            idx = torch.where(t < 0, self.T, t)
            a, b, c, c1 = (tab[k][idx][:, None, None] for k in ("catt", "cbtt", "cctt", "1_cctt"))
        else:
            a, b, c, c1 = (tab[k][t][:, None, None] for k in ("at", "bt", "ct", "1_ct"))
        real = _lae(lx[..., :-1] + a, b.expand_as(lx[..., :-1]))
        msk = _lae(lx[..., -1:] + c1, c.expand_as(lx[..., -1:]))
        return torch.cat([real, msk], -1)

    def _posterior_attr(self, lx0: torch.Tensor, xt: torch.Tensor, tab: Dict,
                        t: torch.Tensor) -> torch.Tensor:
        """q(x_{t-1} | x_t, x0 ~ exp(lx0)) over one attribute's K+1 lanes;
        ``xt`` holds lane indices (K = MASK)."""
        K = lx0.shape[-1] - 1
        onehot = torch.full_like(lx0, LOG0).scatter_(-1, xt[..., None], 0.0)
        is_mask = (xt == K)[..., None]
        qt = self._q_pred(onehot, tab, t, cum=True)[..., :-1]
        qt = torch.where(is_mask, tab["cctt"][t][:, None, None].expand_as(qt), qt)
        q1 = self._q_pred(onehot, tab, t, cum=False)[..., :-1]
        q1 = torch.where(is_mask, tab["ct"][t][:, None, None].expand_as(q1), q1)
        q1 = torch.cat([q1, torch.where(is_mask, 0.0, LOG0)], -1)
        q = torch.cat([lx0[..., :-1] - qt, torch.full_like(lx0[..., -1:], LOG0)], -1)
        lse = torch.logsumexp(q, -1, keepdim=True)
        out = self._q_pred(q - lse, tab, t - 1, cum=True) + q1 + lse
        return out.clamp(-70.0, 0.0)

    def _to_lanes(self, ids: torch.Tensor, a: int) -> torch.Tensor:
        """Full-vocabulary ids of attribute ``a`` -> its lane indices.  An id
        the attribute cannot hold is read as its first token, as LayoutDM's
        converter reads it.  (The chain can draw such an id: where PAD is
        forbidden and the posterior had all its mass on PAD, every token,
        the foreign ones at log 0 = log 1e-30 included, lies near the -70
        floor.)"""
        return (ids[..., None] == self.lanes[a]).float().argmax(-1)

    def posterior(self, log_x0: torch.Tensor, xt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """(B, S, V) log q(x_{t-1} | x_t, x0-hat) from the full-vocabulary
        prediction ``log_x0`` and the ids ``xt``; ids an attribute does not
        hold get log 0."""
        out = torch.full_like(log_x0, LOG0)
        for a in range(5):
            lanes = self.lanes[a]
            lx0 = self._attr(log_x0, a)[..., lanes]
            post = self._posterior_attr(lx0, self._to_lanes(self._attr(xt, a), a), self.tabs[a], t)
            out[:, a::5, :] = out[:, a::5, :].index_copy(-1, lanes, post)
        return out

    def forward_log_probs(self, x0: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """(B, S, V) log q(x_t | x_0) of clean ids ``x0``; ids an attribute
        does not hold get log 0."""
        out = torch.full(x0.shape + (self.vocab.size,), LOG0, device=x0.device)
        for a in range(5):
            lanes = self.lanes[a]
            lanes_x0 = self._to_lanes(self._attr(x0, a), a)
            onehot = torch.full(lanes_x0.shape + (len(lanes),), LOG0, device=x0.device)
            onehot.scatter_(-1, lanes_x0[..., None], 0.0)
            lp = self._q_pred(onehot, self.tabs[a], t, cum=True)
            out[:, a::5, :] = out[:, a::5, :].index_copy(-1, lanes, lp)
        return out


def predict_start(logits: torch.Tensor) -> torch.Tensor:
    """The denoiser's logits -> log p(x0 | x_t): softmax over every token
    but MASK, MASK at -70, clipped to [-70, 0]."""
    lp = torch.log_softmax(logits[..., :-1].float(), -1)
    return torch.cat([lp, torch.full_like(lp[..., :1], -70.0)], -1).clamp(-70.0, 0.0)


def importance_weights(history: torch.Tensor) -> torch.Tensor:
    """Timestep sampling probabilities from the EMA of squared losses
    (VQ-Diffusion's importance sampling; t = 0 takes t = 1's weight)."""
    w = torch.sqrt(history + 1e-10) + 1e-4
    w = torch.cat([w[1:2], w[1:]])
    return w / w.sum()


def loss(diff: Diffusion, log_x0_recon: torch.Tensor, x0: torch.Tensor, xt: torch.Tensor,
         t: torch.Tensor, pt: torch.Tensor, aux_weight: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """LayoutDM's training loss (VQ-Diffusion's: the KL between the true
    and the predicted posterior, the decoder NLL at t = 0, and the
    auxiliary KL on x0 weighted by 2 - t/T), importance-weighted by
    1 / pt; returns the mean loss and each row's KL term (for the EMA)."""
    V = diff.vocab.size
    lx0 = torch.full(x0.shape + (V,), LOG0, device=x0.device).scatter_(-1, x0[..., None], 0.0)
    model = diff.posterior(log_x0_recon, xt, t)
    true = diff.posterior(lx0, xt, t)
    kl = (true.exp() * (true - model)).sum(-1).mean(-1)
    nll = -(lx0.exp() * model).sum(-1).mean(-1)
    t0 = (t == 0).float()
    kl_loss = t0 * nll + (1 - t0) * kl
    aux = (lx0[..., :-1].exp() * (lx0[..., :-1] - log_x0_recon[..., :-1])).sum(-1).mean(-1)
    aux_loss = t0 * nll + (1 - t0) * aux
    w = 2.0 - t.float() / diff.T
    total = (kl_loss / pt).mean() + (w * aux_weight * aux_loss / pt).mean()
    return total, kl_loss
