"""LayoutDM's training step, written out plainly in float32 (reference
implementation; no import of the program): the loss of
`diffusion.loss` on the denoiser of `denoiser.forward`, its gradient
clipped to a global norm of 1 (scaled by ``clip / norm`` only where the
norm is larger, as optax does), and one AdamW update (decoupled weight
decay ``lr * wd`` on the Linear kernels outside the norms, bias-corrected
moments, eps 1e-8 outside the square root).

The timestep of each row is drawn uniformly until every timestep has been
visited more than 10 times, then by importance (`diffusion.importance_weights`
over an EMA, 0.9 / 0.1, of each timestep's mean squared KL term); ``pt``
is the row's sampling probability and weights its loss by ``1 / pt``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.reference import denoiser, diffusion

# Linear kernels AdamW decays: every Dense kernel outside a norm module
DECAYED = ("attn.qkv.weight", "attn.out.weight", "linear1.weight", "linear2.weight",
           "head.weight")


def decayed(name: str) -> bool:
    return name.endswith(DECAYED) and "norm" not in name


class Trainer:
    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor], device,
                 lowp: Optional[str] = None):
        self.cfg, self.lowp = cfg, lowp
        self.diff = diffusion.Diffusion(cfg, device)
        self.p = {k: v.detach().clone().float().requires_grad_(True) for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        T = cfg["num_timesteps"]
        self.history = torch.zeros(T, device=device)
        self.count = torch.zeros(T, device=device)
        self.k = 0
        self.grads: List[Dict[str, torch.Tensor]] = []

    def pt(self, t: torch.Tensor) -> torch.Tensor:
        T = self.cfg["num_timesteps"]
        if bool((self.count > 10).all()):
            return diffusion.importance_weights(self.history)[t]
        return torch.full(t.shape, 1.0 / T, device=t.device)

    def step(self, x0: torch.Tensor, xt: torch.Tensor, t: torch.Tensor,
             emb_keep: Optional[torch.Tensor]) -> float:
        """One step on clean ids ``x0`` with the corruption ``xt`` at ``t``
        and the embedding dropout ``emb_keep``; returns the loss."""
        cfg = self.cfg
        logits = denoiser.forward(self.p, cfg, xt, t, emb_keep=emb_keep, lowp=self.lowp)
        lx0 = diffusion.predict_start(logits)
        loss, kl = diffusion.loss(self.diff, lx0, x0, xt, t, self.pt(t),
                                  cfg["auxiliary_loss_weight"])
        names = list(self.p)
        grads = dict(zip(names, torch.autograd.grad(loss, [self.p[n] for n in names])))
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
            if norm > cfg["grad_norm_clip"]:
                grads = {k: g * (cfg["grad_norm_clip"] / norm) for k, g in grads.items()}
            self.grads.append(grads)
            T = cfg["num_timesteps"]
            onehot = torch.nn.functional.one_hot(t, T).float()
            cnt = onehot.sum(0)
            mean = (kl.detach() ** 2) @ onehot / cnt.clamp(min=1)
            self.history = torch.where(cnt > 0, 0.1 * mean + 0.9 * self.history, self.history)
            self.count = self.count + cnt
            self.k += 1
            b1, b2 = cfg["betas"]
            lr, eps = cfg["lr"], cfg["adam_eps"]
            for n, p in self.p.items():
                g = grads[n]
                if decayed(n):
                    p.mul_(1 - lr * cfg["weight_decay"])
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = self.m[n] / (1 - b1 ** self.k)
                vh = self.v[n] / (1 - b2 ** self.k)
                p.sub_(lr * mh / (vh.sqrt() + eps))
        return float(loss.detach())
