"""Continuous (Gaussian) diffusion over per-token vectors (port of
``layoutdm_tpu/models/continuous/base.py``; reference
`models/continuous_diffusion/base.py:42-413`).

Log-SNR noise schedules (linear, cosine), the loss with optional
self-conditioning, and the DDPM and DDIM reverse loops over host-made
(t, t_next) pairs, a condition held by ``where(mask, cond, x)`` after each
step.  Subclasses (`models.continuous.models`) define the codec between
tokens and vectors.  The denoiser, `ContinuousTransformer`, is the shared
timestep-conditioned encoder: its mask-free inference reaches the kernels
(K1, or K4/K3, K5, K6 under the path switches) and its training runs K1
forward and K2 backward.

Random draws go through `models.base.Draws`: the loss's ``times``,
``noise``, ``rep`` (DiffusionLM's reparametrisation), ``self_cond`` (the
coin) and the dropout's generator; the reverse loop's ``x_T`` and one
``noise`` a DDPM step.  Numerics are float32 around the denoiser, as in
the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from layoutdm_tpu_torch.configs import BackboneConfig, SamplingConfig
from layoutdm_tpu_torch.models.base import as_draws
from layoutdm_tpu_torch.models.nn import (
    EMB_DROPOUT,
    LN_EPS,
    Dropout,
    TransformerEncoder,
    denoiser_path,
    make_module,
    positional_embedding,
)
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer
from layoutdm_tpu_torch.utils.device import require_device


def beta_linear_log_snr(t: torch.Tensor) -> torch.Tensor:
    return -torch.log(torch.expm1(1e-4 + 10 * (t * t)))


def alpha_cosine_log_snr(t: torch.Tensor, s: float = 0.008) -> torch.Tensor:
    c = torch.cos((t + s) / (1 + s) * math.pi * 0.5)
    return -torch.log(torch.clamp(1.0 / (c * c) - 1, min=1e-5))


def log_snr_to_alpha_sigma(log_snr: torch.Tensor):
    return torch.sqrt(torch.sigmoid(log_snr)), torch.sqrt(torch.sigmoid(-log_snr))


LOG_SNR = {"linear": beta_linear_log_snr, "cosine": alpha_cosine_log_snr}


class ContinuousTransformer(nn.Module):
    """Float-sequence denoiser (`nn_lib.py:240-313`): concat(self_cond, x)
    -> float32 Dense -> positions -> the timestep-conditioned encoder (the
    timestep is the float log-SNR) -> float32 LayerNorm -> head."""

    def __init__(self, backbone: BackboneConfig, max_token_length: int, dim_in: int,
                 pos_emb: str = "elem_attr", n_attr_per_elem: int = 5,
                 dtype=torch.float32, **switches):
        super().__init__()
        d = backbone.d_model
        self.dtype, self.dim_in = dtype, dim_in
        self.emb = nn.Linear(2 * dim_in, d)
        self.pos = positional_embedding(pos_emb, d, max_token_length, n_attr_per_elem)
        self.backbone = TransformerEncoder(backbone, dtype, **switches)
        self.head_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, dim_in, bias=False)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                x_self_cond: Optional[torch.Tensor] = None,
                dropout: Optional[Dropout] = None) -> torch.Tensor:
        if x_self_cond is None:
            x_self_cond = torch.zeros_like(x)
        h = self.emb(torch.cat([x_self_cond, x], dim=-1).float())
        h = h + self.pos(h.shape[1])
        if dropout is not None:
            h = dropout(h, EMB_DROPOUT)
        h = self.backbone(h.to(self.dtype), timestep, dropout)
        return self.head(self.head_norm(h.float()))


class ContinuousDiffusionBase:
    """What DiffusionLM and BitDiffusion share; subclasses define
    ``dis2con`` / ``con2dis`` / ``con2logits``.  ``net`` is the one module
    the trainer, checkpoints and CLIs read."""

    has_rounder = False
    # the reverse loop draws one stream for the whole batch, and takes no
    # guidance (`serve_cli`)
    supports_per_row_keys = False
    supports_guidance = False
    net_class = ContinuousTransformer

    def __init__(
        self,
        backbone: BackboneConfig,
        tokenizer: LayoutSequenceTokenizer,
        num_timesteps: int = 100,
        noise_schedule: str = "cosine",
        num_channel: int = 16,
        use_self_condition: bool = False,
        use_clamping_trick: bool = False,
        time_difference: float = 0.0,
        pos_emb: str = "elem_attr",
        dtype=torch.float32,
        device="cuda",
        generator: Optional[torch.Generator] = None,
        **switches,
    ):
        if tokenizer.id_to_name(tokenizer.N_total - 1) != "mask":
            raise ValueError("MASK must be the last vocabulary id")
        self.tokenizer = tokenizer
        self.device = require_device(device)
        self.num_timesteps = num_timesteps
        self.log_snr = LOG_SNR[noise_schedule]
        self.num_channel = num_channel
        self.use_self_condition = use_self_condition
        self.use_clamping_trick = use_clamping_trick
        self.time_difference = time_difference
        self.scale: Optional[float] = None
        self.seq_len = tokenizer.max_token_length
        self.num_classes = tokenizer.N_total
        # 29/32 shrink for parameter parity (`layout_continuous_diffusion.py:44-46`)
        self.backbone_cfg = backbone.shrunk(29 / 32)
        self.net = make_module(
            self.net_class, self.device, generator,
            backbone=self.backbone_cfg,
            max_token_length=self.seq_len,
            dim_in=num_channel,
            pos_emb=pos_emb,
            n_attr_per_elem=tokenizer.N_var_per_element,
            dtype=dtype,
            **self._net_kwargs(),
            **switches,
        )

    def _net_kwargs(self) -> Dict:
        return {}

    @property
    def denoiser_path(self) -> str:
        return denoiser_path(self.net)

    # -- codec hooks --------------------------------------------------------
    def dis2con(self, seq: torch.Tensor, draws=None):
        """ids -> (x, x_mean); ``draws`` (training) may add noise."""
        raise NotImplementedError

    def con2dis(self, arr: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def con2logits(self, arr: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def init_state(self):
        return None

    def _apply(self, x, t, self_cond=None, dropout=None) -> torch.Tensor:
        return self.net(x, t, self_cond, dropout)

    def preprocess(self, batch: Dict, generator=None) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device) for k, v in self.tokenizer.encode(batch).items()}

    # -- training (`continuous_diffusion/base.py:154-208`) ------------------
    def loss(self, tokens, state, generator, is_train: bool = True,
             dropout: Optional[Dropout] = None):
        """(losses, state): the denoiser's MSE to x0 (to its mean at t <
        1/T), the prior term and, with a rounder, the rounding CE.
        ``generator``: a torch.Generator or a `Draws`."""
        draws = as_draws(generator)
        seq = (tokens["seq"] if isinstance(tokens, dict) else tokens).to(self.device)
        B, dev = seq.shape[0], self.device
        x, x_mean = self.dis2con(seq, draws)
        times = draws.uniform("times", (B,), dev, high=0.999)
        noise = draws.normal("noise", tuple(x.shape), dev)
        noise_level = self.log_snr(times)
        alpha, sigma = log_snr_to_alpha_sigma(noise_level[:, None, None])
        noised = alpha * x + sigma * noise

        self_cond = None
        if self.use_self_condition:
            with torch.no_grad():
                sc = self._apply(noised, noise_level)
            use_sc = draws.bernoulli("self_cond", 0.5, (), dev)
            self_cond = torch.where(use_sc, sc, 0.0)

        if is_train and dropout is None:
            dropout = draws.dropout()
        out = self._apply(noised, noise_level, self_cond, dropout if is_train else None)

        mse = (out - x) ** 2
        t0 = (out - x_mean) ** 2
        mse = torch.where((times < 1 / self.num_timesteps)[:, None, None], t0, mse)
        final_alpha, _ = log_snr_to_alpha_sigma(
            self.log_snr(torch.tensor(0.999, device=dev)))
        losses = {"mse_loss": mse.mean(), "tT_loss": ((final_alpha * x) ** 2).mean()}
        if self.has_rounder:
            logp = torch.log_softmax(self.con2logits(out), dim=-1)
            losses["rounding_loss"] = -torch.gather(logp, -1, seq[..., None]).mean()
        return losses, state

    # -- sampling -----------------------------------------------------------
    @staticmethod
    def _time_pairs(T: int, td: float) -> Tuple[np.ndarray, np.ndarray]:
        times = np.linspace(1.0, 0.0, T + 1, dtype=np.float32)
        return times[:-1], np.clip(times[1:] - td, 0.0, None)

    def _predict_x0(self, x, log_snr, x_start_prev):
        sc = x_start_prev if self.use_self_condition else None
        x_start = self._apply(x, log_snr, sc)
        if self.use_clamping_trick:
            x_start, _ = self.dis2con(self.con2dis(x_start))
            if self.scale:
                x_start = torch.clamp(x_start, -self.scale, self.scale)
        return x_start

    @torch.inference_mode()
    def sample_ids(
        self,
        rng,
        batch_size: int,
        cond=None,
        sampling: Optional[SamplingConfig] = None,
        use_ddim: bool = False,
        get_intermediates: bool = False,
        **_unused,
    ):
        """The reverse process -> token ids (B, S).  ``cond`` (a
        `SamplerCond`): its strong tokens are held by replacement after
        every step (`continuous_diffusion/base.py:218-225,273-274`).
        ``rng``: a torch.Generator or a `Draws` (``"x_T"``, then one
        ``"noise"`` a DDPM step).  With ``get_intermediates``, also x after
        each step."""
        sampling = sampling or SamplingConfig()
        T = sampling.num_timesteps or self.num_timesteps
        td = sampling.time_difference or self.time_difference
        draws = as_draws(rng)
        B, dev = batch_size, self.device

        cond_arr = cond_mask = None
        if cond is not None:
            cond = cond.to(dev)
            cond_arr, _ = self.dis2con(cond.seq.long())
            cond_mask = cond.strong_mask[..., None]
        x = draws.normal("x_T", (B, self.seq_len, self.num_channel), dev)
        if cond is not None:
            x = torch.where(cond_mask, cond_arr, x)

        x_start = torch.zeros_like(x)
        steps = []
        for t, tn in zip(*self._time_pairs(T, td)):
            log_snr = self.log_snr(torch.full((B,), float(t), device=dev))
            log_snr_next = self.log_snr(torch.full((B,), float(tn), device=dev))
            alpha, sigma = log_snr_to_alpha_sigma(log_snr[:, None, None])
            alpha_n, sigma_n = log_snr_to_alpha_sigma(log_snr_next[:, None, None])
            x_start = self._predict_x0(x, log_snr, x_start)
            if use_ddim:
                pred_noise = (x - alpha * x_start) / torch.clamp(sigma, min=1e-8)
                x = x_start * alpha_n + pred_noise * sigma_n
            else:
                c = -torch.expm1(log_snr[:, None, None] - log_snr_next[:, None, None])
                mean = alpha_n * (x * (1 - c) / alpha + c * x_start)
                var = (sigma_n * sigma_n) * c
                noise = draws.normal("noise", tuple(x.shape), dev)
                if not tn > 0:
                    noise = torch.zeros_like(noise)
                x = mean + torch.sqrt(torch.clamp(var, min=1e-20)) * noise
            if cond is not None:
                x = torch.where(cond_mask, cond_arr, x)
            if get_intermediates:
                steps.append(x.clone())
        ids = self.con2dis(x)
        return (ids, steps) if get_intermediates else ids

    def sample(self, rng, batch_size, cond=None, sampling=None, **kw):
        """Sample and decode to {bbox, label, mask}."""
        ids = self.sample_ids(rng, batch_size, cond, sampling, **kw)
        return self.tokenizer.decode(ids)
