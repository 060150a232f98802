"""DiffusionLM and BitDiffusion codecs and the family wrapper (port of
``layoutdm_tpu/models/continuous/models.py``).

Parity targets: `continuous_diffusion/diffusion_lm.py:11-75` (a token
embedding and a rounding head initialised to it), `bitdiffusion.py:12-69`
(8-bit analog bits decoded to the nearest legal code), and the
`LayoutContinuousDiffusion` wrapper (`layout_continuous_diffusion.py:22-119`).

DiffusionLM's rounder and token embedding live in its ``net``
(`DiffusionLMNet`) beside the denoiser's modules, under the JAX tree's
names (``rounder``, ``token_emb``): the trainer, the checkpoints and the
CLIs read one module.  The embedding is a parameter when learnable, else a
buffer; either way it is saved with the weights (a reference checkpoint's
own codebook loads into it).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from layoutdm_tpu_torch.configs import BackboneConfig, ModelConfig
from layoutdm_tpu_torch.models.continuous.base import (
    ContinuousDiffusionBase,
    ContinuousTransformer,
    log_snr_to_alpha_sigma,
)
from layoutdm_tpu_torch.models.nn import init_weights
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer


def trunc_normal(rng: np.random.RandomState, shape, std: float = 1.0) -> np.ndarray:
    """Normal draws redrawn until inside [-2 std, 2 std] (`base.py:73-86`
    init), the JAX package's numpy construction."""
    x = rng.randn(*shape) * std
    bad = np.abs(x) > 2 * std
    while bad.any():
        x[bad] = rng.randn(int(bad.sum())) * std
        bad = np.abs(x) > 2 * std
    return x.astype(np.float32)


# the numpy seed of DiffusionLM's codebook, the JAX model's default
CODEBOOK_SEED = 0


def codebook(num_classes: int, num_channel: int) -> np.ndarray:
    """DiffusionLM's token embedding as the JAX model builds it."""
    return trunc_normal(np.random.RandomState(CODEBOOK_SEED), (num_classes, num_channel))


class DiffusionLMNet(ContinuousTransformer):
    """`ContinuousTransformer` with DiffusionLM's ``rounder`` (a Linear
    from the channels to the vocabulary) and ``token_emb`` (V, channels)."""

    def __init__(self, num_classes: int, learnable_token_emb: bool = False, **kw):
        super().__init__(**kw)
        self.rounder = nn.Linear(self.dim_in, num_classes)
        table = torch.empty(num_classes, self.dim_in)
        if learnable_token_emb:
            self.token_emb = nn.Parameter(table)
        else:
            self.register_buffer("token_emb", table)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The denoiser from ``generator``; the codebook from its numpy
        seed, and the rounder initialised to its inverse map
        (`layout_continuous_diffusion.py:59-66`)."""
        init_weights(self, generator)
        V, C = self.token_emb.shape
        self.token_emb.copy_(torch.as_tensor(codebook(V, C)))
        self.rounder.weight.copy_(self.token_emb)
        self.rounder.bias.zero_()


class DiffusionLM(ContinuousDiffusionBase):
    """Diffusion on token embeddings with a rounding head."""

    has_rounder = True
    net_class = DiffusionLMNet

    def __init__(self, *args, learnable_token_emb: bool = False, **kw):
        self.learnable_token_emb = learnable_token_emb
        super().__init__(*args, **kw)

    def _net_kwargs(self) -> Dict:
        return dict(num_classes=self.num_classes, learnable_token_emb=self.learnable_token_emb)

    def dis2con(self, seq, draws=None):
        emb = self.net.token_emb[seq]
        if draws is not None:
            # reparametrise with sigma at t = 0 (`diffusion_lm.py:44-52`)
            _, sigma0 = log_snr_to_alpha_sigma(self.log_snr(torch.tensor(0.0, device=emb.device)))
            return emb + sigma0 * draws.normal("rep", tuple(emb.shape), emb.device), emb
        return emb, emb

    def con2logits(self, arr):
        return F.linear(arr, self.net.rounder.weight, self.net.rounder.bias)

    def con2dis(self, arr):
        return torch.argmax(self.con2logits(arr), dim=-1)


def ids_to_bits(ids: torch.Tensor, num_bits: int) -> torch.Tensor:
    """(B, S) -> (B, S, bits) in {-1, +1}, the most significant bit first
    (`bitdiffusion.py:12-24`)."""
    mask = 2 ** torch.arange(num_bits - 1, -1, -1, device=ids.device)
    return ((ids[..., None] & mask) != 0).to(torch.float32) * 2 - 1.0


class BitDiffusion(ContinuousDiffusionBase):
    """Analog-bits diffusion (`bitdiffusion.py:52-69`)."""

    has_rounder = False

    def __init__(self, *args, num_channel: int = 8, **kw):
        super().__init__(*args, num_channel=num_channel, **kw)
        self.scale = 1.0
        n = 2 ** num_channel
        if self.num_classes > n:
            raise ValueError(f"{self.num_classes} tokens do not fit {num_channel} bits")
        # every code's bits, and which codes each slot may take
        # (`bitdiffusion.py:27-48`)
        self.base_bits = ids_to_bits(torch.arange(n, device=self.device), num_channel)
        tok = self.tokenizer
        legal = np.zeros((tok.max_token_length - (1 if "bos" in tok.special_tokens else 0), n),
                         bool)
        legal[:, : self.num_classes] = tok.token_mask()
        self.legal = torch.as_tensor(legal, device=self.device)  # (S, n)

    def dis2con(self, seq, draws=None):
        x = ids_to_bits(seq, self.num_channel) * self.scale
        return x, x

    def con2dis(self, arr):
        """The nearest legal code in L1 distance (`bitdiffusion.py:36-46`):
        a (B, S, 2**bits, bits) distance tensor, as in the JAX package."""
        dist = (arr[:, :, None, :] - self.base_bits[None, None]).abs().sum(-1)
        dist = torch.where(self.legal[None], dist, torch.inf)
        return torch.argmin(dist, dim=-1)

    def con2logits(self, arr):
        raise NotImplementedError("BitDiffusion has no rounding head")


class LayoutContinuousDiffusion:
    """The family wrapper selecting DiffusionLM or BitDiffusion by config
    (`layout_continuous_diffusion.py:20,41-56`); attributes reach the
    wrapped model."""

    def __init__(
        self,
        backbone: BackboneConfig,
        tokenizer: LayoutSequenceTokenizer,
        model_cfg: Optional[ModelConfig] = None,
        dtype=torch.float32,
        device="cuda",
        generator: Optional[torch.Generator] = None,
        **switches,
    ):
        cfg = model_cfg or ModelConfig()
        self.cfg = cfg
        self.tokenizer = tokenizer
        kw = dict(num_timesteps=cfg.num_timesteps, dtype=dtype, device=device,
                  generator=generator, **switches)
        if cfg.name == "bitdiffusion":
            self.model = BitDiffusion(backbone, tokenizer, use_self_condition=True,
                                      use_clamping_trick=False, **kw)
        else:
            self.model = DiffusionLM(backbone, tokenizer, num_channel=16,
                                     use_self_condition=False, use_clamping_trick=True,
                                     learnable_token_emb=cfg.learnable_token_emb, **kw)

    def __getattr__(self, name):
        model = self.__dict__.get("model")
        if model is None:
            raise AttributeError(name)
        return getattr(model, name)
