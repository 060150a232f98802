"""Analytic FLOPs of LayoutDM from its configuration (frozen from the
port's ``bench/flops.py``: ``flops_per_layout``, ``train_flops_per_sample``).
A multiply-add counts 2.  Elementwise log-space work is left out."""

from __future__ import annotations

from typing import Dict


def _sizes(cfg: Dict):
    num, den = cfg["width_shrink"]
    d, ff = cfg["d_model"] * num // den, cfg["dim_feedforward"] * num // den
    S = 5 * cfg["max_elements"]
    V = cfg["num_categories"] + 4 * cfg["num_bins"] + 2
    # the posterior's two routes between the full vocabulary and one
    # attribute's padded lanes (max(categories, bins) + 2 wide)
    Vp = max(cfg["num_categories"], cfg["num_bins"]) + 2
    return d, ff, cfg["num_layers"], S, V, Vp


def flops_per_layout(cfg: Dict, num_timesteps: int = None) -> int:
    """One sampled layout: per step the denoiser's GEMMs (qkv, out, the
    two FFN products), its attention scores and weighted sum, the head,
    and the posterior's two routes over the (V, Vp) tables."""
    d, ff, L, S, V, Vp = _sizes(cfg)
    T = cfg["num_timesteps"] if num_timesteps is None else num_timesteps
    per_token_layer = 2 * d * d * 4 + 2 * d * ff * 2
    attn = 2 * 2 * S * d
    head = 2 * d * V
    denoiser = S * (L * (per_token_layer + attn) + head)
    routes = 2 * (S * 2 * V * Vp)
    return T * (denoiser + routes)


def train_flops_per_sample(cfg: Dict) -> int:
    """One training sample: a denoiser forward and its backward (2x)."""
    return 3 * flops_per_layout(cfg, num_timesteps=1)
