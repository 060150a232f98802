"""int8 serving engine for the LayoutDM denoiser (port of
``layoutdm_tpu/models/int8_serving.py``).

Static quantization, as in the JAX package:

  * weights: per-output-channel int8 with float32 scales, computed once
    from the parameters (`quantize_weights`);
  * activations: one float32 scale per GEMM site, calibrated on a batch of
    random ids at a spread of timesteps by recording max|x| at every GEMM
    input (`calibrate_scales`).

`mirror_forward` is a mirror of ``models.nn.CategoricalTransformer``'s
forward that reads the same parameters (the net's ``state_dict``, no new
checkpoint format): embed -> elem/attr positions -> L x (AdaLayerNorm,
whose output replaces the trunk -> qkv -> K1 attention -> out projection +
residual -> LayerNorm -> FFN + residual) -> float32 head.  The qkv, out,
linear1 and linear2 GEMMs run int8 x int8 -> int32 (``torch._int_mm``; the
JAX package runs this product outside any Pallas kernel too) where
weights and scales are given; the attention runs K1
(`ops.attention.fused_attention_qkv`: the CUDA kernel on a CUDA tensor,
its plain version on a CPU tensor), and the vocabulary head stays float32.

Scope (`can_use_int8`, behind ``LAYOUTDM_TPU_INT8=1``): the flagship
family only (elem_attr positions, the embedding-table AdaLayerNorm,
mask-free attention).  The port reaches it through ``profile_chain.py``
and ``chip_smoke.py``; the service does not use it, as the JAX service
does not.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from layoutdm_tpu_torch.configs import BackboneConfig
from layoutdm_tpu_torch.ops.attention import MAX_HEAD_DIM, fused_attention_qkv
from layoutdm_tpu_torch.ops.ffn import ACTIVATIONS

GEMM_SITES = ("qkv", "out", "linear1", "linear2")
LN_EPS = 1e-6  # flax.linen.LayerNorm's default, as the denoiser uses


def _site_param(layer: int, site: str) -> str:
    holder = "attn." if site in ("qkv", "out") else ""
    return f"backbone.layers.{layer}.{holder}{site}"


def _num_layers(params: Mapping[str, torch.Tensor]) -> int:
    return sum(1 for k in params
               if k.startswith("backbone.layers.") and k.endswith(".linear1.weight"))


# -- static quantization helpers -------------------------------------------


@torch.no_grad()
def quantize_weights(params: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-output-channel int8 weights and float32 scales for every GEMM
    site of every backbone layer, keyed ``layer{i}/{site}`` as in the JAX
    package.  A ``nn.Linear`` weight is (out, in), so the scale reduces
    over dim 1 (JAX reduces axis 0 of its (in, out) kernel)."""
    out = {}
    for i in range(_num_layers(params)):
        for site in GEMM_SITES:
            name = _site_param(i, site)
            w = params[f"{name}.weight"].float()
            sw = torch.clamp(w.abs().amax(dim=1), min=1e-8) / 127.0
            out[f"layer{i}/{site}"] = {
                "w_q": torch.round(w / sw[:, None]).to(torch.int8),
                "s_w": sw,
                "b": params[f"{name}.bias"].float(),
            }
    return out


def _int8_dense(x: torch.Tensor, entry: Mapping[str, torch.Tensor],
                s_act: torch.Tensor) -> torch.Tensor:
    """x (.., K) -> int8 GEMM -> float32 (.., N).  The quantize multiplies
    by the reciprocal of the scale, as the JAX package does (a division
    rounds differently at .5 boundaries)."""
    q = torch.clamp(torch.round(x.float() * (1.0 / s_act)), -127, 127).to(torch.int8)
    q2 = q.reshape(-1, q.shape[-1])
    w_q = entry["w_q"]
    if q2.is_cuda and (q2.shape[0] <= 16 or q2.shape[1] % 8 or w_q.shape[0] % 8):
        raise ValueError(
            f"torch._int_mm on CUDA needs more than 16 rows and K, N multiples "
            f"of 8; got ({q2.shape[0]}, {q2.shape[1]}) x ({q2.shape[1]}, {w_q.shape[0]})"
        )
    acc = torch._int_mm(q2, w_q.t()).reshape(*q.shape[:-1], w_q.shape[0])
    return acc.float() * (s_act * entry["s_w"]) + entry["b"]


# -- the mirror forward ----------------------------------------------------


def _normalize(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + LN_EPS)


def _ada_layer_norm(params, prefix: str, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """AdaLayerNorm, embedding-table variant (``norm1.cond.{emb,linear}``)."""
    emb = F.silu(params[f"{prefix}.norm1.cond.emb.weight"][t])  # (B, D)
    emb = F.linear(emb, params[f"{prefix}.norm1.cond.linear.weight"],
                   params[f"{prefix}.norm1.cond.linear.bias"])  # (B, 2D)
    scale, shift = emb[:, None, :].chunk(2, dim=-1)
    return _normalize(x) * (1 + scale) + shift


def _layer_norm(params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return _normalize(x) * params[f"{prefix}.weight"] + params[f"{prefix}.bias"]


def _plain_attention(qkv: torch.Tensor, H: int, dtype) -> torch.Tensor:
    """The JAX mirror's attention where K1's gate fails (`:171-181`)."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    hd = D // H
    q, k, v = (z.reshape(B, S, H, hd) for z in qkv.split(D, dim=-1))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    p = torch.softmax(s.float(), -1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, D)


@torch.no_grad()
def mirror_forward(
    params: Mapping[str, torch.Tensor],
    bb: BackboneConfig,
    num_classes: int,
    seq: torch.Tensor,  # (B, S) int64
    t: torch.Tensor,  # (B,) int64
    wq: Optional[Dict] = None,
    act_scales: Optional[Dict[str, torch.Tensor]] = None,
    observe: bool = False,
    dtype=torch.bfloat16,
):
    """Forward pass reading the denoiser's ``state_dict`` directly.

    * ``wq=None``, ``observe=False``: the plain mirror in ``dtype``;
    * ``observe=True``: returns (logits, {site: max|input|}) for calibration;
    * ``wq`` and ``act_scales`` given: int8 GEMMs at the four sites a layer.
    """
    if bb.timestep_type is None or "adalayernorm" not in bb.timestep_type:
        raise ValueError(f"the int8 mirror needs AdaLayerNorm, got {bb.timestep_type!r}")
    if "pos.elem_emb" not in params or "pos.attr_emb" not in params:
        raise ValueError("the int8 mirror requires elem_attr positional embeddings")
    if "pos.bos_emb" in params:
        raise ValueError("the int8 mirror has no BOS positional slot")
    D, H, L = bb.d_model, bb.nhead, bb.num_layers
    S = seq.shape[1]
    observed: Dict[str, torch.Tensor] = {}

    elem, attr = params["pos.elem_emb"], params["pos.attr_emb"]
    pe = torch.repeat_interleave(elem, attr.shape[0], dim=0) + attr.repeat(elem.shape[0], 1)
    h = (params["cat_emb.weight"][seq] + pe[None, :S]).to(dtype)

    def gemm(key: str, x: torch.Tensor, name: str) -> torch.Tensor:
        if wq is not None:
            return _int8_dense(x, wq[key], act_scales[key])
        if observe:
            observed[key] = x.float().abs().max()
        out = F.linear(x, params[f"{name}.weight"].to(x.dtype))
        return out + params[f"{name}.bias"].float()

    for i in range(L):
        prefix = f"backbone.layers.{i}"
        # norm1 REPLACES the trunk (the reference's quirk, kept by
        # models.nn.Block): the attention residual is based on the normed
        # activations, not the block input
        x = _ada_layer_norm(params, prefix, h, t).to(dtype)
        h = x
        qkv = gemm(f"layer{i}/qkv", x, f"{prefix}.attn.qkv").to(dtype)
        if D // H <= MAX_HEAD_DIM:
            attn = fused_attention_qkv(qkv.contiguous(), H)
        else:
            attn = _plain_attention(qkv, H, dtype)
        attn = gemm(f"layer{i}/out", attn.to(dtype), f"{prefix}.attn.out")
        h = h + attn.to(dtype)

        x = _layer_norm(params, f"{prefix}.norm2", h).to(dtype)
        f = gemm(f"layer{i}/linear1", x, f"{prefix}.linear1")
        f = ACTIVATIONS[bb.activation](f.to(dtype))
        f = gemm(f"layer{i}/linear2", f, f"{prefix}.linear2")
        h = h + f.to(dtype)

    # the vocabulary head in float32, as the denoiser's
    logits = F.linear(_layer_norm(params, "head_norm", h), params["head.weight"].float())
    if observe:
        return logits, observed
    return logits


# -- calibration and the drop-in predict_start -----------------------------


def calibrate_scales(
    params, bb: BackboneConfig, num_classes: int, seq, t, margin: float = 1.0
) -> Dict[str, torch.Tensor]:
    """One bf16 observe pass; per-site max|x| -> scalar scales
    (max / 127, times a safety margin)."""
    _, observed = mirror_forward(params, bb, num_classes, seq, t, observe=True)
    return {k: (torch.clamp(v, min=1e-6) * margin / 127.0).float()
            for k, v in observed.items()}


def can_use_int8(bb: BackboneConfig, pos_emb: str = "elem_attr", lookahead: bool = True) -> bool:
    """``LAYOUTDM_TPU_INT8=1`` and a configuration the mirror computes: a
    mask-free net, the embedding-table AdaLayerNorm, elem_attr positions."""
    if os.environ.get("LAYOUTDM_TPU_INT8") != "1":
        return False
    if not lookahead:
        # the mirror has no attention mask: a causal net would lose it
        return False
    if bb.timestep_type is None or "adalayernorm" not in bb.timestep_type:
        return False
    if "mlp" in bb.timestep_type or "abs" in bb.timestep_type:
        return False
    return pos_emb == "elem_attr"


def make_int8_predict_start(model, calib_batch: int = 64,
                            generator: Optional[torch.Generator] = None):
    """A drop-in for ``model._predict_start`` on int8 GEMMs: quantizes the
    weights once, calibrates the activation scales on one batch of random
    ids and timesteps drawn from ``generator`` (a CPU generator seeded 0 by
    default), and wraps the mirror in the sampler's head contract
    (log-softmax over the V - 1 non-MASK classes, the MASK lane at -70,
    clipped to [-70, 0]).  Its ``logits(ids, t)`` is the int8 mirror alone,
    the denoiser the head wraps."""
    # the guard that matters is here, where the net's real attention mode
    # is in hand: the mirror has no mask, so a causal net must fail loudly
    if not getattr(model.net, "lookahead", True):
        raise ValueError(
            "int8 serving path requires a mask-free (lookahead) transformer; "
            "this model's net is causal"
        )
    bb = model.backbone_cfg
    V, S = model.num_classes, model.seq_len
    dev = model.device
    params = model.net.state_dict()
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    seq = torch.randint(0, V, (calib_batch, S), generator=g, device=g.device).to(dev)
    t = torch.randint(0, model.q.num_timesteps, (calib_batch,), generator=g,
                      device=g.device).to(dev)
    scales = calibrate_scales(params, bb, V, seq, t)
    wq = quantize_weights(params)

    def logits(ids: torch.Tensor, t_b: torch.Tensor) -> torch.Tensor:
        return mirror_forward(params, bb, V, ids, t_b, wq=wq, act_scales=scales)

    def predict_start(ids: torch.Tensor, t_b: torch.Tensor, dropout=None) -> torch.Tensor:
        if dropout is not None:
            raise ValueError("the int8 mirror serves; it has no training mode")
        log_pred = torch.log_softmax(logits(ids, t_b)[..., :-1], dim=-1)
        mask_lane = torch.full_like(log_pred[..., :1], -70.0)
        return torch.clamp(torch.cat([log_pred, mask_lane], dim=-1), -70.0, 0.0)

    predict_start.logits = logits  # the int8 denoiser alone, without the head
    return predict_start
