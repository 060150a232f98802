"""LayoutDM's denoiser, written out plainly in float32 (reference
implementation; no import of the program).

The flattened transformer of LayoutDM (Inoue et al. 2023, section 4.1;
its code's ``CategoricalTransformer``): token embedding plus factored
element and attribute positions, ``num_layers`` pre-norm blocks whose
first norm is an adaptive LayerNorm on the timestep (``x = adaLN(x, t);
x = x + attn(x); x = x + FFN(LN(x))``, the first norm replacing the
trunk, as the code has it), a final LayerNorm and a bias-free head over
the vocabulary.  LayerNorms use eps 1e-6 and the FFN a ReLU.  Widths are
the configuration's after LayoutDM's own 29/32 shrink.

``param_spec`` names every parameter with the names the program's state
dict uses, so one set of tensors made by the benchmark serves both sides.

``lowp`` computes every product with its operands rounded to a lower
precision (``"fp8"``: float8 e4m3 with a per-tensor scale), the control
that has to fail the comparison.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def widths(cfg: Dict) -> Tuple[int, int, int, int]:
    """(d_model, heads, ffn width, layers) as run."""
    num, den = cfg["width_shrink"]
    return (cfg["d_model"] * num // den, cfg["nhead"], cfg["dim_feedforward"] * num // den,
            cfg["num_layers"])


def param_spec(cfg: Dict, vocab_size: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter; kind says how the benchmark
    draws it (``w``: N(0, 1/fan_in), ``b``: N(0, 0.02^2), ``emb``:
    N(0, 1/d), ``pos``: U[0, 1), ``one``: 1 + N(0, 0.1^2), ``zero``:
    N(0, 0.1^2))."""
    d, _, ff, L = widths(cfg)
    E = cfg["max_elements"]
    spec = [("cat_emb.weight", (vocab_size, d), "emb"),
            ("pos.elem_emb", (E, d), "pos"), ("pos.attr_emb", (5, d), "pos")]
    for i in range(L):
        p = f"backbone.layers.{i}."
        spec += [
            (p + "norm1.cond.emb.weight", (cfg["diffusion_step"], d), "emb"),
            (p + "norm1.cond.linear.weight", (2 * d, d), "w"),
            (p + "norm1.cond.linear.bias", (2 * d,), "b"),
            (p + "attn.qkv.weight", (3 * d, d), "w"), (p + "attn.qkv.bias", (3 * d,), "b"),
            (p + "attn.out.weight", (d, d), "w"), (p + "attn.out.bias", (d,), "b"),
            (p + "linear1.weight", (ff, d), "w"), (p + "linear1.bias", (ff,), "b"),
            (p + "linear2.weight", (d, ff), "w"), (p + "linear2.bias", (d,), "b"),
            (p + "norm2.weight", (d,), "one"), (p + "norm2.bias", (d,), "zero"),
        ]
    spec += [("head_norm.weight", (d,), "one"), ("head_norm.bias", (d,), "zero"),
             ("head.weight", (vocab_size, d), "w")]
    return spec


def make_params(cfg: Dict, vocab_size: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter in float32 on ``device``, from ``seed``: one normal
    and one uniform draw on a generator there, cut into the leaves."""
    spec = param_spec(cfg, vocab_size)
    n = sum(math.prod(s) for _, s, _ in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n, generator=g, device=device)
    uniform = torch.rand(n, generator=g, device=device)
    out, off = {}, 0
    for name, shape, kind in spec:
        k = math.prod(shape)
        z, u = normal[off:off + k].view(shape), uniform[off:off + k].view(shape)
        off += k
        if kind in ("w", "emb"):  # fan-in of a kernel, width of an embedding
            v = z / math.sqrt(shape[1])
        elif kind == "pos":
            v = u.clone()
        elif kind == "b":
            v = 0.02 * z
        elif kind == "one":
            v = 1.0 + 0.1 * z
        else:
            v = 0.1 * z
        out[name] = v.contiguous()
    return out


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude mapped to 448), back in float32; the gradient passes the
    rounding unchanged (the product's backward reads the rounded operands)."""
    s = x.detach().abs().amax().clamp(min=1e-12) / 448.0
    r = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (r - x.detach())


def _lin(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], lowp: Optional[str]):
    if lowp == "fp8":
        x, w = _round_fp8(x), _round_fp8(w)
    elif lowp is not None:
        raise ValueError(f"unknown precision {lowp!r}")
    return F.linear(x, w, b)


def _ln(x: torch.Tensor, w=None, b=None) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w, b, LN_EPS)


def forward(p: Dict[str, torch.Tensor], cfg: Dict, ids: torch.Tensor, t: torch.Tensor,
            emb_keep: Optional[torch.Tensor] = None, lowp: Optional[str] = None) -> torch.Tensor:
    """(B, S) ids at timesteps (B,) -> (B, S, V) float32 logits.
    ``emb_keep``: the training-mode dropout of the embeddings, as a keep
    mask (kept values scaled by 1 / 0.9)."""
    d, H, _, L = widths(cfg)
    hd = d // H
    B, S = ids.shape
    E = S // 5
    pos = p["pos.elem_emb"][:E].repeat_interleave(5, 0) + p["pos.attr_emb"].repeat(E, 1)
    x = p["cat_emb.weight"][ids] + pos[None]
    if emb_keep is not None:
        x = torch.where(emb_keep, x / 0.9, torch.zeros((), device=x.device))
    for i in range(L):
        q = f"backbone.layers.{i}."
        e = p[q + "norm1.cond.emb.weight"][t]
        scale, shift = _lin(F.silu(e), p[q + "norm1.cond.linear.weight"],
                            p[q + "norm1.cond.linear.bias"], lowp)[:, None].chunk(2, -1)
        x = _ln(x) * (1 + scale) + shift
        qkv = _lin(x, p[q + "attn.qkv.weight"], p[q + "attn.qkv.bias"], lowp)
        qh, kh, vh = qkv.view(B, S, 3, H, hd).permute(2, 0, 3, 1, 4)
        if lowp == "fp8":
            qh, kh, vh = _round_fp8(qh), _round_fp8(kh), _round_fp8(vh)
        a = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(hd), -1)
        o = (a @ vh).transpose(1, 2).reshape(B, S, d)
        x = x + _lin(o, p[q + "attn.out.weight"], p[q + "attn.out.bias"], lowp)
        h = _ln(x, p[q + "norm2.weight"], p[q + "norm2.bias"])
        h = F.relu(_lin(h, p[q + "linear1.weight"], p[q + "linear1.bias"], lowp))
        x = x + _lin(h, p[q + "linear2.weight"], p[q + "linear2.bias"], lowp)
    return _lin(_ln(x, p["head_norm.weight"], p["head_norm.bias"]), p["head.weight"], None, lowp)
