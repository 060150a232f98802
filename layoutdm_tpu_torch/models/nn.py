"""Timestep-conditioned transformer denoiser (port of the flattened
denoiser of ``layoutdm_tpu/models/nn.py``; reference
`transformer_utils.py:34-246`, `nn_lib.py:73-237`).

Numerics follow the flax modules: parameters are float32; activations run
in the model's compute ``dtype``; norm statistics are float32 and the vocab
head runs in float32.  On a CUDA tensor without autograd every LayerNorm
of the denoisers runs one pass of a CUDA kernel (`ops.adaln`), at the same
rounding points as the plain path: ``AdaLayerNorm`` (the norm, its
modulation and the cast), and through `affine_norm` each affine
LayerNorm (each Block's ``norm2``, the plain ``norm1`` of a Block without
timestep, `DecoderBlock`'s three, the heads' norms: float32 statistics
and affine, the output in the compute dtype, or float32 before a float32
head).  There, in bfloat16, a Block's ReLU and its residual adds run in the
epilogues of the GEMMs before them (`takes_gemm_epilogue`,
`ops.gemm_epilogue`): linear1 with bias and ReLU, linear2 and the K1
path's out projection with bias and the residual, each sum rounded once
(the eager add rounds the product first).  Training keeps the plain path
and its numerics.  ``Block``
keeps the reference's trunk-replacing norm1 quirk: x = norm1(x), then
x + attn(x).  Attention runs at the native head width (58 at the
flagship): the TPU package's head-padding to 64 lanes and lane-padded
vocab head are TPU layout tricks with no counterpart here.

Modules are built on the meta device and materialised by `make_module`
(``to_empty`` + `init_weights`), so construction never draws from the
global RNG; `init_weights` draws from an explicit ``torch.Generator``.

Training mode is a ``Dropout`` passed to ``forward``: it applies the fixed
0.1 embedding dropout and the Block's residual and FFN dropouts at
``cfg.dropout``, drawing keep-masks from its generator (or taking injected
ones).  Under autograd the attention runs through
``fused_attention_qkv_diff`` (K1 forward, K2 backward).  Dropout on the
attention probabilities (``cfg.dropout > 0`` in training) needs the
probability tensor, which the kernels never form: those calls take the
plain path of the JAX ``SelfAttention`` (scores, float32 softmax, dropout,
product), as do calls with an additive (S, S) mask (``lookahead=False``:
the causal mask of the autoregressive models) or a (B, S) key-padding
mask; the JAX gates decline masks for every kernel, and so do these.
Without a mask no mask tensor is built and the kernels are routed as
before.  ``CategoricalTransformer.decode_step`` feeds one token through
the stack against per-layer key/value caches (`KVCache`), the JAX
``decode=True`` mode.  The cached decode's attention (self-attention with
its cache write, and an encoder-decoder's cross-attention over the keys
and values projected once) runs one kernel a call on a CUDA tensor without
autograd, at the shapes it takes (`ops.decode_attention`), at the eager
arithmetic's rounding points; elsewhere that arithmetic itself.

The other denoisers of the JAX package are here too, on the same blocks:
`CategoricalAggregatedTransformer` (attention over elements),
`CategoricalEncDecTransformer` (BART: the encoder, and `DecoderBlock`s with
causal self-attention and `CrossAttention`, whose cached decode projects
the memory's keys and values once), `ElementTransformer` with its layout
codec; `AdaInsNorm` is the ``adainnorm`` timestep norm.

The fused denoiser path (``fused_block`` / ``fused_ffn``, the JAX
package's ``LAYOUTDM_TPU_FUSED_BLOCK`` / ``LAYOUTDM_TPU_FUSED_FFN``) has the
JAX ``Block``'s structure: norm1, then K4 (qkv projection, attention, out
projection and the residual in one kernel), then K3 (norm2, linear1,
activation, linear2 and the residual).  It runs only where the JAX gates
admit it: no dropout, no autograd, and shapes the kernels take; training
keeps K1/K2 and the unfused FFN.  Two more inference paths swap the
attention kernel alone: ``attn_v2`` (K5, the one path with heads padded to
64 lanes, as its kernel's function is defined on them) and ``smajor`` (K6);
the order is K4, K5, K6, K1, as in the JAX ``SelfAttention``.  A masked
call never takes K4, K5, K6 or K1; K3 does not see the mask and keeps the
FFN of a masked inference call, as in the JAX ``Block``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from layoutdm_tpu_torch.configs import BackboneConfig
from layoutdm_tpu_torch.ops.adaln import (
    ada_layer_norm,
    ada_layer_norm_reference,
    can_use_fused_adaln,
    can_use_fused_ln,
    layer_norm,
)
from layoutdm_tpu_torch.ops.attention import (
    can_use_fused_block,
    can_use_smajor,
    fused_attention_block,
    fused_attention_qkv,
    fused_attention_qkv_diff,
    fused_attention_qkv_smajor,
)
from layoutdm_tpu_torch.ops.attention_blockdiag import (
    blockdiag_attention,
    can_use_blockdiag,
    padded_head_dim,
    scatter_out_weights,
    scatter_qkv_weights,
)
from layoutdm_tpu_torch.ops.decode_attention import (
    can_use_decode_attention,
    check_decode_operands,
    decode_attention_reference,
    launch_decode_attention,
)
from layoutdm_tpu_torch.ops.ffn import (
    ACTIVATIONS,
    can_use_fused_ffn,
    fused_ln_ffn_residual,
)
from layoutdm_tpu_torch.ops.gemm_epilogue import (
    can_use_gemm_epilogue,
    linear_relu,
    linear_residual,
)
from layoutdm_tpu_torch.ops.samplers import RowShard, draw_rows
from layoutdm_tpu_torch.utils.profiling import span

LN_EPS = 1e-6  # flax.linen.LayerNorm's default
EMB_DROPOUT = 0.1  # fixed embedding dropout (JAX `models/nn.py`, `nn.Dropout(0.1)`)


class Dropout:
    """Keep-masks for the denoiser's dropout sites in training mode.

    Drawn from ``generator`` as flax draws them (keep where a uniform draw
    is below 1 - rate; kept values scaled by 1 / (1 - rate)), on the
    generator's device and moved to the activation's; or, for tests, taken
    in call order from ``masks`` (boolean keep-masks).  A site at rate 0
    draws nothing."""

    def __init__(self, generator: Optional[torch.Generator] = None, masks=None,
                 rows: Optional[RowShard] = None):
        """``rows``: the data-parallel rank's rows of the batch; its masks
        are the whole batch's, sliced (`ops.samplers.RowShard`)."""
        if (generator is None) == (masks is None):
            raise ValueError("Dropout takes a generator or masks")
        self.generator = generator
        self.masks = None if masks is None else list(masks)
        self.rows = rows

    def __call__(self, x: torch.Tensor, rate: float, cols=None) -> torch.Tensor:
        """``cols``: the FFN hidden's shard under tensor parallelism (its
        ``lo``, ``hi`` and ``total`` columns); the mask is the whole
        hidden's, sliced."""
        if rate == 0.0:
            return x
        if self.masks is not None:
            keep = torch.as_tensor(self.masks.pop(0), device=x.device)
        else:
            g = self.generator

            def draw(shape):
                if cols is not None:
                    u = torch.rand(shape[:-1] + (cols.total,), generator=g, device=g.device)
                    return u[..., cols.lo:cols.hi]
                return torch.rand(shape, generator=g, device=g.device)

            keep = draw_rows(self.rows, draw, x.shape) < 1.0 - rate
            keep = keep.to(x.device)
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """A Dense in the compute dtype over float32 parameters (flax's
    ``nn.Dense(dtype=...)``); a layer split by `parallel.tp` runs its
    column- or row-parallel product (``tensor_parallel``)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    split = getattr(layer, "tensor_parallel", None)
    if split is not None:
        return split(x.to(dtype), layer.weight.to(dtype), bias)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def takes_gemm_epilogue(device: torch.device, dtype, dropout: Optional[Dropout],
                        *layers: nn.Linear, activation: Optional[str] = None) -> bool:
    """Whether products through ``layers`` run their tail (the bias, the
    ``activation`` if any, a residual add) in the GEMM's cuBLASLt epilogue
    (`ops.gemm_epilogue`): on a CUDA device, without autograd or dropout, in
    bfloat16, with ReLU for an activation, through layers with a bias and no
    tensor-parallel split at widths the shim takes.  Anything else keeps the
    eager calls."""
    return (device.type == "cuda" and dropout is None and not torch.is_grad_enabled()
            and activation in (None, "relu")
            and all(layer.bias is not None and getattr(layer, "tensor_parallel", None) is None
                    and can_use_gemm_epilogue(layer.weight.shape[1], layer.weight.shape[0], dtype)
                    for layer in layers))


def _linear_epilogue(x: torch.Tensor, layer: nn.Linear, dtype,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`_linear` with its tail in the GEMM's epilogue (`takes_gemm_epilogue`
    admits it): relu(x Wᵀ + b), or with ``residual`` residual + x Wᵀ + b,
    the sum rounded once."""
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    if residual is None:
        return linear_relu(x, w, b)
    return linear_residual(x, w, b, residual)


def affine_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """An affine LayerNorm of ``x`` (flax's: float32 statistics and affine)
    rounded to ``dtype``: the kernel (`ops.adaln.layer_norm`) on a CUDA
    tensor without autograd (it has no backward) at the widths and dtypes
    it takes, the module's float32 call otherwise."""
    if (x.is_cuda and not torch.is_grad_enabled()
            and can_use_fused_ln(x.shape[-1], x.dtype, dtype)):
        return layer_norm(x, norm.weight, norm.bias, dtype, norm.eps)
    return norm(x.float()).to(dtype)


def embed_tokens(table: torch.Tensor, seq: torch.Tensor, dtype) -> torch.Tensor:
    """Token embedding.  The JAX package's one-hot matmul is a TPU choice;
    its result equals a gather of the table cast to the compute dtype."""
    return F.embedding(seq, table.to(dtype))


class SinusoidalTimestepEmb(nn.Module):
    """`transformer_utils.py:34-49`: sinusoidal timestep embedding,
    rescaled to 4000 steps."""

    def __init__(self, num_steps: int, dim: int, rescale_steps: int = 4000):
        super().__init__()
        self.num_steps, self.dim, self.rescale_steps = num_steps, dim, rescale_steps

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = t.float() / self.num_steps * self.rescale_steps
        half = self.dim // 2
        freq = torch.exp(
            torch.arange(half, device=t.device) * -(math.log(10000) / (half - 1))
        )
        ang = x[:, None] * freq[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class AdaNormCond(nn.Module):
    """Timestep -> (B, 2D) scale/shift modulation
    (`transformer_utils.py:52-69`)."""

    def __init__(self, d_model: int, max_timestep: int, emb_type: str):
        super().__init__()
        self.emb_type = emb_type
        if "abs" in emb_type:
            self.emb = SinusoidalTimestepEmb(max_timestep, d_model)
        elif "mlp" in emb_type:
            self.mlp1 = nn.Linear(1, d_model // 2)
            self.mlp2 = nn.Linear(d_model // 2, d_model)
        else:
            self.emb = nn.Embedding(max_timestep, d_model)
        self.linear = nn.Linear(d_model, 2 * d_model)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        if "mlp" in self.emb_type:
            emb = self.mlp2(F.relu(self.mlp1(t.float()[:, None])))
        else:
            emb = self.emb(t)
        return self.linear(F.silu(emb))


class AdaLayerNorm(nn.Module):
    """LayerNorm modulated by the timestep's scale and shift, in x's dtype
    (`ops.adaln`): the kernel on a CUDA tensor without autograd (it has no
    backward) at the widths it takes, the plain version otherwise."""

    def __init__(self, d_model: int, max_timestep: int, emb_type: str):
        super().__init__()
        self.cond = AdaNormCond(d_model, max_timestep, emb_type)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        cond = self.cond(t)
        if (x.is_cuda and not torch.is_grad_enabled()
                and can_use_fused_adaln(x.shape[-1], x.dtype)):
            return ada_layer_norm(x, cond, LN_EPS)
        return ada_layer_norm_reference(x, cond, LN_EPS)


class AdaInsNorm(nn.Module):
    """Instance norm over the sequence axis with the timestep's scale and
    shift (`transformer_utils.py:86-100`, JAX `AdaInsNorm`): population
    variance and eps 1e-5, not the LayerNorms' 1e-6.  Statistics and the
    output are float32."""

    EPS = 1e-5

    def __init__(self, d_model: int, max_timestep: int, emb_type: str):
        super().__init__()
        self.cond = AdaNormCond(d_model, max_timestep, emb_type)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        scale, shift = self.cond(t)[:, None].chunk(2, dim=-1)
        x = x.float()
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + self.EPS) * (1 + scale) + shift


class KVCache:
    """Per-layer key/value caches of single-token decoding (the JAX
    ``decode=True`` mode's "cache" collection): (B, L, H, hd) keys and
    values in the compute dtype, and the position the next token takes.
    An encoder-decoder also holds each decoder layer's cross-attention
    keys and values, projected once from the encoder memory
    (`CategoricalEncDecTransformer.new_cache`).  The decode attention
    kernel's operands are checked at the cache's first kernel call
    (`attend`): its lists' tensors are replaced, if at all, before it."""

    def __init__(self, num_layers: int, batch: int, length: int, nhead: int,
                 head_dim: int, dtype, device):
        shape = (batch, length, nhead, head_dim)
        self.keys = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)]
        self.values = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)]
        self.cross_keys: list = []
        self.cross_values: list = []
        self.index = 0
        self.checked = False

    def attend(self, q: torch.Tensor, layer: int,
               new: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """A cached decode's attention (`ops.decode_attention`): one query a
        row, q (B, 1, H, hd), against ``layer``'s self-attention caches,
        ``new`` (this step's k and v) written at ``index`` first, or
        without ``new`` against its cross keys and values.  The kernel on a
        CUDA tensor without autograd at the shapes it takes, every operand
        of every layer checked at the first such call; its plain version
        otherwise."""
        if new is None:
            keys, values = self.cross_keys[layer], self.cross_values[layer]
            n = keys.shape[1]
        else:
            keys, values, n = self.keys[layer], self.values[layer], self.index + 1
        _, _, H, hd = q.shape
        if (not q.is_cuda or torch.is_grad_enabled()
                or not can_use_decode_attention(H, hd, keys.shape[1], q.dtype)):
            return decode_attention_reference(q, keys, values, n, new)
        if not self.checked:
            for k, v in zip(self.keys, self.values):
                check_decode_operands(q, k, v, new)
            for k, v in zip(self.cross_keys, self.cross_values):
                check_decode_operands(q, k, v)
            self.checked = True
        return launch_decode_attention(q, keys, values, n, new)


class SelfAttention(nn.Module):
    """Multi-head self-attention with a packed qkv projection; the packed
    slab feeds the kernels directly: K1 without grad, K1 and K2 through
    autograd.  A mask or attention dropout takes the plain path.

    Without grad and dropout, ``attn_v2`` (the JAX package's
    ``LAYOUTDM_TPU_ATTN_V2``) runs K5 on heads zero-padded to 64 lanes by
    a scatter of the projection weights on each forward, and ``smajor``
    (``LAYOUTDM_TPU_SMAJOR``) runs K6 on the sequence-major slab, the bias
    added in the kernel; K5 comes first, as in the JAX ``SelfAttention``.
    Neither has a backward, in the JAX package or here."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 dtype=torch.float32, attn_v2: bool = False, smajor: bool = False):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by nhead {nhead}")
        self.nhead, self.dropout, self.dtype = nhead, dropout, dtype
        self.head_dim = d_model // nhead
        # the switches, where the kernels take these head widths (K5 checks
        # the sequence length per call, as the JAX gate does)
        self.attn_v2 = attn_v2 and can_use_blockdiag(self.head_dim, 0)
        self.smajor = smajor and can_use_smajor(self.head_dim)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, dropout: Optional[Dropout] = None,
                fold_residual: bool = False, mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """attn(x); with ``fold_residual``, x + attn(x) through K4; with
        ``residual``, residual + attn(x), on the K1 path in the out
        projection's GEMM epilogue where `takes_gemm_epilogue` admits it.
        ``mask``: (S, S) additive; ``key_padding_mask``: (B, S), True at
        keys no query may attend."""
        if fold_residual:
            return fused_attention_block(
                x.to(self.dtype), self.qkv.weight, self.qkv.bias,
                self.out.weight, self.out.bias, self.nhead,
            )
        attn_dropout = dropout is not None and self.dropout > 0.0
        inference = dropout is None and not torch.is_grad_enabled()
        if attn_dropout or mask is not None or key_padding_mask is not None:
            out = self._plain(x, mask, key_padding_mask, dropout if attn_dropout else None)
        elif inference and self.attn_v2 and can_use_blockdiag(self.head_dim, x.shape[1]):
            out = self._blockdiag(x)
        elif inference and self.smajor:
            out = self._smajor(x)
        else:
            qkv = _linear(x, self.qkv, self.dtype)
            if torch.is_grad_enabled() and qkv.requires_grad:
                o = fused_attention_qkv_diff(qkv, self.nhead)
            else:
                o = fused_attention_qkv(qkv, self.nhead)
            if residual is not None and takes_gemm_epilogue(o.device, self.dtype, dropout,
                                                            self.out):
                return _linear_epilogue(o, self.out, self.dtype, residual)
            out = _linear(o, self.out, self.dtype)
        return out if residual is None else residual + out

    def _plain(self, x, mask, key_padding_mask, dropout) -> torch.Tensor:
        """The JAX plain path (`nn.py:451-476`): scores in the compute
        dtype, the additive mask added, padded keys filled with -1e9, a
        float32 softmax cast back, dropout on the probabilities."""
        dt, H, hd = self.dtype, self.nhead, self.head_dim
        B, S, D = x.shape
        q, k, v = _linear(x, self.qkv, dt).reshape(B, S, 3, H, hd).unbind(2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if mask is not None:
            scores = scores + mask[None, None].to(scores.dtype)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], -1e9)
        attn = torch.softmax(scores.float(), dim=-1).to(dt)
        if dropout is not None:
            attn = dropout(attn, self.dropout)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, S, D)
        return _linear(o, self.out, dt)

    def decode_step(self, x: torch.Tensor, cache: KVCache, layer: int) -> torch.Tensor:
        """One token (B, 1, D) against the filled prefix of ``layer``'s
        caches, its own key and value written at ``cache.index`` (JAX
        `SelfAttention._decode_step`, `nn.py:185-213`), both in one call of
        `KVCache.attend`.  The JAX step fills the scores past the prefix
        with -1e9, whose weights are exactly 0 after the softmax: here those
        keys are left out."""
        dt, H, hd = self.dtype, self.nhead, self.head_dim
        B = x.shape[0]
        q, k, v = _linear(x, self.qkv, dt).reshape(B, 1, 3, H, hd).unbind(2)
        o = cache.attend(q, layer, (k, v))
        return _linear(o, self.out, dt)

    def _blockdiag(self, x: torch.Tensor) -> torch.Tensor:
        """K5 between the padded-head projections (JAX `nn.py:271-287`)."""
        dt, H, hd = self.dtype, self.nhead, self.head_dim
        hp = padded_head_dim(hd)
        wp, bp = scatter_qkv_weights(self.qkv.weight.to(dt), self.qkv.bias.to(dt), H, hd, hp)
        o = blockdiag_attention(F.linear(x.to(dt), wp, bp), H, hp, 1.0 / math.sqrt(hd))
        wop = scatter_out_weights(self.out.weight.to(dt), H, hd, hp)
        return F.linear(o, wop, self.out.bias.to(dt))

    def _smajor(self, x: torch.Tensor) -> torch.Tensor:
        """K6 on the bias-free projection of the sequence-major input (JAX
        `nn.py:335-349`).  The projection reads x through a sequence-major
        view: on the card one strided batched GEMM, with no copy of x."""
        dt = self.dtype
        qkv_sb = F.linear(x.to(dt).transpose(0, 1), self.qkv.weight.to(dt))
        o = fused_attention_qkv_smajor(qkv_sb, self.qkv.bias, self.nhead)
        return _linear(o, self.out, dt)


class Block(nn.Module):
    """Pre-norm encoder block (`transformer_utils.py:103-210`); its attention
    sublayer and its FFN each run in a span (`utils.profiling.span`)."""

    def __init__(self, cfg: BackboneConfig, dtype=torch.float32,
                 fused_block: bool = False, fused_ffn: bool = False,
                 attn_v2: bool = False, smajor: bool = False):
        super().__init__()
        self.dtype = dtype
        self.dropout = cfg.dropout
        self.activation_name = cfg.activation
        self.activation = ACTIVATIONS[cfg.activation]
        # the switches, where the kernels take these shapes
        self.fused_block = fused_block and can_use_fused_block(
            cfg.d_model // cfg.nhead, cfg.d_model
        )
        self.fused_ffn = fused_ffn and can_use_fused_ffn(cfg.d_model, cfg.activation)
        tt = cfg.timestep_type
        if tt is None:
            self.norm1 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        else:
            norm = AdaInsNorm if "adainnorm" in tt else AdaLayerNorm
            self.norm1 = norm(cfg.d_model, cfg.diffusion_step, tt)
        self.attn = SelfAttention(cfg.d_model, cfg.nhead, cfg.dropout, dtype, attn_v2, smajor)
        self.linear1 = nn.Linear(cfg.d_model, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, cfg.d_model)
        self.norm2 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, timestep: Optional[torch.Tensor],
                dropout: Optional[Dropout] = None, mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, layer: int = 0) -> torch.Tensor:
        """``mask`` / ``key_padding_mask``: as `SelfAttention`; ``cache``:
        decode one token against ``layer``'s caches."""
        drop = dropout or (lambda h, rate, cols=None: h)
        if isinstance(self.norm1, (AdaLayerNorm, AdaInsNorm)):
            x = self.norm1(x, timestep)
        else:
            x = affine_norm(self.norm1, x, self.dtype)
        # the trunk is REPLACED by norm1(x) (reference quirk), and the
        # residual stream is carried in the compute dtype
        x = x.to(self.dtype)
        # the fused kernels have no backward and no dropout: inference only
        inference = dropout is None and not torch.is_grad_enabled()
        masked = mask is not None or key_padding_mask is not None
        with span("layoutdm.attention"):
            if cache is not None:
                x = x + self.attn.decode_step(x, cache, layer)
            elif self.fused_block and inference and not masked:
                x = self.attn(x, fold_residual=True)
            elif inference:
                x = self.attn(x, mask=mask, key_padding_mask=key_padding_mask, residual=x)
            else:
                x = x + drop(self.attn(x, dropout, mask=mask, key_padding_mask=key_padding_mask),
                             self.dropout)
        with span("layoutdm.ffn"):
            # the FFN does not see the mask: K3 keeps a masked inference call
            if self.fused_ffn and inference:
                return fused_ln_ffn_residual(
                    x, self.norm2.weight, self.norm2.bias, self.linear1.weight,
                    self.linear1.bias, self.linear2.weight, self.linear2.bias,
                    self.activation_name, LN_EPS,
                )
            h = affine_norm(self.norm2, x, self.dtype)
            if cache is None and takes_gemm_epilogue(h.device, self.dtype, dropout, self.linear1,
                                                     self.linear2,
                                                     activation=self.activation_name):
                h = _linear_epilogue(h, self.linear1, self.dtype)
                return _linear_epilogue(h, self.linear2, self.dtype, residual=x)
            h = self.activation(_linear(h, self.linear1, self.dtype))
            # the hidden's own columns where `parallel.tp` splits the FFN
            h = _linear(drop(h, self.dropout, getattr(self.linear1, "tensor_parallel", None)),
                        self.linear2, self.dtype)
            return x + drop(h, self.dropout)


class TransformerEncoder(nn.Module):
    """Stack of Blocks threading the timestep (`transformer_utils.py:213-246`)."""

    def __init__(self, cfg: BackboneConfig, dtype=torch.float32, **switches):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg, dtype, **switches) for _ in range(cfg.num_layers))

    def forward(self, x: torch.Tensor, timestep: Optional[torch.Tensor],
                dropout: Optional[Dropout] = None, mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, timestep, dropout, mask, key_padding_mask, cache, i)
        return x


class PositionalEmbedding(nn.Module):
    """Learned absolute positions (`nn_lib.py:73-89`)."""

    def __init__(self, d_model: int, max_token_length: int):
        super().__init__()
        self.pos_emb = nn.Parameter(torch.empty(max_token_length, d_model))

    def forward(self, S: int, position: Optional[int] = None) -> torch.Tensor:
        if position is not None:
            return self.pos_emb[position : position + 1][None]
        return self.pos_emb[:S][None]


class ElementPositionalEmbedding(nn.Module):
    """Factored (element-id + attribute-id) positions (`nn_lib.py:91-134`),
    with the optional BOS slot when max_token_length % n_attr == 1."""

    def __init__(self, d_model: int, max_token_length: int, n_attr_per_elem: int = 5):
        super().__init__()
        remainder = max_token_length % n_attr_per_elem
        if remainder not in (0, 1):
            raise ValueError(f"token length {max_token_length} % {n_attr_per_elem}")
        self.n_attr = n_attr_per_elem
        self.max_token_length = max_token_length
        n_elem = max_token_length // n_attr_per_elem
        self.elem_emb = nn.Parameter(torch.empty(n_elem, d_model))
        self.attr_emb = nn.Parameter(torch.empty(n_attr_per_elem, d_model))
        self.bos_emb = (
            nn.Parameter(torch.empty(1, d_model)) if remainder == 1 else None
        )

    def forward(self, S: int, position: Optional[int] = None) -> torch.Tensor:
        n_elem = self.elem_emb.shape[0]
        emb = torch.repeat_interleave(self.elem_emb, self.n_attr, dim=0) + (
            self.attr_emb.repeat(n_elem, 1)
        )
        if self.bos_emb is not None:
            emb = torch.cat([self.bos_emb, emb], dim=0)[: self.max_token_length]
        if position is not None:
            return emb[position : position + 1][None]
        return emb[:S][None]


class CategoricalTransformer(nn.Module):
    """Token-sequence denoiser (`nn_lib.py:137-237`): embed -> positions ->
    timestep-aware encoder -> float32 LayerNorm + linear head over the
    vocabulary.  Returns (B, S, V) float32 logits.  ``lookahead=False``
    adds the causal mask (the autoregressive models)."""

    def __init__(
        self,
        backbone: BackboneConfig,
        num_classes: int,
        max_token_length: int,
        pos_emb: str = "elem_attr",
        n_attr_per_elem: int = 5,
        dtype=torch.float32,
        lookahead: bool = True,
        **switches,
    ):
        """``switches``: the denoiser-path keywords of `Block`
        (``fused_block``, ``fused_ffn``, ``attn_v2``, ``smajor``)."""
        super().__init__()
        d = backbone.d_model
        self.dtype = dtype
        self.lookahead = lookahead
        self.max_token_length = max_token_length
        self.cat_emb = nn.Embedding(num_classes, d)
        self.pos = positional_embedding(pos_emb, d, max_token_length, n_attr_per_elem)
        self.backbone = TransformerEncoder(backbone, dtype, **switches)
        self.head_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, num_classes, bias=False)

    def forward(self, seq: torch.Tensor, timestep: Optional[torch.Tensor] = None,
                dropout: Optional[Dropout] = None,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits; ``dropout`` switches training mode on;
        ``key_padding_mask`` (B, S) is True at keys no query attends."""
        S = seq.shape[1]
        h = embed_tokens(self.cat_emb.weight, seq, self.dtype)
        h = h + self.pos(S)
        if dropout is not None:
            h = dropout(h, EMB_DROPOUT)
        mask = None
        if not self.lookahead:
            mask = torch.triu(torch.full((S, S), -torch.inf, device=seq.device), diagonal=1)
        h = self.backbone(h.to(self.dtype), timestep, dropout, mask, key_padding_mask)
        return self.head(affine_norm(self.head_norm, h, torch.float32))

    def new_cache(self, batch: int) -> KVCache:
        """Empty decode caches for ``batch`` rows, as long as the positions."""
        attn = self.backbone.layers[0].attn
        return KVCache(len(self.backbone.layers), batch, self.max_token_length,
                       attn.nhead, attn.head_dim, self.dtype, self.cat_emb.weight.device)

    def decode_step(self, tok: torch.Tensor, cache: KVCache,
                    timestep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, 1) tokens at position ``cache.index`` -> (B, 1, V) logits;
        writes their keys and values and advances the position (the JAX
        ``decode=True`` call, which reads its position from the cache)."""
        h = embed_tokens(self.cat_emb.weight, tok, self.dtype)
        h = h + self.pos(1, position=cache.index)
        h = self.backbone(h.to(self.dtype), timestep, cache=cache)
        cache.index += 1
        return self.head(affine_norm(self.head_norm, h, torch.float32))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights at the flax initializers' scales, drawn on the CPU
    from ``generator`` (so one seed gives one model on any device): Dense
    kernels N(0, 1/fan_in), embeddings N(0, 1/dim), positions U[0, 1),
    zero biases, unit norm scales."""

    def fill(p: torch.Tensor, draw: torch.Tensor) -> None:
        p.copy_(draw.to(p.dtype))

    for m in module.modules():
        if isinstance(m, nn.Linear):
            fill(m.weight, torch.randn(m.weight.shape, generator=generator)
                 / math.sqrt(m.in_features))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            fill(m.weight, torch.randn(m.weight.shape, generator=generator)
                 / math.sqrt(m.embedding_dim))
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (PositionalEmbedding, ElementPositionalEmbedding)):
            for p in m.parameters(recurse=False):
                fill(p, torch.rand(p.shape, generator=generator))


def positional_embedding(pos_emb: str, d_model: int, max_token_length: int,
                         n_attr_per_elem: int) -> nn.Module:
    if pos_emb == "default":
        return PositionalEmbedding(d_model, max_token_length)
    return ElementPositionalEmbedding(d_model, max_token_length, n_attr_per_elem)


class CategoricalAggregatedTransformer(nn.Module):
    """Element-aggregated denoiser (`nn_lib.py:403-452`, JAX
    `CategoricalAggregatedTransformer`): the attribute embeddings of each
    element are joined into one token (a float32 Dense + ReLU) before the
    encoder and expanded back after it, so attention runs over the
    elements (S / 5).  LayoutDM's ``transformer_type="aggregated"``."""

    def __init__(self, backbone: BackboneConfig, num_classes: int, max_token_length: int,
                 n_attr_per_elem: int = 5, dtype=torch.float32, **switches):
        super().__init__()
        d = backbone.d_model
        self.dtype, self.n_attr = dtype, n_attr_per_elem
        self.cat_emb = nn.Embedding(num_classes, d)
        self.enc = nn.Linear(n_attr_per_elem * d, d)
        self.pos = PositionalEmbedding(d, max_token_length)
        self.backbone = TransformerEncoder(backbone, dtype, **switches)
        self.dec = nn.Linear(d, n_attr_per_elem * d)
        self.head_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, num_classes, bias=False)

    def forward(self, seq: torch.Tensor, timestep: Optional[torch.Tensor] = None,
                dropout: Optional[Dropout] = None,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S = seq.shape
        A, d = self.n_attr, self.cat_emb.embedding_dim
        h = embed_tokens(self.cat_emb.weight, seq, self.dtype)
        if dropout is not None:
            h = dropout(h, EMB_DROPOUT)
        h = F.relu(self.enc(h.reshape(B, S // A, A * d).float()))
        h = h + self.pos(S // A)
        h = self.backbone(h.to(self.dtype), timestep, dropout, None, key_padding_mask)
        h = F.relu(self.dec(h.float())).reshape(B, S, d)
        return self.head(affine_norm(self.head_norm, h, torch.float32))


class CrossAttention(nn.Module):
    """Decoder cross-attention (JAX `CrossAttention`, `nn.py:838-896`): a
    q projection of the decoder stream, a packed kv projection of the
    encoder memory and an out projection, on the plain path (scores in the
    compute dtype, float32 softmax cast back).  The cached decode (keys and
    values projected before) runs through `KVCache.attend`, which reads
    them in place from the packed projection."""

    def __init__(self, d_model: int, nhead: int, dtype=torch.float32):
        super().__init__()
        self.nhead, self.dtype = nhead, dtype
        self.head_dim = d_model // nhead
        self.q = nn.Linear(d_model, d_model)
        self.kv = nn.Linear(d_model, 2 * d_model)
        self.out = nn.Linear(d_model, d_model)

    def project_memory(self, memory: torch.Tensor):
        """(B, M, D) memory -> its keys and values, each (B, M, H, hd)."""
        B, M, _ = memory.shape
        kv = _linear(memory, self.kv, self.dtype).reshape(B, M, 2, self.nhead, self.head_dim)
        return kv.unbind(2)

    def forward(self, x: torch.Tensor, memory: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, layer: int = 0) -> torch.Tensor:
        """``cache``: the cached decode, ``layer``'s keys and values
        projected before (`KVCache.attend`); else projected from
        ``memory``."""
        dt, H, hd = self.dtype, self.nhead, self.head_dim
        B, S, _ = x.shape
        q = _linear(x, self.q, dt).reshape(B, S, H, hd)
        if cache is not None:
            return _linear(cache.attend(q, layer), self.out, dt)
        k, v = self.project_memory(memory)
        return _linear(decode_attention_reference(q, k, v, k.shape[1]), self.out, dt)


class DecoderBlock(nn.Module):
    """Pre-norm decoder block (JAX `DecoderBlock`, `nn.py:899-957`; torch's
    ``TransformerDecoderLayer(norm_first=True)``): norm1, causal
    self-attention, norm2, cross-attention, norm3, FFN, each with its
    residual.  The FFN runs K3 only on a full-sequence inference call
    under ``fused_ffn``; the cached decode keeps the unfused FFN.  Each
    sublayer with its norm and residual runs in a span:
    ``layoutdm.dec_self_attention`` (the cache write too),
    ``layoutdm.cross_attention``, ``layoutdm.dec_ffn``."""

    def __init__(self, cfg: BackboneConfig, dtype=torch.float32, fused_ffn: bool = False):
        super().__init__()
        d = cfg.d_model
        self.dtype, self.dropout = dtype, cfg.dropout
        self.activation_name = cfg.activation
        self.activation = ACTIVATIONS[cfg.activation]
        self.fused_ffn = fused_ffn and can_use_fused_ffn(d, cfg.activation)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.self_attn = SelfAttention(d, cfg.nhead, cfg.dropout, dtype)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.cross_attn = CrossAttention(d, cfg.nhead, dtype)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)
        self.linear1 = nn.Linear(d, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, d)

    def forward(self, x: torch.Tensor, memory: Optional[torch.Tensor],
                mask: Optional[torch.Tensor] = None, dropout: Optional[Dropout] = None,
                cache: Optional[KVCache] = None, layer: int = 0) -> torch.Tensor:
        """``mask``: the (S, S) additive causal mask; ``cache``: decode one
        token against ``layer``'s self-attention caches and its prefilled
        cross keys and values (``memory`` is then unused)."""
        drop = dropout or (lambda h, rate, cols=None: h)
        with span("layoutdm.dec_self_attention"):
            h = affine_norm(self.norm1, x, self.dtype)
            if cache is not None:
                h = self.self_attn.decode_step(h, cache, layer)
            else:
                h = self.self_attn(h, dropout, mask=mask)
            x = x + drop(h, self.dropout)
        with span("layoutdm.cross_attention"):
            x = x + drop(self.cross_attn(affine_norm(self.norm2, x, self.dtype), memory, cache,
                                         layer), self.dropout)
        with span("layoutdm.dec_ffn"):
            if (self.fused_ffn and cache is None and dropout is None
                    and not torch.is_grad_enabled()):
                return fused_ln_ffn_residual(
                    x, self.norm3.weight, self.norm3.bias, self.linear1.weight,
                    self.linear1.bias, self.linear2.weight, self.linear2.bias,
                    self.activation_name, LN_EPS,
                )
            h = self.activation(_linear(affine_norm(self.norm3, x, self.dtype), self.linear1,
                                        self.dtype))
            return x + drop(_linear(h, self.linear2, self.dtype), self.dropout)


class CategoricalEncDecTransformer(nn.Module):
    """BART-style encoder-decoder over token sequences (`nn_lib.py:316-400`,
    JAX `CategoricalEncDecTransformer`): the encoder is `TransformerEncoder`
    with plain LayerNorms (its mask-free inference reaches the kernels as
    any encoder's does), the decoder `DecoderBlock`s under a causal mask.
    Module names follow the flax tree (``input_emb``, ``target_pos``,
    ``encoder.layers.i``, ``dec{i}``, ``cross_attn.kv``, ...), so
    `utils.params.params_from_flax` maps a JAX tree onto it."""

    def __init__(self, backbone: BackboneConfig, num_classes: int, max_token_length: int,
                 pos_emb: str = "default", n_attr_per_elem: int = 5,
                 dtype=torch.float32, **switches):
        """``max_token_length``: the decoder length (BOS included);
        ``switches``: the encoder's denoiser-path keywords of `Block`;
        ``fused_ffn`` also reaches the decoder's full-sequence FFN."""
        super().__init__()
        d = backbone.d_model
        self.dtype = dtype
        self.max_token_length = max_token_length
        self.num_layers = backbone.num_layers
        self.input_emb = nn.Embedding(num_classes, d)
        self.target_emb = nn.Embedding(num_classes, d)
        self.input_pos = positional_embedding(pos_emb, d, max_token_length, n_attr_per_elem)
        self.target_pos = positional_embedding(pos_emb, d, max_token_length, n_attr_per_elem)
        self.encoder = TransformerEncoder(backbone, dtype, **switches)
        for i in range(backbone.num_layers):
            self.add_module(f"dec{i}", DecoderBlock(backbone, dtype,
                                                    switches.get("fused_ffn", False)))
        self.head_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, num_classes, bias=False)

    @property
    def decoder(self):
        return [getattr(self, f"dec{i}") for i in range(self.num_layers)]

    def forward(self, input_seq: Optional[torch.Tensor],
                target_seq: Optional[torch.Tensor] = None,
                dropout: Optional[Dropout] = None,
                memory: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits of the decoder over ``target_seq`` (B, S); with
        ``target_seq=None`` the encoder memory of ``input_seq``, and with
        ``memory`` given the encoder is skipped."""
        if memory is None:
            h = embed_tokens(self.input_emb.weight, input_seq, self.dtype)
            h = h + self.input_pos(input_seq.shape[1])
            if dropout is not None:
                h = dropout(h, EMB_DROPOUT)
            memory = self.encoder(h.to(self.dtype), None, dropout)
            if target_seq is None:
                return memory
        S = target_seq.shape[1]
        h = embed_tokens(self.target_emb.weight, target_seq, self.dtype) + self.target_pos(S)
        causal = torch.triu(torch.full((S, S), -torch.inf, device=target_seq.device), diagonal=1)
        h = h.to(self.dtype)
        for blk in self.decoder:
            h = blk(h, memory, causal, dropout)
        return self.head(affine_norm(self.head_norm, h, torch.float32))

    def new_cache(self, batch: int, memory: torch.Tensor) -> KVCache:
        """Decode caches for ``batch`` rows: empty self-attention caches as
        long as the decoder, and each layer's cross keys and values
        projected once from ``memory`` (the JAX prefill pass)."""
        attn = self.dec0.self_attn
        cache = KVCache(self.num_layers, batch, self.max_token_length, attn.nhead,
                        attn.head_dim, self.dtype, memory.device)
        for blk in self.decoder:
            k, v = blk.cross_attn.project_memory(memory)
            cache.cross_keys.append(k)
            cache.cross_values.append(v)
        return cache

    def decode_step(self, tok: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """(B, 1) decoder tokens at position ``cache.index`` -> (B, 1, V)
        logits; writes their keys and values and advances the position."""
        h = embed_tokens(self.target_emb.weight, tok, self.dtype)
        h = (h + self.target_pos(1, position=cache.index)).to(self.dtype)
        for i, blk in enumerate(self.decoder):
            h = blk(h, None, cache=cache, layer=i)
        cache.index += 1
        return self.head(affine_norm(self.head_norm, h, torch.float32))


class LayoutElementEncoder(nn.Module):
    """(label, quantized box) of each element -> one vector
    (`models/common/layout.py` LayoutEncoder, emb_concat + concat_fc)."""

    def __init__(self, d_model: int, num_labels: int, num_bins: int):
        super().__init__()
        self.label_emb = nn.Embedding(num_labels, d_model)
        for key in "xywh":
            self.add_module(f"{key}_emb", nn.Embedding(num_bins, d_model))
        self.fc = nn.Linear(5 * d_model, d_model)

    def forward(self, label: torch.Tensor, bbox_ids: torch.Tensor) -> torch.Tensor:
        embs = [self.label_emb(label)]
        embs += [getattr(self, f"{key}_emb")(bbox_ids[..., i]) for i, key in enumerate("xywh")]
        return self.fc(torch.cat(embs, dim=-1))


class LayoutElementDecoder(nn.Module):
    """Vector -> per-attribute logits (`models/common/layout.py`
    LayoutDecoder counterpart)."""

    def __init__(self, d_model: int, num_labels: int, num_bins: int):
        super().__init__()
        self.num_bins = num_bins
        self.label_head = nn.Linear(d_model, num_labels)
        self.bbox_head = nn.Linear(d_model, 4 * num_bins)

    def forward(self, h: torch.Tensor):
        return {"label": self.label_head(h),
                "bbox": self.bbox_head(h).reshape(h.shape[:-1] + (4, self.num_bins))}


class ElementTransformer(nn.Module):
    """Element-level transformer (`nn_lib.py:455-509`, JAX
    `ElementTransformer`): one token per element through the layout codec,
    a causal (``lookahead=False``) or bidirectional encoder, a float32
    LayerNorm and per-attribute logits."""

    def __init__(self, backbone: BackboneConfig, num_labels: int, num_bins: int,
                 lookahead: bool = False, dtype=torch.float32, **switches):
        super().__init__()
        d = backbone.d_model
        self.lookahead, self.dtype = lookahead, dtype
        self.enc = LayoutElementEncoder(d, num_labels, num_bins)
        self.backbone = TransformerEncoder(backbone, dtype, **switches)
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.dec = LayoutElementDecoder(d, num_labels, num_bins)

    def forward(self, label: torch.Tensor, bbox_ids: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                timestep: Optional[torch.Tensor] = None,
                dropout: Optional[Dropout] = None):
        h = self.enc(label, bbox_ids)
        if dropout is not None:
            h = dropout(h, EMB_DROPOUT)
        mask = None
        if not self.lookahead:
            S = label.shape[1]
            mask = torch.triu(torch.full((S, S), -torch.inf, device=label.device), diagonal=1)
        h = self.backbone(h.to(self.dtype), timestep, dropout, mask, key_padding_mask)
        return self.dec(affine_norm(self.norm, h, torch.float32))


def denoiser_path(net: nn.Module) -> str:
    """The kernels the denoiser's (an encoder-decoder's: its encoder's)
    mask-free inference runs."""
    stack = net.backbone if hasattr(net, "backbone") else net.encoder
    block = stack.layers[0]
    if block.fused_block:
        attn = "fused attention block (K4)"
    elif block.attn.attn_v2:
        attn = "block-diagonal attention (K5)"
    elif block.attn.smajor:
        attn = "S-major attention (K6)"
    else:
        attn = "attention (K1)"
    ffn = "fused LN-FFN-residual (K3)" if block.fused_ffn else "unfused FFN"
    return f"{attn} + {ffn}"


def make_module(cls, device, generator: Optional[torch.Generator] = None, **kwargs):
    """Build ``cls(**kwargs)`` on ``device`` without touching the global
    RNG; its weights come from ``generator`` (seed 0 by default) through
    `init_weights`, or the module's own ``init_params`` where it has one."""
    with torch.device("meta"):
        net = cls(**kwargs)
    net = net.to_empty(device=device).eval()
    generator = generator or torch.Generator().manual_seed(0)
    if hasattr(net, "init_params"):
        net.init_params(generator)
    else:
        init_weights(net, generator)
    return net


def make_transformer(device, generator: Optional[torch.Generator] = None, **kwargs):
    """A `CategoricalTransformer` through `make_module`."""
    return make_module(CategoricalTransformer, device, generator, **kwargs)
