"""Self-attention kernels: K1 (packed-qkv forward), K2 (its backward),
K4 (the whole attention block), K6 (K1 on a sequence-major slab), their
plain versions, and the autograd binding of K1 and K2 (port of
``layoutdm_tpu/ops/attention.py::fused_attention_qkv``,
``fused_attention_qkv_bwd``, the custom VJP ``fused_attention_qkv_diff``,
``fused_attention_block`` and ``fused_attention_qkv_smajor``).

``fused_attention_qkv`` takes the denoiser's packed (B, S, 3D) projection
output, heads as ``[h*hd]`` column blocks of q, k and v, and returns
(B, S, D); ``fused_attention_qkv_bwd`` takes the same slab and the (B, S, D)
cotangent and returns the packed (B, S, 3D) d(qkv).  On a CUDA tensor each
launches its hand-written Hopper kernel (``csrc/attention_qkv.cu``,
``csrc/attention_qkv_bwd.cu``, built by ``nvcc`` at first use) or raises; on
a CPU tensor each runs its plain PyTorch twin, which has the kernel's
rounding points.  There is no fallback between the two.

``fused_attention_block`` (K4, ``csrc/attention_block.cu``) takes the
block input x (B, S, D) and the projections in the ``nn.Linear`` layout
(``w_qkv`` (3D, D), ``w_out`` (D, D)) at the native head width, and returns
x + attn(x W_qkvᵀ + b_qkv) W_outᵀ + b_out, the residual added in float32
before the one final rounding (the unfused path rounds the attention
output first).  The TPU package's weight scatter to 64-lane heads is a
layout trick with no counterpart here.

``fused_attention_qkv_smajor`` (K6, ``csrc/attention_smajor.cu``) is K1 on
a sequence-major (S, B, 3D) slab with the qkv bias added to the slab in the
io dtype, returning (B, S, D) as K1 does.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from layoutdm_tpu_torch.ops.cuda_build import BuiltLibrary, load_library

# kernel launches made by the wrappers (the CPU path adds nothing); one K2
# call counts once, though it runs two passes.  LAUNCHES_LONG counts the K1
# and K6 calls that took the long bf16 body (128 < S <= 512: each (row,
# head)'s K and V held in shared memory), by the library's own rule
# (`attention_fwd_long_body`)
LAUNCHES = 0
LAUNCHES_BWD = 0
LAUNCHES_BLOCK = 0
LAUNCHES_SMAJOR = 0
LAUNCHES_LONG = 0

MAX_HEAD_DIM = 128
# K4 stages one head (<= 64 wide) and a (64, D) row tile in shared memory
MAX_BLOCK_HEAD_DIM = 64
MAX_BLOCK_D_MODEL = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _split_dims(qkv: torch.Tensor, num_heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, S, 3D), got {tuple(qkv.shape)}")
    B, S, D3 = qkv.shape
    D = D3 // 3
    if D % num_heads:
        raise ValueError(f"d_model {D} not divisible by num_heads {num_heads}")
    return B, S, D, D // num_heads


def _heads(qkv: torch.Tensor, num_heads: int):
    """q, k, v as (B, S, H, hd) views."""
    B, S, D, hd = _split_dims(qkv, num_heads)
    return (x.reshape(B, S, num_heads, hd) for x in qkv.split(D, dim=-1))


def attention_qkv_reference(
    qkv: torch.Tensor, num_heads: int, scale: float = 0.0
) -> torch.Tensor:
    """Plain version: f32 scores and softmax, probabilities rounded to the
    io dtype, f32 accumulation of p.v, output in the io dtype."""
    B, S, D, hd = _split_dims(qkv, num_heads)
    scale = scale or 1.0 / math.sqrt(hd)
    q, k, v = _heads(qkv, num_heads)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return o.reshape(B, S, D).to(qkv.dtype)


def attention_qkv_bwd_reference(
    qkv: torch.Tensor, do: torch.Tensor, num_heads: int, scale: float = 0.0
) -> torch.Tensor:
    """Plain version of K2, with the TPU kernel's rounding points: f32
    scores, softmax and accumulation; p rounded to the io dtype before
    dv = pᵀ·dO; dp = dO·vᵀ from io-dtype operands; ds = p·(dp − rowsum(dp·p))
    ·scale in f32, rounded to the io dtype before dq = ds·k and dk = dsᵀ·q.
    Returns the packed (B, S, 3D) d(qkv) in the io dtype."""
    B, S, D, hd = _split_dims(qkv, num_heads)
    scale = scale or 1.0 / math.sqrt(hd)
    io = qkv.dtype
    q, k, v = (x.float() for x in _heads(qkv, num_heads))
    g = do.reshape(B, S, num_heads, hd).to(io).float()
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(io).float(), g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    ds = ds.to(io).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.cat([x.reshape(B, S, D) for x in (dq, dk, dv)], dim=-1).to(io)


@functools.cache
def kernel_library() -> BuiltLibrary:
    """Build (first call) and bind the forward kernel K1."""
    built = load_library("attention_qkv", ["attention_qkv.cu"])
    fn = built.lib.attention_qkv_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # qkv, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B S H hd
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    rule = built.lib.attention_qkv_long_body
    rule.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]  # S, hd, dtype code
    rule.restype = ctypes.c_int
    return built


@functools.lru_cache(maxsize=None)
def attention_fwd_long_body(S: int, hd: int, dtype: torch.dtype) -> bool:
    """Whether a K1 or K6 call of S keys at head size hd in ``dtype`` takes
    the long bf16 body: the launcher's rule (``attention_fwd::long_body``),
    asked of K1's built library."""
    return bool(kernel_library().lib.attention_qkv_long_body(S, hd, _DTYPE_CODE[dtype]))


@functools.cache
def bwd_kernel_library() -> BuiltLibrary:
    """Build (first call) and bind the backward kernel K2."""
    built = load_library("attention_qkv_bwd", ["attention_qkv_bwd.cu"])
    fn = built.lib.attention_qkv_bwd_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # qkv, dout
        ctypes.c_void_p, ctypes.c_void_p,  # dqkv, stats scratch
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B S H hd
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return built


def _check_kernel_input(qkv: torch.Tensor, hd: int) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {qkv.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")


def fused_attention_qkv(
    qkv: torch.Tensor, num_heads: int, scale: float = 0.0
) -> torch.Tensor:
    """Attention on the packed qkv slab; ``scale`` overrides 1/sqrt(hd)
    (a zero-padded head slab needs its true head size's scale)."""
    global LAUNCHES, LAUNCHES_LONG
    B, S, D, hd = _split_dims(qkv, num_heads)
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, num_heads, scale)
    _check_kernel_input(qkv, hd)
    scale = scale or 1.0 / math.sqrt(hd)
    fn = kernel_library().lib.attention_qkv_launch
    out = torch.empty((B, S, D), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(
            qkv.data_ptr(), out.data_ptr(), B, S, num_heads, hd,
            float(scale), _DTYPE_CODE[qkv.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_qkv kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_LONG += attention_fwd_long_body(S, hd, qkv.dtype)
    return out


def fused_attention_qkv_bwd(
    qkv: torch.Tensor, do: torch.Tensor, num_heads: int, scale: float = 0.0
) -> torch.Tensor:
    """d(qkv) of `fused_attention_qkv` for the output cotangent ``do``
    (B, S, D), same dtype and device as ``qkv``."""
    global LAUNCHES_BWD
    B, S, D, hd = _split_dims(qkv, num_heads)
    if tuple(do.shape) != (B, S, D):
        raise ValueError(f"do must be {(B, S, D)}, got {tuple(do.shape)}")
    if qkv.device.type == "cpu" and do.device.type == "cpu":
        return attention_qkv_bwd_reference(qkv, do, num_heads, scale)
    _check_kernel_input(qkv, hd)
    if do.device != qkv.device or do.dtype != qkv.dtype:
        raise ValueError(
            f"do ({do.dtype}, {do.device}) must match qkv ({qkv.dtype}, {qkv.device})"
        )
    if not do.is_contiguous():
        raise ValueError("do must be contiguous")
    scale = scale or 1.0 / math.sqrt(hd)
    fn = bwd_kernel_library().lib.attention_qkv_bwd_launch
    dqkv = torch.empty_like(qkv)
    # per (row, head, query): the softmax's log-normaliser (base 2 in
    # bfloat16, e in float32) and rowsum(dp·p)
    stats = torch.empty((B, num_heads, S, 2), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(
            qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            B, S, num_heads, hd, float(scale), _DTYPE_CODE[qkv.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_qkv_bwd kernel launch failed: CUDA error {err}")
    LAUNCHES_BWD += 1
    return dqkv


class _AttentionQKV(torch.autograd.Function):
    """K1 forward, K2 backward; the residual is the qkv slab itself, as in
    the JAX custom VJP."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return fused_attention_qkv(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        do = do.to(qkv.dtype).contiguous()
        return fused_attention_qkv_bwd(qkv, do, ctx.num_heads, ctx.scale), None, None


def fused_attention_qkv_diff(
    qkv: torch.Tensor, num_heads: int, scale: float = 0.0
) -> torch.Tensor:
    """Differentiable `fused_attention_qkv`: its gradient is K2."""
    return _AttentionQKV.apply(qkv, num_heads, scale)


def can_use_smajor(head_dim: int) -> bool:
    """Shapes K6 takes: K1's.  The JAX gate refuses every flagship width
    because eight S-major rows overflow the TPU's scoped VMEM; that limit
    has no counterpart here."""
    return head_dim <= MAX_HEAD_DIM


def _split_smajor(qkv_sb: torch.Tensor, bias: torch.Tensor, num_heads: int):
    if qkv_sb.dim() != 3 or qkv_sb.shape[-1] % 3:
        raise ValueError(f"qkv_sb must be (S, B, 3D), got {tuple(qkv_sb.shape)}")
    S, B, D3 = qkv_sb.shape
    if tuple(bias.shape) != (D3,):
        raise ValueError(f"bias must be ({D3},), got {tuple(bias.shape)}")
    D = D3 // 3
    if D % num_heads:
        raise ValueError(f"d_model {D} not divisible by num_heads {num_heads}")
    return S, B, D, D // num_heads


def attention_qkv_smajor_reference(
    qkv_sb: torch.Tensor, bias: torch.Tensor, num_heads: int, scale: float = 0.0
) -> torch.Tensor:
    """Plain version of K6: the bias added to the slab in the io dtype (one
    rounding), then `attention_qkv_reference` on the batch-major view.
    Returns (B, S, D)."""
    _split_smajor(qkv_sb, bias, num_heads)
    x = (qkv_sb + bias.to(qkv_sb.dtype)).transpose(0, 1)
    return attention_qkv_reference(x, num_heads, scale)


@functools.cache
def smajor_kernel_library() -> BuiltLibrary:
    """Build (first call) and bind the S-major kernel K6."""
    built = load_library("attention_smajor", ["attention_smajor.cu"])
    fn = built.lib.attention_smajor_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qkv_sb, bias, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B S H hd
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return built


def fused_attention_qkv_smajor(
    qkv_sb: torch.Tensor, bias: torch.Tensor, num_heads: int, scale: float = 0.0
) -> torch.Tensor:
    """Attention on the sequence-major packed slab ``qkv_sb`` (S, B, 3D)
    plus its qkv bias (3D,), any float dtype (cast to the slab's); returns
    (B, S, D).  ``scale`` overrides 1/sqrt(hd)."""
    global LAUNCHES_SMAJOR, LAUNCHES_LONG
    S, B, D, hd = _split_smajor(qkv_sb, bias, num_heads)
    if qkv_sb.device.type == "cpu":
        return attention_qkv_smajor_reference(qkv_sb, bias, num_heads, scale)
    _check_kernel_input(qkv_sb, hd)
    scale = scale or 1.0 / math.sqrt(hd)
    bias = bias.to(qkv_sb.device, qkv_sb.dtype).contiguous()
    out = torch.empty((B, S, D), dtype=qkv_sb.dtype, device=qkv_sb.device)
    fn = smajor_kernel_library().lib.attention_smajor_launch
    with torch.cuda.device(qkv_sb.device):
        stream = torch.cuda.current_stream(qkv_sb.device).cuda_stream
        err = fn(
            qkv_sb.data_ptr(), bias.data_ptr(), out.data_ptr(), B, S, num_heads, hd,
            float(scale), _DTYPE_CODE[qkv_sb.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_smajor kernel launch failed: CUDA error {err}")
    LAUNCHES_SMAJOR += 1
    LAUNCHES_LONG += attention_fwd_long_body(S, hd, qkv_sb.dtype)
    return out


def can_use_fused_block(head_dim: int, d_model: int) -> bool:
    """Shapes K4 takes (the JAX gate's VMEM-fit conditions have no
    counterpart here)."""
    return head_dim <= MAX_BLOCK_HEAD_DIM and d_model <= MAX_BLOCK_D_MODEL


def attention_block_reference(
    x: torch.Tensor, w_qkv, b_qkv, w_out, b_out, num_heads: int, scale: float = 0.0
) -> torch.Tensor:
    """Plain version of K4, with its rounding points: projections
    accumulated in float32 over io-dtype operands, qkv rounded to the io
    dtype, attention as `attention_qkv_reference`, the out projection in
    float32 plus b_out plus the residual x, rounded once."""
    dt = x.dtype
    qkv = x.float() @ w_qkv.to(dt).float().T + b_qkv.to(dt).float()
    o = attention_qkv_reference(qkv.to(dt), num_heads, scale)
    out = o.float() @ w_out.to(dt).float().T + b_out.to(dt).float() + x.float()
    return out.to(dt)


@functools.cache
def block_kernel_library() -> BuiltLibrary:
    """Build (first call) and bind the attention-block kernel K4."""
    built = load_library("attention_block", ["attention_block.cu"])
    fn = built.lib.attention_block_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w_qkv, b_qkv
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # w_out, b_out, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B S H hd
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    # how the bf16 launch of a shape projects K and V, and how many of its
    # clusters the card holds at once (chip_smoke reports both)
    built.lib.attention_block_kv_passes.argtypes = [ctypes.c_int] * 3  # S H hd
    built.lib.attention_block_kv_passes.restype = ctypes.c_int
    built.lib.attention_block_max_clusters.argtypes = [ctypes.c_int]  # H
    built.lib.attention_block_max_clusters.restype = ctypes.c_int
    return built


def fused_attention_block(
    x: torch.Tensor, w_qkv, b_qkv, w_out, b_out, num_heads: int, scale: float = 0.0
) -> torch.Tensor:
    """x + attention block of x: ``x`` (B, S, D) float32 or bfloat16,
    ``w_qkv`` (3D, D), ``b_qkv`` (3D,), ``w_out`` (D, D), ``b_out`` (D,)
    in any float dtype (cast to x's); ``scale`` overrides 1/sqrt(hd)."""
    global LAUNCHES_BLOCK
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, D), got {tuple(x.shape)}")
    B, S, D = x.shape
    if D % num_heads:
        raise ValueError(f"d_model {D} not divisible by num_heads {num_heads}")
    if (tuple(w_qkv.shape) != (3 * D, D) or tuple(b_qkv.shape) != (3 * D,)
            or tuple(w_out.shape) != (D, D) or tuple(b_out.shape) != (D,)):
        raise ValueError(f"block weights do not match d_model {D}")
    hd = D // num_heads
    if x.device.type == "cpu":
        return attention_block_reference(x, w_qkv, b_qkv, w_out, b_out, num_heads, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no attention-block kernel for device {x.device}")
    dt = x.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dt}")
    if not can_use_fused_block(hd, D):
        raise ValueError(
            f"head dim {hd} / d_model {D} over the kernel's "
            f"{MAX_BLOCK_HEAD_DIM} / {MAX_BLOCK_D_MODEL}"
        )
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    scale = scale or 1.0 / math.sqrt(hd)
    w_qkv, b_qkv, w_out, b_out = (
        p.to(x.device, dt).contiguous() for p in (w_qkv, b_qkv, w_out, b_out)
    )
    out = torch.empty_like(x)
    fn = block_kernel_library().lib.attention_block_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), w_out.data_ptr(),
            b_out.data_ptr(), out.data_ptr(), B, S, num_heads, hd,
            float(scale), _DTYPE_CODE[dt], stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_block kernel launch failed: CUDA error {err}")
    LAUNCHES_BLOCK += 1
    return out
