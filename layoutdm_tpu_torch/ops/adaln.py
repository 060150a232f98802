"""The denoiser's adaLN ``norm1`` (`models.nn.AdaLayerNorm`): a
parameter-free LayerNorm modulated by the timestep's scale and shift, in
one CUDA kernel on the inference path, and its plain version.

    out = (LN(x) * (1 + scale) + shift), rounded to x's dtype

Rounding points are the port's (and the flax module's): LayerNorm
statistics in float32 (biased variance, no affine), the normalised value
rounded to x's dtype, then ``1 + scale``, the product and ``+ shift`` as
separately rounded float32 operations, and the result rounded to x's dtype
(the cast `models.nn.Block` makes of norm1's output).

It replaces no TPU kernel: on the TPU, XLA fused these ops.  Eagerly they
are six passes over the (B, S, D) stream, ~10x the bytes of one pass that
reads x and writes the output; the kernel (``csrc/adaln.cu``) is bound by
those bytes and makes that one pass, a warp per row with the row in
registers, the statistics reduced by warp shuffles, scale and shift read
from the small ``cond`` through L2.

On a CUDA tensor `ada_layer_norm` launches the kernel or raises; on a CPU
tensor it runs `ada_layer_norm_reference`.  There is no fallback between
the two.  The kernel has no backward: `AdaLayerNorm` takes it only without
autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from layoutdm_tpu_torch.ops.cuda_build import BuiltLibrary, load_library

# kernel launches made by the wrapper (the CPU path adds nothing)
LAUNCHES_ADALN = 0

MAX_D_MODEL = 1024  # a row in registers: at most 4 (bf16) or 8 (float32) 16-byte vectors a lane
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # values in a 16-byte vector


def can_use_fused_adaln(d_model: int, dtype: torch.dtype) -> bool:
    """Widths and dtypes the kernel takes: float32 or bfloat16 rows of
    whole 16-byte vectors, at most MAX_D_MODEL wide."""
    return dtype in _VEC and 0 < d_model <= MAX_D_MODEL and d_model % _VEC[dtype] == 0


def ada_layer_norm_reference(x: torch.Tensor, cond: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """Plain version, with the kernel's rounding points."""
    D = x.shape[-1]
    scale, shift = cond[:, None].chunk(2, dim=-1)
    # a parameter-free flax LayerNorm returns the input's dtype
    y = F.layer_norm(x.float(), (D,), eps=eps).to(x.dtype)
    return (y * (1 + scale) + shift).to(x.dtype)


@functools.cache
def kernel_library() -> BuiltLibrary:
    """Build (first call) and bind the kernel."""
    built = load_library("adaln", ["adaln.cu"])
    fn = built.lib.ada_layer_norm_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, cond, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B S D
        ctypes.c_float, ctypes.c_int,  # eps, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return built


def ada_layer_norm(x: torch.Tensor, cond: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x`` (B, S, D) in float32 or bfloat16; ``cond`` (B, 2D) float32,
    each row's scale then its shift (`models.nn.AdaNormCond`).  Returns
    (B, S, D) in x's dtype."""
    global LAUNCHES_ADALN
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, D), got {tuple(x.shape)}")
    B, S, D = x.shape
    if tuple(cond.shape) != (B, 2 * D):
        raise ValueError(f"cond must be (B, 2D) = {(B, 2 * D)}, got {tuple(cond.shape)}")
    if x.device.type == "cpu":
        return ada_layer_norm_reference(x, cond, eps)
    if x.device.type != "cuda" or cond.device != x.device:
        raise ValueError(f"no adaLN kernel for x on {x.device}, cond on {cond.device}")
    if not can_use_fused_adaln(D, x.dtype):
        raise ValueError(f"kernel takes d_model <= {MAX_D_MODEL} in whole 16-byte vectors "
                         f"of float32 or bfloat16, got {D} in {x.dtype}")
    if cond.dtype != torch.float32:
        raise TypeError(f"cond must be float32, got {cond.dtype}")
    if not (x.is_contiguous() and cond.is_contiguous()):
        raise ValueError("x and cond must be contiguous")
    if x.data_ptr() % 16 or cond.data_ptr() % 16:
        raise ValueError("x and cond must be 16-byte aligned")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = kernel_library().lib.ada_layer_norm_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), cond.data_ptr(), out.data_ptr(), B, S, D, float(eps),
                 _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ada_layer_norm kernel launch failed: CUDA error {err}")
    LAUNCHES_ADALN += 1
    return out
