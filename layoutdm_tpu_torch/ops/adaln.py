"""The denoiser's LayerNorms on the inference path, each in one pass of
one CUDA kernel (``csrc/adaln.cu``), and their plain versions.

adaLN ``norm1`` (`models.nn.AdaLayerNorm`): a parameter-free LayerNorm
modulated by the timestep's scale and shift.

    out = (LN(x) * (1 + scale) + shift), rounded to x's dtype

Rounding points are the port's (and the flax module's): LayerNorm
statistics in float32 (biased variance, no affine), the normalised value
rounded to x's dtype, then ``1 + scale``, the product and ``+ shift`` as
separately rounded float32 operations, and the result rounded to x's dtype
(the cast `models.nn.Block` makes of norm1's output).

Affine LayerNorm (`models.nn.affine_norm`: each Block's ``norm2``, the
plain ``norm1`` of a Block without timestep, the heads' norms and
`DecoderBlock`'s): ``F.layer_norm(x.float(), (D,), w, b, eps)``, its
statistics and ``(x - mean) * rstd * w + b`` in float32 with no rounding
in between, rounded to the output dtype: x's (the cast the Dense after
the norm makes) or float32 from bfloat16 (the float32 vocab heads).

Neither replaces a TPU kernel: on the TPU, XLA fused these ops.  Eagerly
adaLN is six passes over the (B, S, D) stream, ~10x the bytes of one pass
that reads x and writes the output, and an affine norm three (x to
float32, the float32 LayerNorm, the cast of its output).  The kernel is
bound by those bytes and makes that one pass, a warp per row with the row
in registers, the statistics reduced by warp shuffles, scale and shift (or
weight and bias) read through L2.

On a CUDA tensor `ada_layer_norm` and `layer_norm` launch the kernel or
raise; on a CPU tensor they run `ada_layer_norm_reference` and
`layer_norm_reference`.  There is no fallback between the two.  The
kernel has no backward: the modules take it only without autograd, so
training keeps the plain path and its numerics.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from layoutdm_tpu_torch.ops.cuda_build import BuiltLibrary, load_library

# kernel launches made by the wrappers (the CPU path adds nothing)
LAUNCHES_ADALN = 0
LAUNCHES_LN = 0

MAX_D_MODEL = 1024  # a row in registers: at most 4 (bf16) or 8 (float32) 16-byte vectors a lane
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # values in a 16-byte vector
# the affine mode's (x, out) dtypes and their codes
_LN_MODE = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
            (torch.bfloat16, torch.float32): 2}


def can_use_fused_adaln(d_model: int, dtype: torch.dtype) -> bool:
    """Widths and dtypes the kernel takes: float32 or bfloat16 rows of
    whole 16-byte vectors, at most MAX_D_MODEL wide."""
    return dtype in _VEC and 0 < d_model <= MAX_D_MODEL and d_model % _VEC[dtype] == 0


def can_use_fused_ln(d_model: int, dtype: torch.dtype, out_dtype: torch.dtype) -> bool:
    """The affine mode's: rows `can_use_fused_adaln` takes, written in x's
    dtype or, from bfloat16, in float32."""
    return (dtype, out_dtype) in _LN_MODE and can_use_fused_adaln(d_model, dtype)


def ada_layer_norm_reference(x: torch.Tensor, cond: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """Plain version, with the kernel's rounding points."""
    D = x.shape[-1]
    scale, shift = cond[:, None].chunk(2, dim=-1)
    # a parameter-free flax LayerNorm returns the input's dtype
    y = F.layer_norm(x.float(), (D,), eps=eps).to(x.dtype)
    return (y * (1 + scale) + shift).to(x.dtype)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         out_dtype: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of the affine mode, with the kernel's rounding points."""
    return F.layer_norm(x.float(), x.shape[-1:], weight, bias, eps).to(out_dtype)


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
    fn = built.lib.layer_norm_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w, b, out
        ctypes.c_longlong, ctypes.c_int,  # rows, D
        ctypes.c_float, ctypes.c_int,  # eps, mode code
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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               out_dtype: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    """``x`` (..., D) in float32 or bfloat16; ``weight`` and ``bias`` (D,)
    float32.  Returns x's shape in ``out_dtype``: x's dtype, or float32
    from bfloat16."""
    global LAUNCHES_LN
    if x.dim() < 1:
        raise ValueError("x must have a last axis of D values")
    D = x.shape[-1]
    if tuple(weight.shape) != (D,) or tuple(bias.shape) != (D,):
        raise ValueError(f"weight and bias must be ({D},), got {tuple(weight.shape)}, "
                         f"{tuple(bias.shape)}")
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, out_dtype, eps)
    if x.device.type != "cuda" or weight.device != x.device or bias.device != x.device:
        raise ValueError(f"no LayerNorm kernel for x on {x.device}, weight on "
                         f"{weight.device}, bias on {bias.device}")
    if not can_use_fused_ln(D, x.dtype, out_dtype):
        raise ValueError(f"kernel takes d_model <= {MAX_D_MODEL} in whole 16-byte vectors "
                         f"of float32 or bfloat16, written in x's dtype or float32, got {D} "
                         f"in {x.dtype} to {out_dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"weight and bias must be float32, got {weight.dtype}, {bias.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("x, weight and bias must be contiguous")
    if x.data_ptr() % 16 or weight.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("x, weight and bias must be 16-byte aligned")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    fn = kernel_library().lib.layer_norm_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 x.numel() // D, D, float(eps), _LN_MODE[(x.dtype, out_dtype)], stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {err}")
    LAUNCHES_LN += 1
    return out
