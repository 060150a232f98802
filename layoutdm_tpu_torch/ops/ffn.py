"""LayerNorm -> linear1 -> activation -> linear2 -> residual: the CUDA
kernel K3 and its plain version (port of
``layoutdm_tpu/ops/ffn.py::fused_ln_ffn_residual``).

    out = x + (act(LN(x) W1ᵀ + b1) W2ᵀ + b2)

Weights come in the ``nn.Linear`` layout the port stores: ``w1`` is
(F, D) (``linear1.weight``) and ``w2`` is (D, F) (``linear2.weight``), the
transposes of the JAX function's (D, F) and (F, D) kernels.  Rounding
points follow the TPU kernel: LayerNorm in float32 with float32 scale and
bias; its output, the weights and both biases in the io dtype; products
accumulated in float32; activation in float32; the hidden rounded to the
io dtype before the second product; product plus b2 rounded to the io
dtype, then the residual added in the io dtype.

On a CUDA tensor `fused_ln_ffn_residual` launches the hand-written Hopper
kernel (``csrc/ffn.cu``, built by ``nvcc`` at first use) or raises; on a
CPU tensor it runs `ln_ffn_residual_reference`.  There is no fallback
between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from layoutdm_tpu_torch.ops.cuda_build import BuiltLibrary, load_library

# kernel launches made by the wrapper (the CPU path adds nothing)
LAUNCHES_FFN = 0

# the denoiser's FFN activations (the unfused path uses them too)
ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda h: F.gelu(h, approximate="tanh"),  # jax.nn.gelu's default
    "gelu2": lambda h: h * torch.sigmoid(1.702 * h),
}
ACTIVATION_CODES = {"relu": 0, "gelu": 1, "gelu2": 2}
MAX_D_MODEL = 512  # the kernel keeps a (32, D) row tile and (D, 32) weight tiles in shared memory
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def can_use_fused_ffn(d_model: int, activation: str) -> bool:
    """Shapes and activations the kernel takes (the JAX gate's VMEM-fit
    conditions have no counterpart here)."""
    return activation in ACTIVATION_CODES and d_model <= MAX_D_MODEL


def ln_ffn_residual_reference(
    x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2,
    activation: str = "gelu2", eps: float = 1e-6,
) -> torch.Tensor:
    """Plain version, with the kernel's rounding points."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    ln = (xf - mean) * torch.rsqrt(var + eps)
    ln = ln * ln_scale.float() + ln_bias.float()
    h = ln.to(dt).float() @ w1.to(dt).float().T
    h = ACTIVATIONS[activation](h + b1.to(dt).float())
    out = h.to(dt).float() @ w2.to(dt).float().T + b2.to(dt).float()
    return x + out.to(dt)


@functools.cache
def kernel_library() -> BuiltLibrary:
    """Build (first call) and bind K3."""
    built = load_library("ffn", ["ffn.cu"])
    fn = built.lib.ln_ffn_residual_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, ln scale, ln bias
        ctypes.c_void_p, ctypes.c_void_p,  # w1, b1
        ctypes.c_void_p, ctypes.c_void_p,  # w2, b2
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M D F
        ctypes.c_int, ctypes.c_float, ctypes.c_int,  # activation, eps, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return built


def fused_ln_ffn_residual(
    x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2,
    activation: str = "gelu2", eps: float = 1e-6,
) -> torch.Tensor:
    """``x`` (B, S, D) or (M, D) in float32 or bfloat16; ``ln_scale``,
    ``ln_bias`` (D,); ``w1`` (F, D), ``b1`` (F,), ``w2`` (D, F), ``b2``
    (D,), any float dtype (cast to float32 for the norm and to the io
    dtype for the rest)."""
    global LAUNCHES_FFN
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation: {activation}")
    D = x.shape[-1]
    Fd = w1.shape[0]
    if tuple(w1.shape) != (Fd, D) or tuple(w2.shape) != (D, Fd):
        raise ValueError(
            f"w1 must be (F, D) and w2 (D, F) for D={D}: got {tuple(w1.shape)}, "
            f"{tuple(w2.shape)}"
        )
    if tuple(b1.shape) != (Fd,) or any(tuple(p.shape) != (D,) for p in (ln_scale, ln_bias, b2)):
        raise ValueError("b1 must be (F,) and ln_scale, ln_bias, b2 (D,)")
    if x.device.type == "cpu":
        return ln_ffn_residual_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, activation, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no FFN kernel for device {x.device}")
    dt = x.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dt}")
    if D > MAX_D_MODEL:
        raise ValueError(f"d_model {D} > {MAX_D_MODEL}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    dev = x.device
    g, b = (p.to(dev, torch.float32).contiguous() for p in (ln_scale, ln_bias))
    w1, b1, w2, b2 = (p.to(dev, dt).contiguous() for p in (w1, b1, w2, b2))
    M = x.numel() // D
    out = torch.empty_like(x)
    fn = kernel_library().lib.ln_ffn_residual_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), M, D, Fd,
            ACTIVATION_CODES[activation], float(eps), _DTYPE_CODE[dt], stream,
        )
    if err != 0:
        raise RuntimeError(f"ln_ffn_residual kernel launch failed: CUDA error {err}")
    LAUNCHES_FFN += 1
    return out
