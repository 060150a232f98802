"""The denoiser's bf16 GEMMs with their elementwise tail in cuBLASLt's
epilogue (``csrc/gemm_epilogue.cu``), and their plain versions.

    linear_relu:      relu(x Wᵀ + b)       (linear1)
    linear_residual:  r + x Wᵀ + b         (linear2, the attention's out projection)

Weights come in the ``nn.Linear`` layout, (N, K).  Rounding points: the
products accumulate in float32, the bias (and the residual) are added to
the float32 sum, and the result is rounded to bf16 once.  ReLU commutes with
that rounding, so `linear_relu` is the eager ``F.relu(F.linear(...))``;
`linear_residual` rounds once where the eager ``r + F.linear(...)`` rounds
the product first and then the sum.

Replaces no TPU kernel: on the TPU, XLA fused the activation and the
residual adds into the products.  Eagerly each is a pass of its own over
the GEMM's output; the epilogue removes the pass (the residual is read as
the GEMM's C, the same bytes the add read).  PyTorch exposes a bias + ReLU
epilogue (``torch._addmm_activation``) but no bias + full C, so one shim
takes both and keeps the layout, heuristic and cache code in one place.

On a CUDA tensor the wrappers launch cuBLASLt through the shim or raise; on
a CPU tensor they run the plain versions.  There is no fallback between the
two.  There is no backward: the model takes the shim only without autograd
(`models.nn.takes_gemm_epilogue`).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from layoutdm_tpu_torch.ops.cuda_build import BuiltLibrary, load_library

# shim calls made by the wrappers (the CPU path adds nothing)
LAUNCHES_EPILOGUE = 0

RELU, RESIDUAL = 0, 1  # the shim's epilogue codes
WORKSPACE_BYTES = 32 * 1024 * 1024  # PyTorch's cuBLAS(Lt) workspace on Hopper
# the cuBLASLt entry points the shim calls, in its order (`gemm_epilogue_bind`)
CUBLASLT_ENTRIES = (
    "cublasLtCreate", "cublasLtMatmulDescCreate", "cublasLtMatmulDescSetAttribute",
    "cublasLtMatrixLayoutCreate", "cublasLtMatmulPreferenceCreate",
    "cublasLtMatmulPreferenceSetAttribute", "cublasLtMatmulPreferenceDestroy",
    "cublasLtMatmulAlgoGetHeuristic", "cublasLtMatmul",
)


def can_use_gemm_epilogue(in_features: int, out_features: int, dtype: torch.dtype) -> bool:
    """Widths and dtypes the shim takes: bfloat16 rows of whole 16-byte
    vectors (K and N multiples of 8)."""
    return (dtype == torch.bfloat16 and in_features > 0 and out_features > 0
            and in_features % 8 == 0 and out_features % 8 == 0)


def linear_relu_reference(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Plain version of `linear_relu`: the eager pair it replaces."""
    return F.relu(F.linear(x, weight, bias))


def linear_residual_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              residual: torch.Tensor) -> torch.Tensor:
    """Plain version of `linear_residual`: the float32 sum, rounded once to
    the residual's dtype."""
    out = F.linear(x.float(), weight.float(), bias.float()) + residual.float()
    return out.to(residual.dtype)


def loaded_cublaslt() -> list:
    """Paths of the libcublasLt files this process has mapped."""
    paths = set()
    with open("/proc/self/maps") as maps:
        for line in maps:
            parts = line.split(None, 5)
            if len(parts) == 6 and os.path.basename(parts[5].strip()).startswith("libcublasLt.so"):
                paths.add(parts[5].strip())
    return sorted(paths)


@functools.cache
def kernel_library() -> BuiltLibrary:
    """Build (first call) the shim, and bind it to the libcublasLt that torch
    has loaded, so that the process holds one copy."""
    built = load_library("gemm_epilogue", ["gemm_epilogue.cu"])
    paths = loaded_cublaslt()  # torch's CUDA build maps it at import
    if len(paths) != 1:
        raise RuntimeError(f"want one libcublasLt loaded by torch, found {paths}")
    cublaslt = ctypes.CDLL(paths[0], mode=os.RTLD_NOLOAD | os.RTLD_NOW)
    fns = (ctypes.c_void_p * len(CUBLASLT_ENTRIES))(
        *(ctypes.cast(getattr(cublaslt, name), ctypes.c_void_p).value for name in CUBLASLT_ENTRIES))
    fn = built.lib.gemm_epilogue_bind
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
    fn.restype = ctypes.c_int
    if fn(fns, len(CUBLASLT_ENTRIES)) != 0:
        raise RuntimeError("gemm_epilogue_bind: a cuBLASLt entry point is missing")
    fn = built.lib.gemm_epilogue_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, w, bias
        ctypes.c_void_p, ctypes.c_void_p,  # residual, out
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # M N K
        ctypes.c_int, ctypes.c_int,  # epilogue code, alignment
        ctypes.c_void_p, ctypes.c_ulonglong,  # workspace, its bytes
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return built


def linear_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x`` (..., K), ``weight`` (N, K), ``bias`` (N,), bfloat16 on the card.
    Returns relu(x Wᵀ + b), (..., N), from one GEMM."""
    return _gemm(x, weight, bias, None)


def linear_residual(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    residual: torch.Tensor) -> torch.Tensor:
    """As `linear_relu`, with ``residual`` (..., N): returns residual + x Wᵀ
    + b, rounded once, in a new tensor (``residual`` is read, not written)."""
    return _gemm(x, weight, bias, residual)


_WORKSPACES: dict = {}


def _workspace(device: int, stream: int) -> torch.Tensor:
    """The workspace of ``stream`` on ``device``, allocated at its first
    call and kept, as PyTorch keeps its cuBLAS workspaces."""
    ws = _WORKSPACES.get((device, stream))
    if ws is None:
        ws = _WORKSPACES[(device, stream)] = torch.empty(WORKSPACE_BYTES, dtype=torch.uint8,
                                                         device=f"cuda:{device}")
    return ws


def _gemm(x, weight, bias, residual):
    global LAUNCHES_EPILOGUE
    if x.dim() < 1 or weight.dim() != 2 or weight.shape[1] != x.shape[-1]:
        raise ValueError(f"x (..., K) against weight (N, K): {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}")
    N, K = weight.shape
    out_shape = x.shape[:-1] + (N,)
    if bias.shape != (N,):
        raise ValueError(f"bias must be ({N},), got {tuple(bias.shape)}")
    if residual is not None and residual.shape != out_shape:
        raise ValueError(f"residual must be {tuple(out_shape)}, got {tuple(residual.shape)}")
    if x.device.type == "cpu":
        if residual is None:
            return linear_relu_reference(x, weight, bias)
        return linear_residual_reference(x, weight, bias, residual)
    tensors = (x, weight, bias) if residual is None else (x, weight, bias, residual)
    device = x.get_device()  # -1 off the card
    if device < 0 or not all(t.get_device() == device and t.dtype == torch.bfloat16
                             and t.is_contiguous() for t in tensors):
        _reject(tensors)
    if not can_use_gemm_epilogue(K, N, x.dtype):
        raise ValueError(f"the GEMM epilogue takes K and N in multiples of 8, got K {K}, N {N}")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in (*tensors, out)]
    align = 256  # the largest power of two up to 256 dividing every address
    for p in ptrs:
        while p % align:
            align //= 2
    if align < 16:
        raise ValueError("x, weight, bias and residual must be 16-byte aligned")
    M = x.numel() // K
    if M == 0:
        return out
    fn = kernel_library().lib.gemm_epilogue_launch
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (*ptrs[:3], 0 if residual is None else ptrs[3], ptrs[-1], M, N, K,
            RELU if residual is None else RESIDUAL, align, _workspace(device, stream).data_ptr(),
            WORKSPACE_BYTES, stream)
    with torch.cuda.device(device):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"gemm_epilogue launch failed: status {err}")
    LAUNCHES_EPILOGUE += 1
    return out


def _reject(tensors) -> None:
    """Raise for what the shim does not take among ``tensors``."""
    device = tensors[0].get_device()
    if device < 0 or any(t.get_device() != device for t in tensors):
        raise ValueError(f"no GEMM epilogue for tensors on {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"the GEMM epilogue takes bfloat16, got {[t.dtype for t in tensors]}")
    raise ValueError("x, weight, bias and residual must be contiguous")
