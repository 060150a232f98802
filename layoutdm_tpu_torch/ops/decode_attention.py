"""Single-query attention over cached keys and values, the decoders' cached
decode, in one CUDA kernel (``csrc/decode_attention.cu``), and its plain
version.

One query a row, q (B, 1, H, hd), against the first ``n`` positions of
keys and values laid out (B, L, H, hd), each position's H·hd values
contiguous and any row and position strides: the self-attention caches of
`models.nn.KVCache`, or the cross keys and values as views of the packed
(B, M, 2, H, hd) projection of the encoder memory, read in place.  A
self-attention call also hands this step's k and v (``new``), written at
position ``n - 1`` before it is attended.  Returns (B, 1, H·hd) in the
compute dtype.

Rounding points are the eager arithmetic's (`decode_attention_reference`,
the code `SelfAttention.decode_step` and `CrossAttention` ran before): the
scores accumulated in float32 and rounded to the compute dtype, divided by
√hd and rounded again; the softmax in float32, its probabilities rounded to
the compute dtype; p·v accumulated in float32 and rounded once.  On the
card the eager division by a Python scalar is a multiplication by its
float32 reciprocal, and the kernel multiplies by that same number.

Replaces no TPU kernel: the JAX ``SelfAttention._decode_step``
(``layoutdm_tpu/models/nn.py:185-213``) and ``CrossAttention``
(``:838-896``) were left to XLA.  Eagerly each call was two ``einsum``s
that copied every cache slice into ``bmm``'s layout before each product
(the (b, h) batch of a (B, L, H, hd) cache has no single stride), so each
cache byte was read about three times and written once.  The kernel is
bound by the cache bytes, and reads each once: a block a row streams whole
16-byte-aligned position rows of keys, then of values, through a ring of
cp.async stages in shared memory, keeps the row's H × n scores on chip so
the softmax normalises and rounds them before the value pass, and writes
only the output (and, for self-attention, the new position's cache rows).

On a CUDA tensor `decode_attention` launches the kernel or raises; on a
CPU tensor it runs `decode_attention_reference`.  There is no fallback
between the two.  It checks its operands' layout on every call
(`check_decode_operands`); `launch_decode_attention` launches without, for
a caller that checks them once (`models.nn.KVCache`, whose caches every
step of a decode reads).  The kernel has no backward: the modules take it
only without autograd.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from layoutdm_tpu_torch.ops.cuda_build import BuiltLibrary, load_library

# kernel launches made by the wrapper (the CPU path adds nothing)
LAUNCHES_DECODE_ATTN = 0

# the kernel's limits, kMaxHeads, kMaxD and kMaxLen in csrc/decode_attention.cu
MAX_HEADS = 16
MAX_D_MODEL = 1024  # four output values a thread of 256
MAX_LEN = 1024  # the scores of a row stay in shared memory
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def can_use_decode_attention(H: int, hd: int, L: int, dtype: torch.dtype) -> bool:
    """Shapes and dtypes the kernel takes: float32 or bfloat16, an even
    head width, at most MAX_HEADS heads, rows of H·hd values in whole
    16-byte vectors and at most MAX_D_MODEL wide, caches of 1 to MAX_LEN
    positions."""
    if dtype not in _DTYPE_CODE:
        return False
    D = H * hd
    return (0 < H <= MAX_HEADS and hd > 0 and hd % 2 == 0 and D <= MAX_D_MODEL
            and D * dtype.itemsize % 16 == 0 and 0 < L <= MAX_LEN)


def decode_attention_reference(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                               n: int, new: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                               ) -> torch.Tensor:
    """Plain version: the eager arithmetic.  ``q`` (B, S, H, hd) (one query
    a row in the cached decode); ``new``: this step's (k, v), each (B, 1, H,
    hd), written into ``keys`` and ``values`` at ``n - 1`` first."""
    B, S, H, hd = q.shape
    if new is not None:
        keys[:, n - 1] = new[0][:, 0]
        values[:, n - 1] = new[1][:, 0]
    keys, values = keys[:, :n], values[:, :n]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, keys) / math.sqrt(hd)
    attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, values).reshape(B, S, H * hd)


@functools.cache
def _scale(hd: int) -> float:
    """The eager division's float32 reciprocal of √hd (the module's note)."""
    return float(np.float32(1.0) / np.float32(math.sqrt(hd)))


@functools.cache
def kernel_library() -> BuiltLibrary:
    """Build (first call) and bind the kernel."""
    built = load_library("decode_attention", ["decode_attention.cu"])
    fn = built.lib.decode_attention_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,  # q, its row stride
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # keys, row and position strides
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # values, likewise
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # new k, new v, their row stride
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H hd n
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return built


def _check_rows(name: str, t: torch.Tensor, q: torch.Tensor, length: int) -> None:
    """``t`` is (B, length, H, hd) as q's (B, ·, H, hd), of q's dtype and
    device, each position's H·hd values contiguous and 16-byte aligned."""
    shape, stride = t.shape, t.stride()
    B, _, H, hd = q.shape
    if shape != (B, length, H, hd) or t.dtype != q.dtype or t.device != q.device:
        raise ValueError(f"{name} must be {(B, length, H, hd)} {q.dtype} on {q.device}, got "
                         f"{tuple(shape)} {t.dtype} on {t.device}")
    vec = 16 // q.dtype.itemsize
    if (stride[3] != 1 or stride[2] != hd or t.data_ptr() % 16 or stride[0] % vec
            or (length > 1 and stride[1] % vec)):
        raise ValueError(f"{name}'s positions must hold H·hd contiguous values, 16-byte "
                         f"aligned, got strides {stride}")


def check_decode_operands(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                          new: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
    """Raise ValueError unless the kernel takes these operands (the
    arguments of `decode_attention`): q (B, 1, H, hd) on a CUDA device at a
    shape and dtype the gate admits, each row's H·hd values contiguous;
    keys, values and ``new``'s k and v (B, ·, H, hd) of q's dtype and
    device, each position's H·hd values contiguous and 16-byte aligned, the
    new rows at one row stride."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention kernel for q on {q.device}")
    B, _, H, hd = q.shape
    L = keys.shape[1] if keys.dim() == 4 else 0
    if not can_use_decode_attention(H, hd, L, q.dtype):
        raise ValueError(f"kernel takes float32 or bfloat16, even head widths, at most "
                         f"{MAX_HEADS} heads, H·hd <= {MAX_D_MODEL} in whole 16-byte rows and "
                         f"1 to {MAX_LEN} positions, got H {H}, hd {hd}, L {L} in {q.dtype}")
    q_stride = q.stride()
    if q_stride[3] != 1 or q_stride[2] != hd:
        raise ValueError(f"q's heads must be contiguous within a row, strides {q_stride}")
    _check_rows("keys", keys, q, L)
    _check_rows("values", values, q, L)
    if new is not None:
        _check_rows("new k", new[0], q, 1)
        _check_rows("new v", new[1], q, 1)
        if new[0].stride(0) != new[1].stride(0):
            raise ValueError("new k and v must share one row stride")


@functools.cache
def _launch_fn():
    return kernel_library().lib.decode_attention_launch


def launch_decode_attention(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor, n: int,
                            new: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                            ) -> torch.Tensor:
    """The kernel on operands laid out as `check_decode_operands` admits,
    which this does not check again (a caller that checks them once, as
    `models.nn.KVCache` does, calls it on every step); positions 0 ..
    ``n`` - 1 attended.  Returns (B, 1, H·hd) in q's dtype."""
    global LAUNCHES_DECODE_ATTN
    B, _, H, hd = q.shape
    if not 0 < n <= keys.shape[1]:
        raise ValueError(f"n must lie in 1 .. {keys.shape[1]} positions, got {n}")
    dev = q.get_device()
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch_decode_attention(q, keys, values, n, new)
    out = torch.empty((B, 1, H * hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    k_new, v_new = new if new is not None else (None, None)
    err = _launch_fn()(q.data_ptr(), q.stride(0), keys.data_ptr(), *keys.stride()[:2],
                       values.data_ptr(), *values.stride()[:2],
                       None if k_new is None else k_new.data_ptr(),
                       None if v_new is None else v_new.data_ptr(),
                       0 if k_new is None else k_new.stride(0), out.data_ptr(), B, H, hd, n,
                       _scale(hd), _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    LAUNCHES_DECODE_ATTN += 1
    return out


def decode_attention(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor, n: int,
                     new: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``q`` (B, 1, H, hd) in float32 or bfloat16, each row's H·hd values
    contiguous; ``keys``, ``values`` (B, L, H, hd) of q's dtype, positions
    0 .. ``n`` - 1 attended; ``new``: this step's (k, v), each (B, 1, H,
    hd), written at position ``n`` - 1 (self-attention).  Returns (B, 1,
    H·hd) in q's dtype: the plain version on a CPU tensor, else the kernel
    on operands `check_decode_operands` admits."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    L = keys.shape[1] if keys.dim() == 4 else 0
    if not 0 < n <= L:
        raise ValueError(f"n must lie in 1 .. {L} positions, got {n}")
    if q.device.type == "cpu":
        return decode_attention_reference(q, keys, values, n, new)
    check_decode_operands(q, keys, values, new)
    return launch_decode_attention(q, keys, values, n, new)
