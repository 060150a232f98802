"""Padded-head attention: the CUDA kernel K5, its plain version and the
weight scatter that feeds it (port of
``layoutdm_tpu/ops/attention_blockdiag.py``).

The JAX package's block-diagonal path zero-pads every head from hd to
hp = 64 lanes at the weight level: the qkv projection's weight rows and
bias are scattered into a (3·H·hp)-wide layout, so the projection GEMM
itself emits padded heads, and the out projection's columns are scattered
so that its zero columns drop the kernel's padded output lanes.  Zero
weights give zero q/k/v lanes, zero score terms and zero output lanes: the
function is the plain attention's, exactly.

``blockdiag_attention`` takes that (B, S, 3·H·hp) slab and returns the
(B, S, H·hp) attention output in the padded layout, scale = 1/sqrt(true
hd).  On the TPU it ran as two GEMMs per row against block-diagonal kᵀ and
v, a layout for the MXU; on a CUDA tensor it launches the hand-written
Hopper kernel (``csrc/attention_blockdiag.cu``), which computes the
per-head attention directly, or raises; on a CPU tensor it runs the plain
version.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from layoutdm_tpu_torch.ops.attention import _DTYPE_CODE, attention_qkv_reference
from layoutdm_tpu_torch.ops.cuda_build import BuiltLibrary, load_library

# kernel launches made by the wrapper (the CPU path adds nothing)
LAUNCHES_BLOCKDIAG = 0

HEAD_PADS = (64, 128)  # the padded head widths the kernel takes
MAX_SEQ = 1024  # in float32 a block keeps a (32, S) score tile in shared memory


def padded_head_dim(head_dim: int) -> int:
    """The head width padded up to a multiple of 64 lanes."""
    return -(-head_dim // 64) * 64


def can_use_blockdiag(head_dim: int, seq_len: int) -> bool:
    """Shapes the kernel takes (the JAX gate's VMEM model has no
    counterpart here)."""
    return padded_head_dim(head_dim) in HEAD_PADS and seq_len <= MAX_SEQ


def scatter_qkv_weights(w: torch.Tensor, b: torch.Tensor, H: int, hd: int, hp: int):
    """(3·H·hd, D) qkv weight and (3·H·hd,) bias in the ``nn.Linear``
    layout -> (3·H·hp, D) and (3·H·hp,), each head's rows zero-padded from
    hd to hp.  Exact: the new rows are zero."""
    D = w.shape[1]
    wp = w.new_zeros((3, H, hp, D))
    wp[:, :, :hd] = w.reshape(3, H, hd, D)
    bp = b.new_zeros((3, H, hp))
    bp[..., :hd] = b.reshape(3, H, hd)
    return wp.reshape(3 * H * hp, D), bp.reshape(3 * H * hp)


def scatter_out_weights(w: torch.Tensor, H: int, hd: int, hp: int) -> torch.Tensor:
    """(D, H·hd) out-projection weight -> (D, H·hp) with zero columns under
    each head's padded lanes (they drop the kernel's padded output lanes)."""
    D = w.shape[0]
    wp = w.new_zeros((D, H, hp))
    wp[..., :hd] = w.reshape(D, H, hd)
    return wp.reshape(D, H * hp)


def _check_slab(qkv_pad: torch.Tensor, num_heads: int, head_pad: int):
    if qkv_pad.dim() != 3 or qkv_pad.shape[-1] != 3 * num_heads * head_pad:
        raise ValueError(
            f"qkv_pad must be (B, S, 3·{num_heads}·{head_pad}), got {tuple(qkv_pad.shape)}"
        )
    return qkv_pad.shape[0], qkv_pad.shape[1]


def blockdiag_attention_reference(
    qkv_pad: torch.Tensor, num_heads: int, head_pad: int, scale: float
) -> torch.Tensor:
    """Plain version, with the TPU kernel's rounding points: float32
    scores from io-dtype operands times ``scale``, a float32 softmax over
    the S real keys, the normalised p rounded to the io dtype, p·v
    accumulated in float32, the output (padded lanes included) rounded
    once.  That is the packed-qkv plain version at head width hp."""
    _check_slab(qkv_pad, num_heads, head_pad)
    return attention_qkv_reference(qkv_pad, num_heads, scale)


@functools.cache
def kernel_library() -> BuiltLibrary:
    """Build (first call) and bind K5."""
    built = load_library("attention_blockdiag", ["attention_blockdiag.cu"])
    fn = built.lib.attention_blockdiag_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # qkv_pad, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B S H hp
        ctypes.c_float, ctypes.c_int,  # scale, dtype code
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return built


def blockdiag_attention(
    qkv_pad: torch.Tensor, num_heads: int, head_pad: int, scale: float
) -> torch.Tensor:
    """Attention on the padded-head slab ``qkv_pad`` (B, S, 3·H·hp), float32
    or bfloat16; returns (B, S, H·hp).  ``scale`` is 1/sqrt(true head dim):
    hp is padded, so there is no default."""
    global LAUNCHES_BLOCKDIAG
    B, S = _check_slab(qkv_pad, num_heads, head_pad)
    if qkv_pad.device.type == "cpu":
        return blockdiag_attention_reference(qkv_pad, num_heads, head_pad, scale)
    if qkv_pad.device.type != "cuda":
        raise ValueError(f"no block-diagonal attention kernel for device {qkv_pad.device}")
    if qkv_pad.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {qkv_pad.dtype}")
    if head_pad not in HEAD_PADS or S > MAX_SEQ:
        raise ValueError(
            f"head pad {head_pad} / sequence {S}: the kernel takes hp in {HEAD_PADS}, "
            f"S <= {MAX_SEQ}"
        )
    if not qkv_pad.is_contiguous() or qkv_pad.data_ptr() % 16:
        raise ValueError("qkv_pad must be contiguous and 16-byte aligned")
    out = torch.empty((B, S, num_heads * head_pad), dtype=qkv_pad.dtype,
                      device=qkv_pad.device)
    fn = kernel_library().lib.attention_blockdiag_launch
    with torch.cuda.device(qkv_pad.device):
        stream = torch.cuda.current_stream(qkv_pad.device).cuda_stream
        err = fn(qkv_pad.data_ptr(), out.data_ptr(), B, S, num_heads, head_pad,
                 float(scale), _DTYPE_CODE[qkv_pad.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attention_blockdiag kernel launch failed: CUDA error {err}")
    LAUNCHES_BLOCKDIAG += 1
    return out
