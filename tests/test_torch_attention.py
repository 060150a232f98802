"""K1 (packed-qkv attention): the port's plain version held against the JAX
Pallas kernel run in interpret mode, as `tests/test_pallas_attention.py`
runs it, and the wrapper's routing.  The CUDA kernel itself is tested on
the card by `tests/test_torch_cuda.py`."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu.ops.attention import fused_attention_qkv as jax_fused_attention_qkv
from layoutdm_tpu_torch.ops import attention
from layoutdm_tpu_torch.ops.attention import (
    attention_qkv_reference,
    fused_attention_qkv,
)

F32_TOL = 1e-4
BF16_TOL = 2e-2
# bf16, elementwise atol + rtol |want|: the plain version and the TPU kernel
# round the normalised p and the output at the same points, so they differ
# by one output rounding step and by p's rounding flipped where their
# float32 exps differ in the last bits
BF16_RTOL, BF16_ATOL = 2 ** -7, 2 ** -8
SHARP = 3.0  # q and k scaled by this: one key takes most of a row's weight


def _slab(B, S, H, hd, seed=0):
    return np.random.RandomState(seed).randn(B, S, 3 * H * hd).astype(np.float32)


def _jax(qkv, H, scale=0.0, dtype=jnp.float32):
    return np.asarray(
        jax_fused_attention_qkv(
            jnp.asarray(qkv, dtype), num_heads=H, interpret=True, scale=scale
        ).astype(jnp.float32)
    )


@pytest.mark.parametrize(
    "B,S,H,hd", [(2, 25, 4, 16), (2, 125, 2, 58), (3, 17, 1, 8)]
)
def test_reference_matches_pallas_interpret_f32(B, S, H, hd):
    qkv = _slab(B, S, H, hd)
    got = attention_qkv_reference(torch.as_tensor(qkv), H)
    assert got.dtype == torch.float32 and got.shape == (B, S, H * hd)
    np.testing.assert_allclose(got.numpy(), _jax(qkv, H), atol=F32_TOL)


def test_reference_matches_pallas_interpret_bf16():
    B, S, H, hd = 2, 125, 2, 58
    qkv = _slab(B, S, H, hd, seed=1)
    x = torch.as_tensor(qkv).to(torch.bfloat16)
    got = attention_qkv_reference(x, H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), _jax(qkv, H, dtype=jnp.bfloat16), atol=BF16_TOL
    )


@pytest.mark.parametrize(
    "S,sharp", [(125, SHARP), (127, 1.0), (128, 1.0), (129, 1.0), (129, SHARP)]
)
def test_reference_matches_pallas_interpret_bf16_sharp_and_edges(S, sharp):
    """Sharp scores, where rounding p at another point than the TPU kernel
    shows, and the 128-key edge of the port's kernel."""
    B, H, hd = 2, 2, 58
    qkv = _slab(B, S, H, hd, seed=3)
    qkv[..., : 2 * H * hd] *= sharp
    got = attention_qkv_reference(torch.as_tensor(qkv).to(torch.bfloat16), H)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H * hd)
    np.testing.assert_allclose(
        got.float().numpy(), _jax(qkv, H, dtype=jnp.bfloat16), rtol=BF16_RTOL, atol=BF16_ATOL
    )


def test_reference_padded_head_slab_with_true_scale():
    """A head slab zero-padded from 58 to 64 lanes with scale 1/sqrt(58)
    equals the unpadded attention (the JAX package's weight-padded path)."""
    B, S, H, hd, hp = 2, 25, 2, 58, 64
    qkv = _slab(B, S, H, hd, seed=2).reshape(B, S, 3, H, hd)
    padded = np.zeros((B, S, 3, H, hp), np.float32)
    padded[..., :hd] = qkv
    padded = padded.reshape(B, S, 3 * H * hp)
    scale = 1.0 / math.sqrt(hd)
    got = attention_qkv_reference(torch.as_tensor(padded), H, scale=scale)
    np.testing.assert_allclose(got.numpy(), _jax(padded, H, scale=scale), atol=F32_TOL)
    unpadded = attention_qkv_reference(torch.as_tensor(qkv.reshape(B, S, -1)), H)
    np.testing.assert_allclose(
        got.numpy().reshape(B, S, H, hp)[..., :hd],
        unpadded.numpy().reshape(B, S, H, hd), atol=F32_TOL,
    )
    assert not got.numpy().reshape(B, S, H, hp)[..., hd:].any()


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    qkv = torch.as_tensor(_slab(2, 9, 2, 8))
    before = attention.LAUNCHES
    out = fused_attention_qkv(qkv, 2)
    assert attention.LAUNCHES == before
    torch.testing.assert_close(out, attention_qkv_reference(qkv, 2), rtol=0, atol=0)


@pytest.mark.parametrize("S,dtype", [(129, torch.bfloat16), (500, torch.bfloat16),
                                     (513, torch.bfloat16), (500, torch.float32)])
def test_long_body_counter_on_cpu(S, dtype):
    """``LAUNCHES_LONG`` (K1 and K6 calls that took the long bf16 body, on
    either side of its 512-key limit) is a plain integer that the CPU path
    never moves; there both wrappers are their plain versions, and the plain
    version still rounds at the kernel's points: float32 scores and softmax,
    the normalised p rounded once to the io dtype, float32 p.v, one
    rounding of the output."""
    assert isinstance(attention.LAUNCHES_LONG, int)
    B, H, hd = 1, 2, 8
    rs = np.random.RandomState(S)
    qkv = torch.as_tensor(rs.randn(B, S, 3 * H * hd).astype(np.float32)).to(dtype)
    bias = torch.as_tensor(0.5 * rs.randn(3 * H * hd).astype(np.float32)).to(dtype)
    counters = lambda: (attention.LAUNCHES, attention.LAUNCHES_SMAJOR, attention.LAUNCHES_LONG)
    before = counters()
    out = fused_attention_qkv(qkv, H)
    out_sb = attention.fused_attention_qkv_smajor(qkv.transpose(0, 1).contiguous(), bias, H)
    assert counters() == before
    q, k, v = (x.reshape(B, S, H, hd).float() for x in qkv.split(H * hd, dim=-1))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5, dim=-1).to(dtype)
    want = torch.einsum("bhqk,bkhd->bqhd", p.float(), v).reshape(B, S, H * hd).to(dtype)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(out_sb, attention.attention_qkv_smajor_reference(
        qkv.transpose(0, 1).contiguous(), bias, H), rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        fused_attention_qkv(torch.zeros(2, 3, 10), 2)  # 3D not divisible by 3
    with pytest.raises(ValueError):
        fused_attention_qkv(torch.zeros(2, 3, 15), 2)  # D=5 not divisible by H
    with pytest.raises(ValueError, match="no attention kernel"):
        fused_attention_qkv(torch.zeros(2, 3, 24, device="meta"), 2)
