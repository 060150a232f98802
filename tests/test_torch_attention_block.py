"""K4, the whole attention block: the port's function (on CPU tensors, its
plain version, on native-width weights) against the JAX package's Pallas
kernel in interpret mode (on the weights scattered to 64-lane heads, as
its own tests build them), and against the same formula in float64."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu.ops.attention import fused_attention_block as jax_block
from layoutdm_tpu.ops.attention import head_pad_target
from layoutdm_tpu.ops.attention_blockdiag import scatter_out_weights, scatter_qkv_weights
from layoutdm_tpu_torch.ops import attention as tatt

H, HD = 4, 58
D = H * HD
# float32: interpret mode rounds the attention dots' float32 operands to
# bf16 (the MXU's DEFAULT precision), as JAX's own test of this kernel allows
F32_TOL = 6e-3
# bfloat16: both sides round qkv, p, o and the output at the same points
# from float32 sums taken in another order; |out| < 2 here
BF16_TOL = 2e-2


SHARP = 3.0  # W_q and W_k scaled by this: one key takes most of a row's weight


def _inputs(seed, B, S, sharp=1.0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, S, D) * 0.5).astype(np.float32)
    wq = (rs.randn(D, 3 * D) * 0.05).astype(np.float32)  # flax (in, out)
    wq[:, : 2 * D] *= sharp
    bq = (rs.randn(3 * D) * 0.05).astype(np.float32)
    wo = (rs.randn(D, D) * 0.05).astype(np.float32)
    bo = (rs.randn(D) * 0.05).astype(np.float32)
    return x, wq, bq, wo, bo


def _port(x, wq, bq, wo, bo, dtype=torch.float32):
    return tatt.fused_attention_block(
        torch.as_tensor(x).to(dtype), torch.as_tensor(wq.T.copy()), torch.as_tensor(bq),
        torch.as_tensor(wo.T.copy()), torch.as_tensor(bo), H,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,sharp",
    [pytest.param(2, 1, 1.0, id="2-1"), pytest.param(2, 33, 1.0, id="2-33"),
     pytest.param(2, 9, 1.0, id="2-9"), pytest.param(1, 25, 1.0, id="1-25"),
     pytest.param(1, 125, SHARP, id="1-125-sharp"), pytest.param(1, 127, 1.0, id="1-127"),
     pytest.param(1, 128, 1.0, id="1-128"), pytest.param(1, 129, 1.0, id="1-129"),
     pytest.param(1, 129, SHARP, id="1-129-sharp")],
)
def test_block_matches_jax_kernel(dtype, B, S, sharp):
    """Also on sharp scores, at S = 1 and 33, and on both sides of the 128
    keys up to which the port's kernel runs one block a head."""
    x, wq, bq, wo, bo = _inputs(0, B, S, sharp)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    hp = head_pad_target(HD)
    # the JAX Block casts the weights to the compute dtype, then scatters
    wp, bp = scatter_qkv_weights(jnp.asarray(wq, jdt), jnp.asarray(bq, jdt), H, HD, hp)
    wop = scatter_out_weights(jnp.asarray(wo, jdt), H, HD, hp)
    want = jax_block(
        jnp.asarray(x, jdt), wp, bp, wop, jnp.asarray(bo, jdt),
        num_heads=H, head_pad=hp, scale=1.0 / math.sqrt(HD), residual=True,
        interpret=True,
    )
    want = np.asarray(want.astype(jnp.float32))
    got = _port(x, wq, bq, wo, bo, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_plain_version_matches_float64_formula():
    x, wq, bq, wo, bo = _inputs(1, 2, 25)
    m = x.astype(np.float64)
    qkv = m @ wq + bq
    q, k, v = (a.reshape(2, 25, H, HD) for a in np.split(qkv, 3, axis=-1))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(HD)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("bhqk,bkhd->bqhd", p, v).reshape(2, 25, D)
    want = m + o @ wo + bo
    np.testing.assert_allclose(_port(x, wq, bq, wo, bo).numpy(), want, rtol=0, atol=1e-4)


def test_residual_is_added_before_the_one_rounding():
    """In bfloat16 the block's output is round(proj + bo + x), not the
    unfused path's round(x + round(proj + bo))."""
    x, wq, bq, wo, bo = _inputs(2, 2, 9)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    w_qkv, w_out = torch.as_tensor(wq.T.copy()), torch.as_tensor(wo.T.copy())
    got = tatt.attention_block_reference(xb, w_qkv, torch.as_tensor(bq), w_out,
                                         torch.as_tensor(bo), H)
    qkv = (xb.float() @ w_qkv.bfloat16().float().T + torch.as_tensor(bq).bfloat16().float())
    o = tatt.attention_qkv_reference(qkv.bfloat16(), H).float()
    proj = o @ w_out.bfloat16().float().T + torch.as_tensor(bo).bfloat16().float()
    torch.testing.assert_close(got, (proj + xb.float()).bfloat16(), rtol=0, atol=0)
    assert not torch.equal(got, xb + proj.bfloat16())


def test_wrapper_checks_shapes_and_device():
    x, wq, bq, wo, bo = _inputs(3, 1, 5)
    args = (torch.as_tensor(wq.T.copy()), torch.as_tensor(bq),
            torch.as_tensor(wo.T.copy()), torch.as_tensor(bo))
    with pytest.raises(ValueError, match="do not match"):
        tatt.fused_attention_block(torch.as_tensor(x), torch.as_tensor(wq), *args[1:], H)
    with pytest.raises(ValueError, match="not divisible"):
        tatt.fused_attention_block(torch.as_tensor(x), *args, 5)
    with pytest.raises(ValueError, match="no attention-block kernel"):
        tatt.fused_attention_block(torch.as_tensor(x).to("meta"), *args, H)
    before = tatt.LAUNCHES_BLOCK
    tatt.fused_attention_block(torch.as_tensor(x), *args, H)
    assert tatt.LAUNCHES_BLOCK == before


def test_gate_mirrors_the_kernel_limits():
    assert tatt.can_use_fused_block(58, 464)
    assert not tatt.can_use_fused_block(tatt.MAX_BLOCK_HEAD_DIM + 1, 464)
    assert not tatt.can_use_fused_block(58, tatt.MAX_BLOCK_D_MODEL + 8)
