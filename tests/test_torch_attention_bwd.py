"""K2 (packed-qkv attention backward): the port's plain version held against
the JAX Pallas kernel in interpret mode, and the autograd binding (K1
forward, K2 backward, the slab as the residual) against ``jax.grad`` of the
einsum attention.  The CUDA kernel itself is tested on the card by
`tests/test_torch_cuda.py`."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu.ops.attention import (
    fused_attention_qkv_bwd as jax_fused_attention_qkv_bwd,
)
from layoutdm_tpu_torch.ops import attention
from layoutdm_tpu_torch.ops.attention import (
    attention_qkv_bwd_reference,
    fused_attention_qkv_bwd,
    fused_attention_qkv_diff,
)

# relative to the largest gradient: float32 differs by summation order;
# bfloat16 by a last-bit flip of p or ds before their bf16 rounding and by
# the output's bf16 rounding (2**-8)
F32_TOL = 1e-5
BF16_TOL = 1e-2


def _inputs(B, S, H, hd, seed=0):
    rs = np.random.RandomState(seed)
    qkv = rs.randn(B, S, 3 * H * hd).astype(np.float32)
    do = rs.randn(B, S, H * hd).astype(np.float32)
    return qkv, do


def _jax_bwd(qkv, do, H, scale=0.0, dtype=jnp.float32):
    return np.asarray(
        jax_fused_attention_qkv_bwd(
            jnp.asarray(qkv, dtype), jnp.asarray(do, dtype), H,
            interpret=True, scale=scale,
        ).astype(jnp.float32)
    )


def _jax_attention(qkv, H, scale=0.0):
    """The JAX package's einsum attention on the packed slab."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    hd = D // H
    scale = scale or 1.0 / math.sqrt(hd)
    q, k, v = (x.reshape(B, S, H, hd) for x in jnp.split(qkv, 3, axis=-1))
    p = jax.nn.softmax(jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, D)


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("B,S,H,hd", [
    (2, 25, 2, 58), (2, 13, 4, 16), (1, 40, 1, 8),
    # the CUDA kernel's tile edges: one key, one 16-key step, one past a
    # 64-row tile, one past the 128-key chunk (pass A's second sweep)
    (2, 1, 2, 58), (1, 16, 2, 58), (1, 65, 2, 58), (1, 129, 2, 58),
])
def test_reference_matches_pallas_interpret_f32(B, S, H, hd):
    qkv, do = _inputs(B, S, H, hd)
    got = attention_qkv_bwd_reference(torch.as_tensor(qkv), torch.as_tensor(do), H)
    assert got.dtype == torch.float32 and got.shape == (B, S, 3 * H * hd)
    assert _rel_err(got.numpy(), _jax_bwd(qkv, do, H)) <= F32_TOL


def _check_bf16(B, S, H, hd):
    qkv, do = _inputs(B, S, H, hd, seed=1)
    got = attention_qkv_bwd_reference(
        torch.as_tensor(qkv).bfloat16(), torch.as_tensor(do).bfloat16(), H
    )
    assert got.dtype == torch.bfloat16
    want = _jax_bwd(qkv, do, H, dtype=jnp.bfloat16)
    assert _rel_err(got.float().numpy(), want) <= BF16_TOL


def test_reference_matches_pallas_interpret_bf16():
    _check_bf16(2, 25, 2, 58)


@pytest.mark.parametrize("S", [1, 16, 65, 129])
def test_reference_matches_pallas_interpret_bf16_at_kernel_tile_edges(S):
    """bf16 at the CUDA kernel's tile edges (one key, one 16-key step, past
    a 64-row tile, past the 128-key chunk)."""
    _check_bf16(1, S, 2, 58)


def test_reference_scale_override_on_padded_head_slab():
    """A slab zero-padded from 58 to 64 lanes per head with the true head
    size's scale: the kernel's gradient on the pad lanes is exactly zero
    and the rest equals the unpadded gradient."""
    B, S, H, hd, hp = 2, 25, 2, 58, 64
    qkv, do = _inputs(B, S, H, hd, seed=2)
    pq = np.zeros((B, S, 3, H, hp), np.float32)
    pq[..., :hd] = qkv.reshape(B, S, 3, H, hd)
    pdo = np.zeros((B, S, H, hp), np.float32)
    pdo[..., :hd] = do.reshape(B, S, H, hd)
    pq, pdo = pq.reshape(B, S, -1), pdo.reshape(B, S, -1)
    scale = 1.0 / math.sqrt(hd)
    got = attention_qkv_bwd_reference(torch.as_tensor(pq), torch.as_tensor(pdo), H, scale)
    assert _rel_err(got.numpy(), _jax_bwd(pq, pdo, H, scale=scale)) <= F32_TOL
    got = got.numpy().reshape(B, S, 3, H, hp)
    assert not got[..., hd:].any()
    unpadded = attention_qkv_bwd_reference(torch.as_tensor(qkv), torch.as_tensor(do), H)
    np.testing.assert_allclose(
        got[..., :hd], unpadded.numpy().reshape(B, S, 3, H, hd), atol=1e-5
    )


@pytest.mark.parametrize("scale,hp", [(0.0, 58), (1.0 / math.sqrt(58), 64)])
def test_autograd_function_matches_jax_grad(scale, hp):
    """Through a downstream projection, the gradient of the autograd
    Function equals jax.grad of the einsum attention (float32)."""
    B, S, H, hd = 2, 25, 2, 58
    rs = np.random.RandomState(3)
    lane = np.zeros((3, H, hp), bool)
    lane[..., :hd] = True
    # the out projection reads no pad lane, as with zero-scattered weights
    w = (rs.randn(H * hp, H * hp) * 0.1).astype(np.float32) * lane[0].reshape(-1, 1)
    lane = lane.reshape(-1)
    qkv = rs.randn(B, S, 3 * H * hp).astype(np.float32) * lane

    def jax_loss(x):
        return jnp.sum((_jax_attention(x, H, scale) @ w) ** 2)

    want_loss, want = jax.value_and_grad(jax_loss)(jnp.asarray(qkv))
    x = torch.as_tensor(qkv).requires_grad_()
    loss = ((fused_attention_qkv_diff(x, H, scale) @ torch.as_tensor(w)) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert _rel_err(x.grad.numpy(), np.asarray(want)) <= F32_TOL
    assert not x.grad.numpy()[:, :, ~lane].any()


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    qkv, do = (torch.as_tensor(a) for a in _inputs(2, 9, 2, 8))
    before = attention.LAUNCHES, attention.LAUNCHES_BWD
    got = fused_attention_qkv_bwd(qkv, do, 2)
    x = qkv.clone().requires_grad_()
    fused_attention_qkv_diff(x, 2).backward(do)
    assert (attention.LAUNCHES, attention.LAUNCHES_BWD) == before
    want = attention_qkv_bwd_reference(qkv, do, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    qkv = torch.zeros(2, 3, 24)
    with pytest.raises(ValueError):
        fused_attention_qkv_bwd(qkv, torch.zeros(2, 3, 4), 2)  # do not (B, S, D)
    with pytest.raises(ValueError, match="no attention kernel"):
        fused_attention_qkv_bwd(
            torch.zeros(2, 3, 24, device="meta"), torch.zeros(2, 3, 8, device="meta"), 2
        )
