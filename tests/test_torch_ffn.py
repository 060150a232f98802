"""K3, the fused LayerNorm-FFN-residual: the port's function (on CPU
tensors, its plain version) against the JAX package's Pallas kernel in
interpret mode, on the same inputs made with numpy; and the wrapper's
checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu.ops.ffn import fused_ln_ffn_residual as jax_ffn
from layoutdm_tpu_torch.ops import ffn as tffn

D, F = 116, 232  # the flagship's head-58 width at two heads, FFN 2x
# float32: JAX's own tolerance for this kernel (tests/test_pallas_ffn.py)
F32_TOL = 2e-4
# bfloat16: the two sides round the hidden and the output at the same
# points from float32 sums taken in another order; x at half scale keeps
# |out| < 2, where one bf16 step is 2**-7
BF16_TOL = 2e-2


def _inputs(seed, lead):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*lead, D) * 0.5).astype(np.float32)
    p = {
        "ln_scale": (1 + 0.1 * rs.randn(D)).astype(np.float32),
        "ln_bias": (0.1 * rs.randn(D)).astype(np.float32),
        "w1": (rs.randn(D, F) / np.sqrt(D)).astype(np.float32),
        "b1": (0.1 * rs.randn(F)).astype(np.float32),
        "w2": (rs.randn(F, D) / np.sqrt(F)).astype(np.float32),
        "b2": (0.1 * rs.randn(D)).astype(np.float32),
    }
    return x, p


def _port_params(p):
    """The JAX kernels' (D, F) / (F, D) weights in the nn.Linear layout."""
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    t["w1"], t["w2"] = t["w1"].T.contiguous(), t["w2"].T.contiguous()
    return t


@pytest.mark.parametrize("lead", [(2, 25), (21,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["relu", "gelu", "gelu2"])
def test_ffn_matches_jax_kernel(activation, dtype, lead):
    x, p = _inputs(0, lead)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax_ffn(
        jnp.asarray(x, jdt), *(jnp.asarray(p[k]) for k in p),
        activation=activation, interpret=True,
    )
    want = np.asarray(want.astype(jnp.float32))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = tffn.fused_ln_ffn_residual(tx, **_port_params(p), activation=activation)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


# the flagship's widths (8 heads of 58, FFN 4x), for the row counts on both
# sides of the Hopper kernel's 64-row tile
FLAG_D, FLAG_F = 464, 1856


@pytest.mark.parametrize("rows", [63, 65, 129])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_matches_jax_kernel_at_flagship_width(dtype, rows):
    """float32 within JAX's own tolerance; bfloat16 within 2**-7 of the
    largest output (|out| < 4 here): two rounding steps of it, from the
    hidden and the output rounded after float32 sums taken in another
    order, as tests/test_torch_cuda.py holds the kernel to this plain
    version on the card."""
    rs = np.random.RandomState(rows)
    x = (rs.randn(rows, FLAG_D) * 0.5).astype(np.float32)
    p = {
        "ln_scale": (1 + 0.1 * rs.randn(FLAG_D)).astype(np.float32),
        "ln_bias": (0.1 * rs.randn(FLAG_D)).astype(np.float32),
        "w1": (rs.randn(FLAG_D, FLAG_F) / np.sqrt(FLAG_D)).astype(np.float32),
        "b1": (0.1 * rs.randn(FLAG_F)).astype(np.float32),
        "w2": (rs.randn(FLAG_F, FLAG_D) / np.sqrt(FLAG_F)).astype(np.float32),
        "b2": (0.1 * rs.randn(FLAG_D)).astype(np.float32),
    }
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax_ffn(jnp.asarray(x, jdt), *(jnp.asarray(p[k]) for k in p),
                   activation="relu", interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = tffn.fused_ln_ffn_residual(torch.as_tensor(x).to(getattr(torch, dtype)),
                                     **_port_params(p), activation="relu")
    tol = F32_TOL if dtype == "float32" else 2 ** -7 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_plain_version_matches_float64_formula():
    """The plain version in float32 against the same formula in float64."""
    x, p = _inputs(1, (3, 25))
    m = x.astype(np.float64)
    ln = (m - m.mean(-1, keepdims=True)) / np.sqrt(m.var(-1, keepdims=True) + 1e-6)
    h = (ln * p["ln_scale"] + p["ln_bias"]) @ p["w1"] + p["b1"]
    h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi) * (h + 0.044715 * h ** 3)))
    want = m + h @ p["w2"] + p["b2"]
    got = tffn.fused_ln_ffn_residual(torch.as_tensor(x), **_port_params(p), activation="gelu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_wrapper_checks_shapes_and_device():
    x, p = _inputs(2, (4,))
    tp = _port_params(p)
    with pytest.raises(ValueError, match="unknown activation"):
        tffn.fused_ln_ffn_residual(torch.as_tensor(x), **tp, activation="silu")
    bad = dict(tp, w1=tp["w1"].T)  # the JAX (D, F) layout
    with pytest.raises(ValueError, match="w1 must be"):
        tffn.fused_ln_ffn_residual(torch.as_tensor(x), **bad, activation="relu")
    # a device with neither a kernel nor the plain version's CPU
    with pytest.raises(ValueError, match="no FFN kernel"):
        tffn.fused_ln_ffn_residual(torch.as_tensor(x).to("meta"), **tp, activation="relu")
    # the CPU path is the plain version and launches nothing
    before = tffn.LAUNCHES_FFN
    tffn.fused_ln_ffn_residual(torch.as_tensor(x), **tp, activation="relu")
    assert tffn.LAUNCHES_FFN == before


def test_gate_mirrors_the_kernel_limits():
    assert tffn.can_use_fused_ffn(464, "relu")
    assert not tffn.can_use_fused_ffn(464, "silu")
    assert not tffn.can_use_fused_ffn(tffn.MAX_D_MODEL + 8, "relu")
