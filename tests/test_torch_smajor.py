"""K6, the sequence-major packed-qkv attention, and the S-major denoiser
path held against the JAX package: the plain version against the Pallas
kernel in interpret mode, the port's ``SelfAttention`` on the S-major path
against the JAX ``SelfAttention`` with its gates forced, and the
deterministic reverse chain token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import layoutdm_tpu.ops.attention as jax_attention
import layoutdm_tpu_torch.models.nn as nn_mod
from layoutdm_tpu import tasks as jtasks
from layoutdm_tpu.configs import SamplingConfig
from layoutdm_tpu.models.nn import SelfAttention as JaxSelfAttention
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.ops import attention as tattention
from layoutdm_tpu_torch.utils.params import params_from_flax

from torch_port_helpers import cond_to_port, layout_batch, layoutdm_pair

TASKS = ["unconditional", "c", "cwh", "partial", "refinement"]
ATOL = 1e-5  # the JAX test's own (`tests/test_pallas_attention.py:266`)
# the JAX kernel in interpret mode rounds its f32 dot operands to bf16 (the
# MXU's default precision), the plain version does not
INTERPRET_TOL = 2e-2
# bf16, elementwise atol + rtol |want|: both add the bias in bf16 and round
# the normalised p and the output at the same points (`test_torch_attention`)
BF16_RTOL, BF16_ATOL = 2 ** -7, 2 ** -8
SHARP = 3.0  # q and k scaled by this: one key takes most of a row's weight


def _inputs(rs, B, S, H, hd):
    qkv = rs.randn(B, S, 3 * H * hd).astype(np.float32)
    bias = rs.randn(3 * H * hd).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("B,S,H,hd", [(4, 10, 2, 8), (3, 25, 2, 58), (2, 21, 4, 64)])
def test_plain_version_matches_jax_kernel(B, S, H, hd):
    qkv, bias = _inputs(np.random.RandomState(0), B, S, H, hd)
    qkv_sb = np.ascontiguousarray(qkv.swapaxes(0, 1))
    want = np.asarray(jax_attention.fused_attention_qkv_smajor(
        jnp.asarray(qkv_sb), jnp.asarray(bias), num_heads=H, interpret=True))
    got = tattention.attention_qkv_smajor_reference(
        torch.as_tensor(qkv_sb), torch.as_tensor(bias), H).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the same function as K1 on the batch-major slab plus the bias
    k1 = tattention.attention_qkv_reference(torch.as_tensor(qkv + bias), H).numpy()
    np.testing.assert_allclose(got, k1, rtol=0, atol=ATOL)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(tattention.fused_attention_qkv_smajor(
        torch.as_tensor(qkv_sb), torch.as_tensor(bias), H).numpy(), got)


@pytest.mark.parametrize(
    "S,sharp", [(125, SHARP), (127, 1.0), (128, 1.0), (129, 1.0), (129, SHARP)]
)
def test_plain_version_matches_jax_kernel_bf16_sharp_and_edges(S, sharp):
    """bf16 on sharp scores and at the 128-key edge of the port's kernel."""
    B, H, hd = 2, 2, 58
    qkv, bias = _inputs(np.random.RandomState(4), B, S, H, hd)
    qkv[..., : 2 * H * hd] *= sharp
    qkv_sb = np.ascontiguousarray(qkv.swapaxes(0, 1))
    want = jax_attention.fused_attention_qkv_smajor(
        jnp.asarray(qkv_sb, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16), num_heads=H,
        interpret=True)
    got = tattention.attention_qkv_smajor_reference(
        torch.as_tensor(qkv_sb).to(torch.bfloat16), torch.as_tensor(bias).to(torch.bfloat16), H)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H * hd)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def test_bias_rounds_once_in_the_io_dtype():
    """bf16: the bias is added to the slab in bf16 (one rounding), as the
    TPU kernel adds it in VMEM."""
    rs = np.random.RandomState(1)
    qkv, bias = _inputs(rs, 2, 7, 2, 8)
    x = torch.as_tensor(qkv.swapaxes(0, 1).copy()).to(torch.bfloat16)
    b = torch.as_tensor(bias)
    got = tattention.attention_qkv_smajor_reference(x, b, 2)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 7, 16)
    want = tattention.attention_qkv_reference((x + b.to(torch.bfloat16)).transpose(0, 1), 2)
    assert torch.equal(got, want)


def test_shapes_are_checked():
    assert tattention.can_use_smajor(58) and tattention.can_use_smajor(128)
    assert not tattention.can_use_smajor(160)
    with pytest.raises(ValueError, match="bias must be"):
        tattention.fused_attention_qkv_smajor(torch.zeros(5, 2, 48), torch.zeros(47), 2)
    with pytest.raises(ValueError, match="not divisible"):
        tattention.fused_attention_qkv_smajor(torch.zeros(5, 2, 48), torch.zeros(48), 3)


def test_selfattention_smajor_matches_jax_smajor_branch(monkeypatch):
    """Module level: the JAX plain-fused S-major branch (`models/nn.py:
    335-349`, gates forced, kernel in interpret mode) and the port's."""
    B, S, D, H = 2, 9, 232, 4  # hd = 58
    rs = np.random.RandomState(3)
    x = rs.randn(B, S, D).astype(np.float32)
    mod = JaxSelfAttention(D, H, 0.0)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    calls = []
    real = jax_attention.fused_attention_qkv_smajor

    def kernel(*a, **k):
        calls.append(1)
        return real(*a, **{**k, "interpret": True})

    monkeypatch.setattr(jax_attention, "can_use_padded_qkv", lambda *a, **k: False)
    monkeypatch.setattr(jax_attention, "can_use_fused", lambda *a, **k: True)
    monkeypatch.setattr(jax_attention, "can_use_smajor", lambda *a, **k: True)
    monkeypatch.setattr(jax_attention, "fused_attention_qkv_smajor", kernel)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    assert calls == [1]

    port = nn_mod.SelfAttention(D, H, 0.0, smajor=True)
    port.load_state_dict({k.replace("attn.", ""): v for k, v in params_from_flax(
        {"attn": jax.tree.map(np.asarray, params)}).items()})
    launched = []
    monkeypatch.setattr(nn_mod, "fused_attention_qkv_smajor",
                        lambda *a: launched.append(1) or tattention.fused_attention_qkv_smajor(*a))
    with torch.no_grad():
        got = port(torch.as_tensor(x)).numpy()
    assert launched == [1]
    np.testing.assert_allclose(got, want, rtol=0, atol=INTERPRET_TOL)
    # and the JAX XLA path, f32 on both sides
    monkeypatch.undo()
    want_xla = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=ATOL)


def test_parameter_tree_unchanged_on_the_smajor_path():
    _, _, tm = layoutdm_pair(seed=1, smajor=True)
    _, _, default = layoutdm_pair(seed=1)
    for (k, a), b in zip(tm.net.state_dict().items(), default.net.state_dict().values()):
        assert torch.equal(a, b), k
    assert "S-major attention (K6)" in tm.denoiser_path


@pytest.mark.parametrize("task", TASKS)
def test_smajor_chain_token_identical_to_jax(task):
    jm, params, tm = layoutdm_pair(seed=0, smajor=True)
    rs = np.random.RandomState(6)
    B = 4
    js = SamplingConfig(name="deterministic")
    if task == "unconditional":
        jc = jtasks.to_sampler_cond(None, jm.tokenizer, js, batch_size=B)
    else:
        jc = jtasks.to_sampler_cond(
            jtasks.get_cond(jax.random.PRNGKey(2), layout_batch(rs, B), jm.tokenizer, task),
            jm.tokenizer, js,
        )
    want = np.asarray(jm.sample_ids(params, jax.random.PRNGKey(0), B, cond=jc, sampling=js))
    got = tm.sample_ids(torch.arange(B), B, cond=cond_to_port(jc),
                        sampling=tconfigs.SamplingConfig(name="deterministic"))
    np.testing.assert_array_equal(got.numpy(), want)
