"""K5, the padded-head (block-diagonal) attention, and the V2 denoiser path
held against the JAX package: the plain version against the Pallas kernel
in interpret mode, the weight scatter, the port's ``SelfAttention`` on the
V2 path against the JAX ``SelfAttention`` with its gate forced, the
deterministic reverse chain token for token, and the switches that choose
the path."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import layoutdm_tpu.ops.attention_blockdiag as jax_bd
import layoutdm_tpu_torch.models.nn as nn_mod
from layoutdm_tpu import tasks as jtasks
from layoutdm_tpu.configs import SamplingConfig
from layoutdm_tpu.models.nn import SelfAttention as JaxSelfAttention
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.ops import attention_blockdiag as bd
from layoutdm_tpu_torch.utils.params import params_from_flax

from torch_port_helpers import cond_to_port, layout_batch, layoutdm_pair

TASKS = ["unconditional", "c", "cwh", "partial", "refinement"]
TINY = [
    "data.bbox_quantization=linear", "dataset.max_seq_length=5",
    "backbone.d_model=128", "backbone.nhead=2", "backbone.dim_feedforward=64",
    "backbone.num_layers=2", "model.num_timesteps=10", "backbone.diffusion_step=10",
]
F32_ATOL = 2e-5  # the JAX test's own (`tests/test_attention_blockdiag.py:60`)
BF16_REL = 2 ** -7  # two bf16 output roundings of the largest |out|


def _padded(rs, B, S, H, hd, hp, dtype=np.float32):
    """A padded-head slab: each head's q, k, v zero past lane hd."""
    x = np.zeros((B, S, 3, H, hp), np.float32)
    x[..., :hd] = rs.randn(B, S, 3, H, hd)
    return x.reshape(B, S, 3 * H * hp).astype(dtype)


@pytest.mark.parametrize("B,S,H,hd,hp", [
    (2, 9, 2, 6, 64), (3, 25, 4, 58, 64), (2, 21, 2, 58, 128),
    # the CUDA kernel's tile edges: one key, one 16-key step, a 16-key step
    # past a 64-key boundary, one past its 128-key chunk (the second sweep);
    # hd 58 inside hp 128
    (2, 1, 2, 58, 64), (1, 16, 2, 58, 64), (1, 65, 2, 58, 64), (1, 129, 2, 58, 64),
    (1, 65, 2, 58, 128), (1, 129, 1, 58, 128),
])
def test_plain_version_matches_jax_kernel(B, S, H, hd, hp):
    qkv = _padded(np.random.RandomState(0), B, S, H, hd, hp)
    scale = 1.0 / math.sqrt(hd)
    want = np.asarray(jax_bd.blockdiag_attention(
        jnp.asarray(qkv), num_heads=H, head_pad=hp, scale=scale, interpret=True))
    got = bd.blockdiag_attention_reference(torch.as_tensor(qkv), H, hp, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    # the padded output lanes are exactly zero
    assert not got.reshape(B, S, H, hp)[..., hd:].any()
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(
        bd.blockdiag_attention(torch.as_tensor(qkv), H, hp, scale).numpy(), got)


def _check_bf16(B, S, H, hd, hp):
    qkv = _padded(np.random.RandomState(1), B, S, H, hd, hp)
    x = torch.as_tensor(qkv).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(hd)
    want = np.asarray(jax_bd.blockdiag_attention(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), num_heads=H, head_pad=hp,
        scale=scale, interpret=True), np.float32)
    got = bd.blockdiag_attention(x, H, hp, scale)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_REL * np.abs(want).max())
    assert not got.reshape(B, S, H, hp)[..., hd:].any()


def test_plain_version_bf16_matches_jax_kernel():
    _check_bf16(2, 25, 2, 58, 64)


@pytest.mark.parametrize("S,hp", [(1, 64), (16, 64), (65, 128), (129, 64)])
def test_plain_version_bf16_at_kernel_tile_edges(S, hp):
    """bf16 at the CUDA kernel's tile edges (one key, one 16-key step, past
    a 64-key boundary, past the 128-key chunk), hd 58 in hp 64 and 128."""
    _check_bf16(1, S, 2, 58, hp)


def test_weight_scatter_is_the_jax_scatter_transposed():
    """The port's weights are nn.Linear (out, in): it scatters rows where
    the JAX package scatters columns; the new rows are zero."""
    rs = np.random.RandomState(2)
    D, H, hd, hp = 24, 4, 6, 8
    w = rs.randn(D, 3 * H * hd).astype(np.float32)  # flax (in, out)
    b = rs.randn(3 * H * hd).astype(np.float32)
    jw, jb = jax_bd.scatter_qkv_weights(jnp.asarray(w), jnp.asarray(b), H, hd, hp)
    tw, tb = bd.scatter_qkv_weights(torch.as_tensor(w.T), torch.as_tensor(b), H, hd, hp)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).T)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert not tw.numpy().reshape(3, H, hp, D)[:, :, hd:].any()
    wo = rs.randn(H * hd, D).astype(np.float32)
    jo = jax_bd.scatter_out_weights(jnp.asarray(wo), H, hd, hp)
    to = bd.scatter_out_weights(torch.as_tensor(wo.T), H, hd, hp)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo).T)
    # round trip: the scatter's real rows are the weights themselves
    np.testing.assert_array_equal(tw.reshape(3, H, hp, D)[:, :, :hd].reshape(-1, D).numpy(), w.T)


def test_gate_takes_shapes_only():
    assert bd.padded_head_dim(58) == 64 and bd.padded_head_dim(64) == 64
    assert bd.padded_head_dim(100) == 128
    # the flagship at S=125 and at S=500, which the JAX VMEM model refuses
    assert bd.can_use_blockdiag(58, 125) and bd.can_use_blockdiag(58, 500)
    assert not bd.can_use_blockdiag(58, bd.MAX_SEQ + 1)
    assert not bd.can_use_blockdiag(160, 125)
    with pytest.raises(ValueError, match="qkv_pad must be"):
        bd.blockdiag_attention(torch.zeros(2, 5, 3 * 2 * 58), 2, 64, 0.1)


def test_selfattention_v2_matches_jax_v2_branch(monkeypatch):
    """Module level, as `tests/test_attention_blockdiag.py:106-126`: the JAX
    V2 branch (gate forced, kernel in interpret mode) and the port's."""
    B, S, D, H = 2, 9, 232, 4  # hd = 58
    rs = np.random.RandomState(3)
    x = rs.randn(B, S, D).astype(np.float32)
    mod = JaxSelfAttention(D, H, 0.0)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    calls = []
    real = jax_bd.blockdiag_attention

    def kernel(*a, **k):
        calls.append(1)
        return real(*a, **{**k, "interpret": True})

    monkeypatch.setattr(jax_bd, "can_use_blockdiag", lambda *a, **k: True)
    monkeypatch.setattr(jax_bd, "blockdiag_attention", kernel)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    assert calls == [1]

    port = nn_mod.SelfAttention(D, H, 0.0, attn_v2=True)
    port.load_state_dict({k.replace("attn.", ""): v for k, v in params_from_flax(
        {"attn": jax.tree.map(np.asarray, params)}).items()})
    launched = []
    monkeypatch.setattr(nn_mod, "blockdiag_attention",
                        lambda *a: launched.append(1) or bd.blockdiag_attention(*a))
    with torch.no_grad():
        got = port(torch.as_tensor(x)).numpy()
    assert launched == [1]
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_parameter_tree_unchanged_on_the_v2_path():
    """The V2 path scatters at run time: the state dict is the default
    path's, so a JAX checkpoint carries over through `params_from_flax`."""
    jm, params, tm = layoutdm_pair(seed=1, attn_v2=True)
    _, _, default = layoutdm_pair(seed=1)
    assert tm.net.state_dict().keys() == default.net.state_dict().keys()
    for (k, a), b in zip(tm.net.state_dict().items(), default.net.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("task", TASKS)
def test_v2_chain_token_identical_to_jax(task):
    """The port's V2 path against the JAX chain on the CPU (where the JAX
    gate sends every shape to its XLA path: the same function)."""
    jm, params, tm = layoutdm_pair(seed=0, attn_v2=True)
    rs = np.random.RandomState(5)
    B = 4
    js = SamplingConfig(name="deterministic")
    if task == "unconditional":
        jc = jtasks.to_sampler_cond(None, jm.tokenizer, js, batch_size=B)
    else:
        jc = jtasks.to_sampler_cond(
            jtasks.get_cond(jax.random.PRNGKey(1), layout_batch(rs, B), jm.tokenizer, task),
            jm.tokenizer, js,
        )
    want = np.asarray(jm.sample_ids(params, jax.random.PRNGKey(0), B, cond=jc, sampling=js))
    got = tm.sample_ids(torch.arange(B), B, cond=cond_to_port(jc),
                        sampling=tconfigs.SamplingConfig(name="deterministic"))
    np.testing.assert_array_equal(got.numpy(), want)


def _counting(monkeypatch):
    calls = {"K1": 0, "K4": 0, "K5": 0, "K6": 0}
    for name, key in (("fused_attention_qkv", "K1"), ("fused_attention_qkv_diff", "K1"),
                      ("fused_attention_block", "K4"), ("blockdiag_attention", "K5"),
                      ("fused_attention_qkv_smajor", "K6")):
        real = getattr(nn_mod, name)

        def wrapped(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(nn_mod, name, wrapped)
    return calls


@pytest.mark.parametrize("env,kw,want", [
    ({"LAYOUTDM_TPU_ATTN_V2": "1"}, {}, "K5"),
    ({"LAYOUTDM_TPU_SMAJOR": "1"}, {}, "K6"),
    ({"LAYOUTDM_TPU_ATTN_V2": "1", "LAYOUTDM_TPU_SMAJOR": "1"}, {}, "K5"),
    ({"LAYOUTDM_TPU_ATTN_V2": "1", "LAYOUTDM_TPU_FUSED_BLOCK": "1"}, {}, "K4"),
    ({"LAYOUTDM_TPU_ATTN_V2": "1"}, {"attn_v2": False}, "K1"),
    ({}, {"smajor": True}, "K6"),
    ({"LAYOUTDM_TPU_ATTN_V2": "0", "LAYOUTDM_TPU_SMAJOR": "0"}, {}, "K1"),
])
def test_switches_and_precedence(monkeypatch, env, kw, want):
    """The JAX package's env switches, read by build_model, or its explicit
    keywords, which win; K4 comes before K5, and K5 before K6."""
    for k in ("LAYOUTDM_TPU_ATTN_V2", "LAYOUTDM_TPU_SMAJOR", "LAYOUTDM_TPU_FUSED_BLOCK",
              "LAYOUTDM_TPU_FUSED_FFN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = tconfigs.build_train_config("layoutdm", "synthetic", TINY)
    model = build_model(cfg, device="cpu", **kw)
    calls = _counting(monkeypatch)
    model.sample_ids(torch.arange(2), 2, num_timesteps_eval=3)
    layers = model.backbone_cfg.num_layers
    assert calls == {k: 3 * layers if k == want else 0 for k in calls}
    assert want in model.denoiser_path


def test_autograd_and_long_sequences_take_k1(monkeypatch):
    """K5 has no backward (in the JAX package or here): under grad the V2
    model runs K1; a sequence over the kernel's limit runs K1 too."""
    cfg = tconfigs.build_train_config("layoutdm", "synthetic", TINY)
    model = build_model(cfg, device="cpu", attn_v2=True)
    calls = _counting(monkeypatch)
    ids = torch.zeros((2, model.seq_len), dtype=torch.int64)
    model.net(ids, torch.zeros(2, dtype=torch.int64)).sum().backward()
    assert calls["K5"] == 0 and calls["K1"] == model.backbone_cfg.num_layers
    attn = model.net.backbone.layers[0].attn
    monkeypatch.setattr(bd, "MAX_SEQ", 4)
    calls["K1"] = 0
    with torch.no_grad():
        attn(torch.zeros(1, 5, 116))
    assert calls == {"K1": 1, "K4": 0, "K5": 0, "K6": 0}
