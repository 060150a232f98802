"""The fused denoiser path (K4 attention block + K3 LayerNorm-FFN-residual)
held against the JAX package on a small denoiser built from a JAX
checkpoint through ``params_from_flax``: logits against the JAX Block stack
with both fused gates forced and the Pallas kernels in interpret mode, and
against the JAX XLA path; the deterministic reverse chain token for token;
and the switches and gates that choose the path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import layoutdm_tpu.ops.attention as jax_attention
import layoutdm_tpu.ops.ffn as jax_ffn
import layoutdm_tpu_torch.models.nn as nn_mod
from layoutdm_tpu import tasks as jtasks
from layoutdm_tpu.configs import SamplingConfig
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.models.nn import Dropout
from layoutdm_tpu_torch.utils.params import params_from_flax

from torch_port_helpers import cond_to_port, layout_batch, layoutdm_pair

# logits of 2 blocks where the JAX kernels run in interpret mode, whose
# attention dots round float32 operands to bf16 (as the TPU's default
# precision does)
INTERPRET_TOL = 1e-2
XLA_TOL = 1e-4  # float32 on both sides, sums in another order
TASKS = ["unconditional", "c", "cwh", "partial", "refinement"]
TINY = [
    "data.bbox_quantization=linear", "dataset.max_seq_length=5",
    "backbone.d_model=128", "backbone.nhead=2", "backbone.dim_feedforward=64",
    "backbone.num_layers=2", "model.num_timesteps=10", "backbone.diffusion_step=10",
]


@pytest.fixture(scope="module")
def pair():
    """A JAX LayoutDM and the port's fused LayoutDM on its weights, biases
    and norm parameters randomised so that every tensor's mapping counts."""
    jm, params, tm = layoutdm_pair(seed=4, fused_block=True, fused_ffn=True)
    rs = np.random.RandomState(3)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rs.randn(*np.shape(p)).astype(np.float32), params
    )
    tm.net.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _inputs(tm, B=3, seed=2):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, tm.num_classes, (B, tm.seq_len))
    t = rs.randint(0, tm.q.num_timesteps, (B,))
    return ids, t


def _port_logits(tm, ids, t):
    with torch.inference_mode():
        return tm.net(torch.as_tensor(ids), torch.as_tensor(t)).numpy()


def test_fused_logits_match_jax_fused_blocks(pair, monkeypatch):
    """Both JAX gates forced on, both Pallas kernels in interpret mode:
    the JAX Block stack runs K4 and K3 as the port does."""
    jm, params, tm = pair
    real_block, real_ffn = jax_attention.fused_attention_block, jax_ffn.fused_ln_ffn_residual
    calls = []

    def block(*a, **k):
        calls.append("K4")
        return real_block(*a, **{**k, "interpret": True})

    def ffn(*a, **k):
        calls.append("K3")
        return real_ffn(*a, **{**k, "interpret": True})

    monkeypatch.setattr(jax_attention, "can_use_fused_block", lambda *a, **k: True)
    monkeypatch.setattr(jax_attention, "fused_attention_block", block)
    monkeypatch.setattr(jax_ffn, "can_use_fused_ffn", lambda *a, **k: True)
    monkeypatch.setattr(jax_ffn, "fused_ln_ffn_residual", ffn)
    ids, t = _inputs(tm)
    want = np.asarray(jm.net.apply({"params": params}, jnp.asarray(ids), jnp.asarray(t)))
    assert calls == ["K4", "K3"] * tm.backbone_cfg.num_layers
    np.testing.assert_allclose(_port_logits(tm, ids, t), want, rtol=0, atol=INTERPRET_TOL)


def test_fused_logits_match_jax_xla_path(pair):
    jm, params, tm = pair
    ids, t = _inputs(tm, seed=5)
    want = np.asarray(jax.jit(jm.net.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(t)))
    np.testing.assert_allclose(_port_logits(tm, ids, t), want, rtol=0, atol=XLA_TOL)


@pytest.mark.parametrize("task", TASKS)
def test_fused_chain_token_identical_to_jax(task):
    jm, params, tm = layoutdm_pair(seed=0, fused_block=True, fused_ffn=True)
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
    """Count the denoiser's calls of each attention and FFN function."""
    calls = {"K1": 0, "K4": 0, "K3": 0}
    for name, key in (("fused_attention_qkv", "K1"), ("fused_attention_qkv_diff", "K1"),
                      ("fused_attention_block", "K4"), ("fused_ln_ffn_residual", "K3")):
        real = getattr(nn_mod, name)

        def wrapped(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(nn_mod, name, wrapped)
    return calls


@pytest.mark.parametrize("env,kw,fused", [
    ({}, {}, False),
    ({"LAYOUTDM_TPU_FUSED_BLOCK": "1", "LAYOUTDM_TPU_FUSED_FFN": "1"}, {}, True),
    ({"LAYOUTDM_TPU_FUSED_BLOCK": "0", "LAYOUTDM_TPU_FUSED_FFN": "0"}, {}, False),
    ({}, {"fused_block": True, "fused_ffn": True}, True),
    ({"LAYOUTDM_TPU_FUSED_BLOCK": "1", "LAYOUTDM_TPU_FUSED_FFN": "1"},
     {"fused_block": False, "fused_ffn": False}, False),
])
def test_switches_choose_the_path(monkeypatch, env, kw, fused):
    """The JAX package's env switches, read by build_model, or its explicit
    keywords, which win."""
    for k in ("LAYOUTDM_TPU_FUSED_BLOCK", "LAYOUTDM_TPU_FUSED_FFN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = tconfigs.build_train_config("layoutdm", "synthetic", TINY)
    model = build_model(cfg, device="cpu", **kw)
    calls = _counting(monkeypatch)
    model.sample_ids(torch.arange(2), 2, num_timesteps_eval=3)
    layers = model.backbone_cfg.num_layers
    want = {"K1": 0, "K4": 3 * layers, "K3": 3 * layers} if fused else {
        "K1": 3 * layers, "K4": 0, "K3": 0}
    assert calls == want
    assert ("K4" in model.denoiser_path) == fused


def test_training_under_autograd_ignores_the_switches(monkeypatch):
    """Training (dropout, autograd) and a forward with grad enabled take
    K1 and the unfused FFN, as the JAX package's deterministic gate does."""
    cfg = tconfigs.build_train_config("layoutdm", "synthetic", TINY)
    model = build_model(cfg, device="cpu", fused_block=True, fused_ffn=True)
    calls = _counting(monkeypatch)
    ids = model.preprocess(layout_batch(np.random.RandomState(0), 4, num_categories=5))
    losses, _ = model.loss(ids, model.init_state(), torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    assert calls["K4"] == calls["K3"] == 0 and calls["K1"] > 0
    assert all(p.grad is not None for p in model.net.parameters() if p.requires_grad)
    calls["K1"] = 0
    model.net(ids["seq"], torch.zeros(4, dtype=torch.int64))  # grad enabled, no dropout
    assert calls == {"K1": model.backbone_cfg.num_layers, "K4": 0, "K3": 0}
    with torch.no_grad():
        model.net(ids["seq"], torch.zeros(4, dtype=torch.int64), Dropout(torch.Generator()))
    assert calls["K4"] == calls["K3"] == 0


def test_gate_declines_widths_the_kernels_do_not_take():
    bb = tconfigs.BackboneConfig(d_model=1024, nhead=8, dim_feedforward=64, num_layers=1,
                                 timestep_type="adalayernorm", diffusion_step=10)
    block = nn_mod.Block(bb, fused_block=True, fused_ffn=True)
    assert not block.fused_block and not block.fused_ffn
    block = nn_mod.Block(tconfigs.BackboneConfig(d_model=464, nhead=8, activation="gelu2"),
                         fused_block=True, fused_ffn=True)
    assert block.fused_block and block.fused_ffn
