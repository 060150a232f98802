"""The port's continuous diffusion (`models.continuous`: DiffusionLM and
BitDiffusion) held against the JAX package on the same weights: the
codecs and the codebook exactly, each loss term on the JAX draws, the DDPM
and DDIM reverse loops step by step on the JAX noise (unconditional and
inpainted), the reference-checkpoint converter, a JAX job read by
`load_jax_job`, and AdamW's decay groups."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu import tasks as jtasks
from layoutdm_tpu.configs import SamplingConfig
from layoutdm_tpu.configs import build_train_config as jax_build_train_config
from layoutdm_tpu.factory import build_model as jax_build_model
from layoutdm_tpu.models.continuous import base as jax_base
from layoutdm_tpu.models.continuous.models import _trunc_normal
from layoutdm_tpu.models.continuous.models import ids_to_bits as jax_ids_to_bits
from layoutdm_tpu.train import checkpoint as jax_ckpt
from layoutdm_tpu.utils.torch_port import convert_continuous_transformer as jax_convert
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.configs import SamplingConfig as TSampling
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.models.base import Draws
from layoutdm_tpu_torch.models.continuous import base
from layoutdm_tpu_torch.models.continuous.models import codebook, ids_to_bits
from layoutdm_tpu_torch.train.step import decayed_parameter_names
from layoutdm_tpu_torch.utils.params import (
    load_jax_job,
    load_job,
    params_from_flax,
    with_own_buffers,
)
from layoutdm_tpu_torch.utils.torch_port import (
    continuous_to_reference_state_dict,
    convert_continuous_transformer,
)
from torch_port_helpers import cond_to_port, jax_decayed_names, layout_batch

LOSS_TOL = 1e-5  # float32 losses on the same weights and draws
LOGIT_TOL = 1e-5
# the reverse loop's x after every step, relative to its largest entry: the
# first step divides by alpha(t = 1) ~ 4e-8, which magnifies float32
# differences of the two schedules' transcendentals
STEP_REL_TOL = 1e-4
# d_model 64 shrinks 29/32 to 58 = 2 heads of 29; 4 elements, 20 tokens
TINY = ["dataset.max_seq_length=4", "data.bbox_quantization=linear", "backbone.d_model=64",
        "backbone.nhead=2", "backbone.dim_feedforward=64", "backbone.num_layers=2",
        "model.num_timesteps=4"]


def pair(experiment, extra=(), seed=0):
    jcfg = jax_build_train_config(experiment, "synthetic", TINY + list(extra))
    tcfg = tconfigs.build_train_config(experiment, "synthetic", TINY + list(extra))
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    # a frozen codebook is no JAX param: the port's net keeps its own
    tm.net.load_state_dict(with_own_buffers(params_from_flax(jax.tree.map(np.asarray, params)),
                                            tm.net))
    return jm, params, tm


@pytest.fixture(scope="module")
def pairs():
    return {"diffusionlm": pair("diffusionlm"), "bitdiffusion": pair("bitdiffusion", seed=1),
            "frozen": pair("diffusionlm", ["model.learnable_token_emb=false"], seed=2)}


def _batch(tm, B, seed):
    return layout_batch(np.random.RandomState(seed), B, 4, tm.tokenizer.N_category)


def test_schedules_codecs_and_codebook_match_jax(pairs):
    t = np.linspace(0, 1, 11, dtype=np.float32)
    for name in ("linear", "cosine"):
        want = np.asarray(jax_base.LOG_SNR[name](jnp.asarray(t)))
        np.testing.assert_allclose(base.LOG_SNR[name](torch.as_tensor(t)).numpy(), want,
                                   rtol=1e-6)
    # the frozen codebook, bit for bit, and the rounder initialised to it
    want = _trunc_normal(np.random.RandomState(0), (155, 16))
    np.testing.assert_array_equal(codebook(155, 16), want)
    jm, params, tm = pairs["frozen"]
    np.testing.assert_array_equal(tm.net.token_emb.numpy(), np.asarray(jm.token_emb))
    assert "token_emb" not in params and not tm.net.token_emb.requires_grad
    ids = np.random.RandomState(3).randint(0, 256, (3, 7))
    np.testing.assert_array_equal(ids_to_bits(torch.as_tensor(ids), 8).numpy(),
                                  np.asarray(jax_ids_to_bits(jnp.asarray(ids), 8)))
    for key in ("diffusionlm", "bitdiffusion"):
        jm, params, tm = pairs[key]
        seq = np.asarray(tm.tokenizer.encode(_batch(tm, 4, 4))["seq"])
        want, _ = jm.dis2con(params, jnp.asarray(seq))
        got, _ = tm.dis2con(torch.as_tensor(seq))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        arr = np.random.RandomState(5).randn(*got.shape).astype(np.float32)
        np.testing.assert_array_equal(tm.con2dis(torch.as_tensor(arr)).numpy(),
                                      np.asarray(jm.con2dis(params, jnp.asarray(arr))))
        if key == "bitdiffusion":  # analog bits decode back exactly
            np.testing.assert_array_equal(tm.con2dis(got).numpy(), seq)


def _jax_loss_draws(jm, key, seq, x_shape):
    B = seq.shape[0]
    r_t, r_noise, r_rep, r_sc, _ = jax.random.split(key, 5)
    d = {"times": [np.asarray(jax.random.uniform(r_t, (B,), maxval=0.999))],
         "noise": [np.asarray(jax.random.normal(r_noise, x_shape))],
         "self_cond": [np.asarray(jax.random.bernoulli(r_sc))]}
    if jm.has_rounder:
        d["rep"] = [np.asarray(jax.random.normal(r_rep, x_shape))]
    return d


@pytest.mark.parametrize("key", ["diffusionlm", "bitdiffusion"])
def test_losses_match_jax_term_by_term(pairs, key):
    jm, params, tm = pairs[key]
    seq = tm.tokenizer.encode(_batch(tm, 6, 6))["seq"]
    x_shape = (6, tm.seq_len, tm.num_channel)
    coins = set()
    for k in range(4):  # JAX keys whose self-condition coin falls both ways
        rng = jax.random.PRNGKey(10 + k)
        want, _ = jm.loss(params, rng, {"seq": jnp.asarray(seq.numpy())}, jm.init_state(),
                          is_train=False)
        draws = _jax_loss_draws(jm, rng, seq.numpy(), x_shape)
        coins.add(bool(draws["self_cond"][0]))
        got, _ = tm.loss({"seq": seq}, tm.init_state(), Draws(injected=draws), is_train=False)
        assert set(got) == set(want)
        for term in want:
            np.testing.assert_allclose(got[term].item(), float(want[term]), rtol=LOSS_TOL,
                                       err_msg=term)
    if key == "bitdiffusion":
        assert coins == {True, False}
    # training mode draws everything from a generator and backpropagates
    got, _ = tm.loss({"seq": seq}, None, torch.Generator().manual_seed(0))
    sum(got.values()).backward()
    grads = [p.grad for p in tm.net.parameters() if p.requires_grad]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    tm.net.zero_grad(set_to_none=True)


def _scan_recorder(xs_out):
    """`jax.lax.scan` as a python loop that records each step's x."""

    def scan(f, init, xs):
        carry, f = init, jax.jit(f)
        for i in range(len(xs[0])):
            carry, _ = f(carry, jax.tree.map(lambda a: a[i], xs))
            xs_out.append(np.asarray(carry[0]))
        return carry, None

    return scan


@pytest.mark.parametrize("key,use_ddim,task", [
    ("diffusionlm", False, "unconditional"), ("diffusionlm", True, "c"),
    ("bitdiffusion", False, "c"), ("bitdiffusion", True, "unconditional"),
])
def test_reverse_loop_matches_jax_step_by_step(pairs, monkeypatch, key, use_ddim, task):
    jm, params, tm = pairs[key]
    B, T = 3, 4
    shape = (B, tm.seq_len, tm.num_channel)
    js = SamplingConfig(name="random", num_timesteps=T)
    jc = None
    if task != "unconditional":
        c = jtasks.get_cond(jax.random.PRNGKey(4), _batch(tm, B, 5), jm.tokenizer, task)
        jc = jtasks.to_sampler_cond(c, jm.tokenizer, js)
    rng = jax.random.PRNGKey(11)
    want_x = []
    monkeypatch.setattr(jax.lax, "scan", _scan_recorder(want_x))
    want = np.asarray(jm.sample_ids(params, rng, B, cond=jc, sampling=js, use_ddim=use_ddim))
    monkeypatch.undo()
    # the JAX loop's draws: x_T, then one normal a DDPM step
    rng, r0 = jax.random.split(rng)
    injected = {"x_T": [np.asarray(jax.random.normal(r0, shape))], "noise": []}
    for _ in range(T):
        rng, r_n = jax.random.split(rng)
        injected["noise"].append(np.asarray(jax.random.normal(r_n, shape)))
    got, got_x = tm.sample_ids(Draws(injected=injected), B,
                               cond=None if jc is None else cond_to_port(jc),
                               sampling=TSampling(name="random", num_timesteps=T),
                               use_ddim=use_ddim, get_intermediates=True)
    assert len(got_x) == len(want_x) == T
    for step, (g, w) in enumerate(zip(got_x, want_x)):
        err = np.abs(g.numpy() - w).max()
        assert err <= STEP_REL_TOL * np.abs(w).max(), (step, err)
    np.testing.assert_array_equal(got.numpy(), want)
    if jc is not None:  # inpainting holds the condition's tokens
        m = np.asarray(jc.strong_mask)
        np.testing.assert_array_equal(got.numpy()[m], np.asarray(jc.seq)[m])


@pytest.mark.parametrize("pos,tt", [("elem_attr", "adalayernorm_mlp"),
                                    ("default", "adalayernorm_mlp"),
                                    ("elem_attr", "adalayernorm_abs")])
def test_reference_converter_matches_jax(pos, tt):
    """A reference state dict (``transformer.`` keys, DiffusionLM's
    ``token_emb.weight`` and ``rounder`` beside them) through the JAX
    converter and the port's: the same denoiser outputs and rounder."""
    extra = [f"model.pos_emb={pos}", f"backbone.timestep_type={tt}"]
    jm, _, tm = pair("diffusionlm", extra, seed=3)
    L = tm.backbone_cfg.num_layers
    ref = continuous_to_reference_state_dict(tm.net.state_dict(), L, tt)
    assert {"token_emb.weight", "rounder.weight", "transformer.emb.weight"} <= set(ref)
    sd = convert_continuous_transformer(ref, L, tt)
    assert set(sd) == set(tm.net.state_dict())
    jparams = dict(jax_convert(ref, L, tt))
    jparams["rounder"] = {"kernel": ref["rounder.weight"].numpy().T,
                          "bias": ref["rounder.bias"].numpy()}
    other = build_model(tconfigs.build_train_config("diffusionlm", "synthetic", TINY + extra),
                        device="cpu")
    other.net.load_state_dict(sd)
    rs = np.random.RandomState(9)
    x = rs.randn(2, tm.seq_len, tm.num_channel).astype(np.float32)
    t = np.array([-2.5, 4.0], np.float32)  # log-SNRs
    want = np.asarray(jm.net.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = other.net(torch.as_tensor(x), torch.as_tensor(t))
        np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(other.con2logits(got).numpy(),
                                   np.asarray(jm.con2logits(jparams, jnp.asarray(want))),
                                   atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("key", ["diffusionlm", "bitdiffusion", "frozen"])
def test_jax_job_reads_into_a_port_job_and_decay_groups(tmp_path, pairs, key):
    jm, params, tm = pairs[key]
    extra = ["model.learnable_token_emb=false"] if key == "frozen" else []
    jcfg = jax_build_train_config("diffusionlm" if key == "frozen" else key, "synthetic",
                                  TINY + extra)
    jdir = str(tmp_path / "jax")
    jax_ckpt.save_config(jcfg, jdir)
    jax_ckpt.save_params(params, jdir, "best")
    load_jax_job(jdir, str(tmp_path / "port"))
    cfg, sd = load_job(str(tmp_path / "port"))
    model = build_model(cfg, device="cpu")
    model.net.load_state_dict(sd)  # rounder and token_emb included
    rs = np.random.RandomState(8)
    x = rs.randn(2, model.seq_len, model.num_channel).astype(np.float32)
    t = np.array([-1.0, 3.0], np.float32)
    want = np.asarray(jm.net.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model.net(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    if model.has_rounder:
        np.testing.assert_array_equal(model.net.token_emb.detach().numpy(),
                                      np.asarray(jm._emb(params)))
    # AdamW decays exactly where the JAX mask does (the rounder's kernel
    # too; never token_emb)
    mapped = jax_decayed_names(params)
    assert set(decayed_parameter_names(tm.net)) == mapped
    assert ("rounder.weight" in mapped) == tm.has_rounder
