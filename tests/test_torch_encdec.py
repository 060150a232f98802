"""The port's BART (`models.bart`, the encoder-decoder of `models.nn`) held
against the JAX package on the same weights: the preprocessing under the
JAX draws, the loss, every decode token-identical under deterministic
sampling (unconditional, c, and the partial task under the alphabetical
order, which re-inserts elements on the host), the cached decode against
the recompute decode, the reference-checkpoint converter, a JAX job read
by `load_jax_job`, and AdamW's decay groups."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu import tasks as jtasks
from layoutdm_tpu.configs import SamplingConfig
from layoutdm_tpu.configs import build_train_config as jax_build_train_config
from layoutdm_tpu.factory import build_model as jax_build_model
from layoutdm_tpu.models.bart import BART as JaxBART
from layoutdm_tpu.train import checkpoint as jax_ckpt
from layoutdm_tpu.utils.torch_port import (
    convert_categorical_encdec_transformer as jax_convert_encdec,
)
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.configs import SamplingConfig as TSampling
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.models.bart import BART
from layoutdm_tpu_torch.models.base import Draws
from layoutdm_tpu_torch.train.step import decayed_parameter_names
from layoutdm_tpu_torch.utils.params import load_jax_job, load_job, params_from_flax
from layoutdm_tpu_torch.utils.torch_port import (
    convert_categorical_encdec_transformer,
    encdec_to_reference_state_dict,
)
from torch_port_helpers import cond_to_port, jax_decayed_names, layout_batch

LOSS_TOL = 1e-5  # float32 losses on the same weights and tokens
LOGIT_TOL = 1e-5
# d_model 64 shrinks 21/32 to 42 = 2 heads of 21; 4 elements, 21 tokens with BOS
TINY = ["dataset.max_seq_length=4", "data.bbox_quantization=linear", "backbone.d_model=64",
        "backbone.nhead=2", "backbone.dim_feedforward=64", "backbone.num_layers=2"]


def bart_pair(sort_by=None, seed=0):
    """(jax model, jax params, port model on the CPU) on the same weights."""
    jcfg = jax_build_train_config("bart", "synthetic", TINY)
    tcfg = tconfigs.build_train_config("bart", "synthetic", TINY)
    if sort_by is None:
        jm = jax_build_model(jcfg)
        tm = build_model(tcfg, device="cpu")
    else:
        from layoutdm_tpu.factory import build_tokenizer as jax_tokenizer
        from layoutdm_tpu_torch.factory import build_tokenizer

        jm = JaxBART(jcfg.backbone, jax_tokenizer(jcfg), jcfg.model, sort_by=sort_by)
        tm = BART(tcfg.backbone, build_tokenizer(tcfg), tcfg.model, sort_by=sort_by,
                  device="cpu")
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm.net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def pairs():
    return {None: bart_pair(), "category_alphabetical": bart_pair("category_alphabetical", 1)}


def _batch(tm, B, seed):
    return layout_batch(np.random.RandomState(seed), B, 4, tm.tokenizer.N_category)


def test_bart_shapes_follow_the_reference():
    cfg = tconfigs.build_train_config("bart", "rico25", ["data.bbox_quantization=linear"])
    tm = build_model(cfg, device="cpu")
    bb = tm.backbone_cfg
    assert (bb.d_model, bb.nhead, bb.dim_feedforward, bb.timestep_type) == (336, 8, 1344, None)
    assert tm.seq_len == 126 and tm.gen_len == 125


@pytest.mark.parametrize("sort_by", [None, "category_alphabetical"])
def test_bart_preprocess_and_loss_match_jax(pairs, sort_by):
    """The JAX preprocessing's draws (the random task's ratio and scores,
    the target permutation under the alphabetical order) handed to the
    port give the same input and target; the loss on them matches."""
    jm, params, tm = pairs[sort_by]
    B = 5
    batch = _batch(tm, B, 2)
    key = jax.random.PRNGKey(3)
    jtok = jm.preprocess(batch, key)
    _, r_cond, r_perm = jax.random.split(key, 3)
    r_ratio, r_mask = jax.random.split(r_cond)
    S = tm.seq_len
    injected = {"ratio": [np.asarray(jax.random.uniform(r_ratio, (B,)))],
                "scores": [np.asarray(jax.random.uniform(r_mask, (B, S)))]}
    if sort_by:
        n_elem = tm.gen_len // tm.tokenizer.N_var_per_element
        perm = np.asarray(jax.vmap(lambda r: jax.random.permutation(r, n_elem))(
            jax.random.split(r_perm, B)))
        injected["perm"] = [np.argsort(perm, axis=1).astype(np.float32)]  # argsort -> perm
    tok = tm.preprocess(batch, Draws(injected=injected))
    for k in ("seq", "target"):
        np.testing.assert_array_equal(tok[k].numpy(), np.asarray(jtok[k]))
    if sort_by:
        assert not np.array_equal(np.asarray(jtok["target"]),
                                  tm.tokenizer.encode(batch)["seq"].numpy())
    want, _ = jm.loss(params, jax.random.PRNGKey(0), jtok, jm.init_state(), is_train=False)
    got, state = tm.loss(tok, tm.init_state(), None, is_train=False)
    np.testing.assert_allclose(got["nll_loss"].item(), float(want["nll_loss"]), rtol=LOSS_TOL)
    assert state is None
    # training mode: dropout from the generator, finite and differentiable
    got, _ = tm.loss(tok, None, torch.Generator().manual_seed(0))
    got["nll_loss"].backward()
    assert torch.isfinite(got["nll_loss"]) and tm.net.dec0.cross_attn.q.weight.grad is not None
    tm.net.zero_grad(set_to_none=True)


@pytest.mark.parametrize("task,sort_by,cond_type", [
    ("unconditional", None, None), ("c", None, None),
    ("partial", "category_alphabetical", "partial"),
])
def test_bart_decode_token_identical_cached_and_recompute(pairs, task, sort_by, cond_type):
    jm, params, tm = pairs[sort_by]
    B = 4
    js, ts = SamplingConfig(name="deterministic"), TSampling(name="deterministic")
    jc = None
    if task != "unconditional":
        c = jtasks.get_cond(jax.random.PRNGKey(4), _batch(tm, B, 5), jm.tokenizer, task,
                            model_type="bart")
        jc = jtasks.to_sampler_cond(c, jm.tokenizer, js)
    tc = None if jc is None else cond_to_port(jc)
    want = np.asarray(jm.sample_ids(params, jax.random.PRNGKey(0), B, cond=jc, sampling=js,
                                    cond_type=cond_type))
    cached = tm.sample_ids(None, B, cond=tc, sampling=ts, cond_type=cond_type)
    recompute = tm.sample_ids(None, B, cond=tc, sampling=ts, cond_type=cond_type,
                              use_cache=False)
    np.testing.assert_array_equal(cached.numpy(), want)
    np.testing.assert_array_equal(recompute.numpy(), want)
    if sort_by:  # categories never decrease until a special token
        C = tm.tokenizer.N_var_per_element
        for row in np.asarray(jm.sample_ids(params, jax.random.PRNGKey(0), B, sampling=js)):
            cats = row.reshape(-1, C)[:, 0]
            real = cats[cats < tm.tokenizer.N_category]
            assert (np.diff(real) >= 0).all()
    # random sampling: one stream gives the same tokens either way
    a = tm.sample_ids(torch.Generator().manual_seed(3), B, cond=tc, sampling=TSampling())
    b = tm.sample_ids(torch.Generator().manual_seed(3), B, cond=tc, sampling=TSampling(),
                      use_cache=False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bart_reference_converter_matches_jax(pairs):
    """A reference state dict under the reference's keys (decoder layers
    of torch's TransformerDecoderLayer, cross-attention in_proj packed)
    through the JAX converter and the port's: the same logits."""
    jm, _, tm = pairs[None]
    bb = tm.backbone_cfg
    L, D = bb.num_layers, bb.d_model
    ref = encdec_to_reference_state_dict(tm.net.state_dict(), L, D, prefix="model.module.")
    assert ref["model.module.decoder.layers.0.multihead_attn.in_proj_weight"].shape == (3 * D, D)
    sd = convert_categorical_encdec_transformer(ref, L, D, prefix="model.module.")
    assert set(sd) == set(tm.net.state_dict())
    jparams = jax_convert_encdec(ref, L, D, prefix="model.module.")
    rs = np.random.RandomState(7)
    enc = rs.randint(0, tm.num_classes, (3, tm.seq_len))
    dec = rs.randint(0, tm.num_classes, (3, tm.seq_len - 1))
    want = np.asarray(jm.net.apply({"params": jparams}, jnp.asarray(enc), jnp.asarray(dec)))
    other = build_model(tconfigs.build_train_config("bart", "synthetic", TINY), device="cpu")
    other.net.load_state_dict(sd)
    with torch.no_grad():
        got = other.net(torch.as_tensor(enc), torch.as_tensor(dec)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


def test_bart_jax_job_reads_into_a_port_job(tmp_path, pairs):
    jm, params, _ = pairs[None]
    jcfg = jax_build_train_config("bart", "synthetic", TINY)
    jdir = str(tmp_path / "jax")
    jax_ckpt.save_config(jcfg, jdir)
    jax_ckpt.save_params(params, jdir, "best")
    cfg, sd, aux = load_jax_job(jdir, str(tmp_path / "port"))
    assert aux is None
    cfg2, sd2 = load_job(str(tmp_path / "port"))
    model = build_model(cfg2, device="cpu")
    model.net.load_state_dict(sd2)
    rs = np.random.RandomState(8)
    enc = rs.randint(0, model.num_classes, (2, model.seq_len))
    dec = rs.randint(0, model.num_classes, (2, model.seq_len - 1))
    want = np.asarray(jm.net.apply({"params": params}, jnp.asarray(enc), jnp.asarray(dec)))
    with torch.no_grad():
        got = model.net(torch.as_tensor(enc), torch.as_tensor(dec)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


def test_bart_decay_groups_equal_the_jax_mask(pairs):
    jm, params, tm = pairs[None]
    got = decayed_parameter_names(tm.net)
    assert set(got) == jax_decayed_names(params)
    assert "dec0.cross_attn.kv.weight" in got and not any("norm3" in n for n in got)
