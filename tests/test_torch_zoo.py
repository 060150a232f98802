"""The port's baseline zoo (MaskGIT, BLT, RUITE, the autoregressive
LayoutTransformer, VQDiffusion) held against the JAX package on the same
weights: the vanilla transition, masked, causal and dropped-out attention,
each family's loss on the same masked input (the JAX draws handed to the
port), each decode token-identical under deterministic sampling, the KV
cache against the recompute decode (`test_torch_zoo_cli.py` trains and
samples every family through the CLIs)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu import tasks as jtasks
from layoutdm_tpu.configs import SamplingConfig
from layoutdm_tpu.configs import build_train_config as jax_build_train_config
from layoutdm_tpu.factory import build_model as jax_build_model
from layoutdm_tpu.models.base import SeqLenState as JaxSeqLenState
from layoutdm_tpu.models.base import cross_entropy as jax_cross_entropy
from layoutdm_tpu.models.diffusion.loss import LtState as JaxLtState
from layoutdm_tpu.models.diffusion.loss import diffusion_loss as jax_diffusion_loss
from layoutdm_tpu.models.diffusion.vanilla import VanillaQ as JaxVanillaQ
from layoutdm_tpu.models.maskgit import mask_schedule as jax_mask_schedule
from layoutdm_tpu.ops.samplers import gumbel_noise as jax_gumbel_noise
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.configs import SamplingConfig as TSampling
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.models.base import Draws, SeqLenState, cross_entropy
from layoutdm_tpu_torch.models.diffusion.loss import LtState, diffusion_loss
from layoutdm_tpu_torch.models.diffusion.vanilla import VanillaQ
from layoutdm_tpu_torch.models.maskgit import mask_schedule
from layoutdm_tpu_torch.models.nn import Dropout
from layoutdm_tpu_torch.utils.params import params_from_flax
from torch_port_helpers import cond_to_port, layout_batch

LOSS_TOL = 1e-5  # float32 losses on the same weights and masks
LOGIT_TOL = 1e-5
# the vanilla transition in log space: 1e-6 absolute, or relative where
# the float32 step of a value near the -70 floor (7.6e-6) exceeds it
LOG_TOL = 1e-6
# the posterior adds and subtracts terms near that floor, whose float32
# step (7.6e-6) bounds the agreement of two exp/log implementations (seen:
# 1.9e-6 at a value of -0.39)
POSTERIOR_TOL = 1e-5
ZOO_TINY = ["dataset.max_seq_length=5", "data.bbox_quantization=linear",
            "backbone.d_model=64", "backbone.nhead=2", "backbone.dim_feedforward=64",
            "backbone.num_layers=2", "model.num_timesteps=10", "backbone.diffusion_step=10"]


def zoo_pair(experiment, seed=0):
    """(jax model, jax params, port model on the CPU) on the same weights,
    each built by its own package's factory from the same overrides."""
    jcfg = jax_build_train_config(experiment, "synthetic", ZOO_TINY)
    tcfg = tconfigs.build_train_config(experiment, "synthetic", ZOO_TINY)
    jm = jax_build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    tm.net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def pairs():
    return {e: zoo_pair(e) for e in ("maskgit", "blt", "ruite", "autoreg", "vqdiffusion")}


def _batch(tm, B, seed):
    return layout_batch(np.random.RandomState(seed), B, 5, tm.tokenizer.N_category)


# -- the vanilla transition (VQDiffusion) ---------------------------------------


def _vanilla(V=12, T=10):
    return JaxVanillaQ(V, T), VanillaQ(V, T, device="cpu")


def test_vanilla_q_pred_and_one_step_match_jax():
    jq, tq = _vanilla()
    x = np.log(np.random.RandomState(0).dirichlet(np.ones(12), (3, 7))).astype(np.float32)
    for t in ([0, 9, 4], [-1, 3, 9]):
        want = np.asarray(jq.q_pred(jnp.asarray(x), jnp.asarray(t)))
        got = tq.q_pred(torch.as_tensor(x), torch.as_tensor(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=LOG_TOL, atol=LOG_TOL)
        t1 = np.abs(t)
        want = np.asarray(jq.q_pred_one_timestep(jnp.asarray(x), jnp.asarray(t1)))
        got = tq.q_pred_one_timestep(torch.as_tensor(x), torch.as_tensor(t1)).numpy()
        np.testing.assert_allclose(got, want, rtol=LOG_TOL, atol=LOG_TOL)


@pytest.mark.parametrize("t", [[9, 0, 5, 1], [0, 0, 0, 0], [3, 9, 1, 7]])
def test_vanilla_q_posterior_ids_matches_jax(t):
    jq, tq = _vanilla()
    rs = np.random.RandomState(sum(t))
    x0 = np.log(rs.dirichlet(np.ones(12), (4, 6))).astype(np.float32)
    xt = rs.randint(0, 12, (4, 6))
    xt[:, 0] = 11  # MASK rows
    want = np.asarray(jq.q_posterior_ids(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t)))
    got = tq.q_posterior_ids(torch.as_tensor(x0), torch.as_tensor(xt), torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=POSTERIOR_TOL)
    # the ids form equals the dense posterior on the one-hot x_t
    dense = np.asarray(jq.q_posterior(jnp.asarray(x0), jax.nn.one_hot(xt, 12) * 0
                                      + jnp.log(jax.nn.one_hot(xt, 12) + 1e-30), jnp.asarray(t)))
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-5)


def test_vanilla_corrupt_matches_jax_with_its_gumbel_noise():
    jq, tq = _vanilla()
    seq = np.random.RandomState(1).randint(0, 11, (5, 6))
    t = np.array([0, 2, 5, 8, 9])
    key = jax.random.PRNGKey(3)
    _, want = jq.corrupt(key, jnp.asarray(seq), jnp.asarray(t))
    noise = np.asarray(jax_gumbel_noise(key, (5, 6, 12), jnp.float32))
    got = tq.corrupt(torch.as_tensor(seq), torch.as_tensor(t), noise=torch.as_tensor(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vqdiffusion_loss_matches_jax(pairs):
    jm, params, tm = pairs["vqdiffusion"]
    assert isinstance(tm.q, VanillaQ)
    seq = tm.tokenizer.encode(_batch(tm, 8, 2))["seq"]
    rs = np.random.RandomState(3)
    t = np.concatenate([[0, 0, 4], rs.randint(0, 10, 5)])
    pt = rs.uniform(0.05, 0.2, 8).astype(np.float32)
    _, xt = jm.q.corrupt(jax.random.PRNGKey(4), jnp.asarray(seq.numpy()), jnp.asarray(t))
    h = rs.uniform(0, 2, 10).astype(np.float32)
    c = rs.randint(0, 30, 10).astype(np.float32)
    want, want_lt, _ = jax_diffusion_loss(
        jm.q, lambda p, ids, tt, rng: jm._predict_start(p, ids, tt, None), params,
        jax.random.PRNGKey(0), jnp.asarray(seq.numpy()), JaxLtState(jnp.asarray(h), jnp.asarray(c)),
        0.1, True, t=jnp.asarray(t), pt=jnp.asarray(pt), xt=xt,
    )
    got, got_lt = diffusion_loss(tm.q, tm._predict_start, seq,
                                 LtState(torch.as_tensor(h), torch.as_tensor(c)),
                                 t=torch.as_tensor(t), pt=torch.as_tensor(pt),
                                 xt=torch.as_tensor(np.asarray(xt)))
    for k in ("kl_loss", "aux_loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_TOL)
    np.testing.assert_allclose(got_lt.history.numpy(), np.asarray(want_lt.history), rtol=1e-5)


@pytest.mark.parametrize("task", ["unconditional", "c", "partial"])
def test_vqdiffusion_deterministic_chain_token_identical(pairs, task):
    jm, params, tm = pairs["vqdiffusion"]
    B = 4
    js = SamplingConfig(name="deterministic")
    if task == "unconditional":
        jc = jtasks.to_sampler_cond(None, jm.tokenizer, js, batch_size=B)
    else:
        jc = jtasks.to_sampler_cond(
            jtasks.get_cond(jax.random.PRNGKey(1), _batch(tm, B, 5), jm.tokenizer, task),
            jm.tokenizer, js)
    want = np.asarray(jm.sample_ids(params, jax.random.PRNGKey(0), B, cond=jc, sampling=js))
    got = tm.sample_ids(torch.arange(B), B, cond=cond_to_port(jc),
                        sampling=TSampling(name="deterministic"))
    np.testing.assert_array_equal(got.numpy(), want)


# -- attention: masks, the causal mask, dropout ---------------------------------


def _capture_dropout(seed):
    """A flax interceptor that applies keep-masks drawn from a numpy seed
    at every Dropout call (rate > 0), and the list of those masks in call
    order, for the port's `Dropout(masks=...)`."""
    rs, masks = np.random.RandomState(seed), []

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, fnn.Dropout) and context.method_name == "__call__" and mod.rate > 0:
            x = args[0]
            keep = rs.rand(*x.shape) < 1.0 - mod.rate
            masks.append(keep)
            return jnp.where(keep, x / (1.0 - mod.rate), 0.0).astype(x.dtype)
        return next_fun(*args, **kwargs)

    return intercept, masks


@pytest.mark.parametrize("family", ["maskgit", "autoreg"])
def test_masked_and_causal_attention_with_dropout_match_flax(pairs, family):
    """MaskGIT's key-padding mask and the autoregressive causal mask, in
    evaluation and in training with flax's dropout masks (embedding,
    attention probabilities, residuals, FFN hidden) handed to the port."""
    jm, params, tm = pairs[family]
    rs = np.random.RandomState(8)
    B, S = 3, (tm.seq_len if family == "maskgit" else tm.gen_len)
    seq = rs.randint(0, tm.num_classes, (B, S))
    pad = rs.rand(B, S) < 0.3 if family == "maskgit" else None
    jargs = (jnp.asarray(seq), None, None if pad is None else jnp.asarray(pad))
    targs = dict(key_padding_mask=None if pad is None else torch.as_tensor(pad))
    want = np.asarray(jm.net.apply({"params": params}, *jargs))
    with torch.no_grad():
        got = tm.net(torch.as_tensor(seq), None, **targs).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    if family == "autoreg":  # a later token never moves an earlier logit
        seq2 = seq.copy()
        seq2[:, S // 2:] = (seq2[:, S // 2:] + 1) % tm.num_classes
        with torch.no_grad():
            got2 = tm.net(torch.as_tensor(seq2), None).numpy()
        np.testing.assert_array_equal(got2[:, : S // 2], got[:, : S // 2])

    intercept, masks = _capture_dropout(9)
    with fnn.intercept_methods(intercept):
        want = np.asarray(jm.net.apply({"params": params}, *jargs, deterministic=False,
                                       rngs={"dropout": jax.random.PRNGKey(0)}))
    # embedding + 4 sites per layer, the attention probabilities (B, H, S, S) among them
    assert len(masks) == 1 + 4 * 2 and masks[1].shape == (B, 2, S, S)
    got = tm.net(torch.as_tensor(seq), None, Dropout(masks=masks), **targs)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGIT_TOL, rtol=0)


def test_attention_dropout_is_seeded_and_differentiable():
    """Attention dropout in training draws its probability masks from the
    generator (one seed, one result) and backpropagates through them."""
    _, params, tm = zoo_pair("maskgit", seed=2)
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, tm.num_classes, (2, tm.seq_len)))
    a = tm.net(ids, None, Dropout(torch.Generator().manual_seed(0)))
    b = tm.net(ids, None, Dropout(torch.Generator().manual_seed(0)))
    c = tm.net(ids, None, Dropout(torch.Generator().manual_seed(1)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # seeded
    assert (a - c).abs().max() > 1e-3
    a.sum().backward()  # differentiable through the probability dropout
    assert tm.net.backbone.layers[0].attn.qkv.weight.grad is not None


# -- each family's loss on the same masked input --------------------------------


def test_shared_pieces_match_jax():
    rs = np.random.RandomState(10)
    logits = rs.randn(3, 7, 11).astype(np.float32)
    tgt = rs.randint(0, 11, (3, 7))
    m = rs.rand(3, 7) < 0.6
    for ls in (0.0, 0.1):
        want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(tgt), jnp.asarray(m), ls))
        got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(tgt), torch.as_tensor(m), ls)
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    r = rs.rand(6).astype(np.float32)
    for name in ("linear", "cosine", "square", "cubic", "sqrt", "log", "exp"):
        want = np.asarray(jax_mask_schedule(jnp.asarray(r), name, total_unknown=25))
        np.testing.assert_allclose(mask_schedule(torch.as_tensor(r), name, 25).numpy(), want,
                                   rtol=1e-6)
    jst = JaxSeqLenState.init(5)
    st = SeqLenState.init(5, "cpu")
    elem = np.arange(5)[None] < rs.randint(1, 6, (9, 1))
    for _ in range(3):
        jst, st = jst.update(jnp.asarray(elem)), st.update(torch.as_tensor(elem))
    np.testing.assert_allclose(st.probs.numpy(), np.asarray(jst.probs), rtol=1e-6)
    # the element-count draw is jax.random.categorical: argmax(log p + Gumbel)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jst.sample(key, 16))
    g = np.asarray(jax.random.gumbel(key, (16, 5)))
    got = st.sample(16, Draws(injected={"seq_len": [g]}))
    np.testing.assert_array_equal(got.numpy(), want)


def test_maskgit_loss_matches_jax(pairs):
    jm, params, tm = pairs["maskgit"]
    batch = _batch(tm, 6, 12)
    rng = jax.random.PRNGKey(13)
    r_ratio, r_mask, _ = jax.random.split(rng, 3)
    B, S = 6, tm.seq_len
    jtok = jm.preprocess(batch)
    want, want_st = jm.loss(params, rng, jtok, jm.init_state(), is_train=False)
    draws = Draws(injected={"ratio": [np.asarray(jax.random.uniform(r_ratio, (B,)))],
                            "mask": [np.asarray(jax.random.uniform(r_mask, (B, S)))]})
    tok = tm.preprocess(batch)
    got, st = tm.loss(tok, tm.init_state(), draws, is_train=False)
    np.testing.assert_allclose(got["nll_loss"].item(), float(want["nll_loss"]), rtol=LOSS_TOL)
    # training updates the element-count histogram as the JAX package does
    _, st = tm.loss(tok, tm.init_state(), torch.Generator().manual_seed(0))
    want_st = jm.init_state().update(jtok["elem_mask"])
    np.testing.assert_allclose(st.probs.numpy(), np.asarray(want_st.probs), rtol=1e-6)


def test_blt_loss_matches_jax(pairs):
    jm, params, tm = pairs["blt"]
    batch = _batch(tm, 6, 14)
    rng = jax.random.PRNGKey(15)
    r_grp, r_cnt, r_scores, _ = jax.random.split(rng, 4)
    B, S = 6, tm.seq_len
    want, _ = jm.loss(params, rng, jm.preprocess(batch), jm.init_state(), is_train=False)
    draws = Draws(injected={
        "group": [np.asarray(jax.random.randint(r_grp, (B,), 0, 3))],
        "count": [np.asarray(jax.random.uniform(r_cnt, (B,)))],
        "scores": [np.asarray(jax.random.uniform(r_scores, (B, S)))],
    })
    got, _ = tm.loss(tm.preprocess(batch), tm.init_state(), draws, is_train=False)
    np.testing.assert_allclose(got["nll_loss"].item(), float(want["nll_loss"]), rtol=LOSS_TOL)


@pytest.mark.parametrize("family", ["ruite", "autoreg"])
def test_ruite_and_autoreg_losses_match_jax(pairs, family):
    jm, params, tm = pairs[family]
    batch = _batch(tm, 6, 16)
    if family == "ruite":  # the loader's AddNoiseToBBox output
        batch["bbox_orig"] = batch["bbox"]
        batch["bbox"] = np.clip(batch["bbox"] + 0.05 * np.random.RandomState(17).randn(
            *batch["bbox"].shape).astype(np.float32), 0, 1)
    jtok = jm.preprocess(batch)
    tok = tm.preprocess(batch)
    for k in jtok:
        np.testing.assert_array_equal(tok[k].numpy(), np.asarray(jtok[k]))
    want, _ = jm.loss(params, jax.random.PRNGKey(0), jtok, jm.init_state(), is_train=False)
    got, _ = tm.loss(tok, tm.init_state(), None, is_train=False)
    np.testing.assert_allclose(got["nll_loss"].item(), float(want["nll_loss"]), rtol=LOSS_TOL)


# -- each family's decode --------------------------------------------------------


def _cond(jm, tm, task, B, seed, model_type):
    js = SamplingConfig(name="deterministic")
    c = jtasks.get_cond(jax.random.PRNGKey(seed), _batch(tm, B, seed), jm.tokenizer, task,
                        model_type=model_type)
    return jtasks.to_sampler_cond(c, jm.tokenizer, js)


@pytest.mark.parametrize("family,task,T", [
    ("maskgit", "c", 4), ("maskgit", "partial", 5), ("blt", "c", 6), ("blt", "cwh", 3),
    ("ruite", "refinement", None),
])
def test_decode_token_identical(pairs, family, task, T):
    jm, params, tm = pairs[family]
    if family != "ruite":
        jm.use_gumbel_noise = tm.use_gumbel_noise = False
    B = 5
    jc = _cond(jm, tm, task, B, 18, family)
    js, ts = SamplingConfig(name="deterministic"), TSampling(name="deterministic")
    want = np.asarray(jm.sample_ids(params, jax.random.PRNGKey(0), B, cond=jc, sampling=js,
                                    num_timesteps_eval=T))
    got = tm.sample_ids(torch.Generator().manual_seed(0), B, cond=cond_to_port(jc),
                        sampling=ts, num_timesteps_eval=T)
    np.testing.assert_array_equal(got.numpy(), want)
    if family != "ruite":
        assert (want != tm.tokenizer.name_to_id("mask")).all()  # every slot decoded


def test_unconditional_maskgit_with_injected_draws_matches_jax(pairs):
    """The element counts drawn from the state's histogram (the JAX
    package's categorical draw as argmax(log p + Gumbel)), then the
    deterministic decode."""
    jm, params, tm = pairs["maskgit"]
    jm.use_gumbel_noise = tm.use_gumbel_noise = False
    B = 6
    probs = np.random.RandomState(19).dirichlet(np.ones(5)).astype(np.float32)
    js = SamplingConfig(name="deterministic")
    key = jax.random.PRNGKey(20)
    want = np.asarray(jm.sample_ids(params, key, B, sampling=js,
                                    state=JaxSeqLenState(jnp.asarray(probs)),
                                    num_timesteps_eval=4))
    _, r_n = jax.random.split(key)
    draws = Draws(injected={"seq_len": [np.asarray(jax.random.gumbel(r_n, (B, 5)))]})
    got = tm.sample_ids(draws, B, sampling=TSampling(name="deterministic"),
                        state=SeqLenState(torch.as_tensor(probs)), num_timesteps_eval=4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("task", ["c", "unconditional"])
def test_autoreg_decode_cached_equals_recompute_and_jax(pairs, task):
    jm, params, tm = pairs["autoreg"]
    B = 4
    js, ts = SamplingConfig(name="deterministic"), TSampling(name="deterministic")
    jc = None if task == "unconditional" else _cond(jm, tm, task, B, 21, "autoreg")
    tc = None if jc is None else cond_to_port(jc)
    want = np.asarray(jm.sample_ids(params, jax.random.PRNGKey(0), B, cond=jc, sampling=js))
    cached = tm.sample_ids(None, B, cond=tc, sampling=ts)
    recompute = tm.sample_ids(None, B, cond=tc, sampling=ts, use_cache=False)
    np.testing.assert_array_equal(cached.numpy(), recompute.numpy())
    np.testing.assert_array_equal(cached.numpy(), want)
    # random sampling: the same stream gives the same tokens either way
    a = tm.sample_ids(torch.Generator().manual_seed(3), B, cond=tc, sampling=TSampling())
    b = tm.sample_ids(torch.Generator().manual_seed(3), B, cond=tc, sampling=TSampling(),
                      use_cache=False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_masked_calls_never_reach_the_kernels(pairs, monkeypatch):
    """A masked call (key padding, causal) and attention dropout take the
    plain path; the mask-free inference call still reaches K1."""
    import layoutdm_tpu_torch.models.nn as nn_mod

    calls = []
    real = nn_mod.fused_attention_qkv
    monkeypatch.setattr(nn_mod, "fused_attention_qkv",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, _, tm = pairs["maskgit"]
    ids = torch.zeros((2, tm.seq_len), dtype=torch.long)
    with torch.no_grad():
        tm.net(ids, None, key_padding_mask=ids == 1)
        pairs["autoreg"][2].net(ids[:, : pairs["autoreg"][2].gen_len], None)
        assert not calls
        tm.net(ids, None)
    assert calls
