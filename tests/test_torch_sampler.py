"""Constrained posterior, task conditions and the reverse chain, held against
the JAX package.  The deterministic chain is token-identical for every
task; the per-row noise regime keeps a row's sample independent of its
batch-mates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu import tasks as jtasks
from layoutdm_tpu.configs import SamplingConfig
from layoutdm_tpu.models.diffusion.constrained import ConstrainedQ as JaxQ
from layoutdm_tpu.models.diffusion.sampler import (
    make_predict_start as jax_make_predict_start,
)
from layoutdm_tpu.models.diffusion.sampler import timestep_ladder as jax_ladder
from layoutdm_tpu_torch import tasks as ttasks
from layoutdm_tpu_torch.configs import SamplingConfig as TSampling
from layoutdm_tpu_torch.models.diffusion.constrained import ConstrainedQ
from layoutdm_tpu_torch.models.diffusion.sampler import (
    SamplerCond,
    make_predict_start,
    sample_chain,
    timestep_ladder,
)

from torch_port_helpers import (
    cond_to_port,
    layout_batch,
    layoutdm_pair,
    tokenizers,
)

POSTERIOR_TOL = 1e-4
TASKS = ["unconditional", "c", "cwh", "partial", "refinement"]


@pytest.fixture(scope="module")
def pair():
    return layoutdm_pair(seed=0)


@pytest.mark.parametrize(
    "T,T_eval,td", [(100, None, 0.0), (100, 25, 0.0), (100, 7, 0.0), (10, 10, 0.2), (50, 13, 0.1)]
)
def test_timestep_ladder_identical(T, T_eval, td):
    jm, jp = jax_ladder(T, T_eval, td)
    tm, tp = timestep_ladder(T, T_eval, td)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tp, jp)


def _qs(T=10):
    jt, tt = tokenizers()
    return JaxQ(jt, T), ConstrainedQ(tt, T, device="cpu")


def test_q_pred_matches_jax_including_wraparound():
    jq, tq = _qs()
    rs = np.random.RandomState(0)
    x = np.log(rs.dirichlet(np.ones(tq.Vp), (2, 5, tq.A))).astype(np.float32)
    for t in ([0, 9], [-1, 4]):
        want = np.asarray(jax.jit(jq.q_pred)(jnp.asarray(x), jnp.asarray(t)))
        got = tq.q_pred(torch.as_tensor(x), torch.as_tensor(t)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        want1 = np.asarray(
            jax.jit(jq.q_pred_one_timestep)(jnp.asarray(x), jnp.asarray(np.abs(t)))
        )
        got1 = tq.q_pred_one_timestep(torch.as_tensor(x), torch.as_tensor(np.abs(t))).numpy()
        np.testing.assert_allclose(got1, want1, atol=1e-5)


@pytest.mark.parametrize("t", [[9, 0, 5], [0, 0, 0], [3, 9, 1]])
def test_q_posterior_ids_matches_jax(t):
    jq, tq = _qs()
    rs = np.random.RandomState(sum(t))
    B, S_tok = 3, 25
    x0 = np.log(rs.dirichlet(np.ones(tq.Vf), (B, S_tok))).astype(np.float32)
    ids = rs.randint(0, tq.Vf, (B, S_tok))
    ids[:, ::3] = tq.mask_id  # plenty of MASK observations
    want = np.asarray(
        jax.jit(jq.q_posterior_ids)(jnp.asarray(x0), jnp.asarray(ids), jnp.asarray(t))
    )
    got = tq.q_posterior_ids(torch.as_tensor(x0), torch.as_tensor(ids), torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), want, atol=POSTERIOR_TOL)


def test_predict_start_matches_jax():
    rs = np.random.RandomState(1)
    logits = (rs.randn(2, 5, 12) * 5).astype(np.float32)
    want = np.asarray(jax_make_predict_start(
        lambda p, i, t, r: jnp.asarray(logits), 12)(None, None, None))
    got = make_predict_start(lambda i, t: torch.as_tensor(logits), 12)(None, None)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("task", ["c", "cwh", "gt", "partial", "refinement", "random"])
def test_get_cond_and_lowering_match_jax(task):
    """Task conds are identical given the same random draws (JAX's own
    draws, injected)."""
    jt, tt = tokenizers()
    rs = np.random.RandomState(4)
    B = 6
    batch = layout_batch(rs, B)
    key = jax.random.PRNGKey(9)
    jc = jtasks.get_cond(key, batch, jt, task)
    noise = {}
    if task == "partial":
        r_scores, r_topk = jax.random.split(key)
        noise = {"scores": jax.random.uniform(r_scores, (B, tt.max_elements)),
                 "topk": jax.random.randint(r_topk, (B,), 1, 10_000)}
    elif task == "refinement":
        noise = {"bbox": jax.random.normal(key, batch["bbox"].shape)}
    elif task == "random":
        r_ratio, r_mask = jax.random.split(key)
        noise = {"ratio": jax.random.uniform(r_ratio, (B,)),
                 "scores": jax.random.uniform(r_mask, (B, tt.max_token_length))}
    tc = ttasks.get_cond(batch, tt, task, noise=noise)
    assert set(tc) == set(jc)
    for k in jc:
        if k == "type":
            assert tc[k] == jc[k]
        else:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)

    js = SamplingConfig(name="random")
    jl = jtasks.to_sampler_cond(jc, jt, js)
    tl = ttasks.to_sampler_cond(tc, tt, TSampling(name="random"))
    for k in SamplerCond.TENSORS:
        np.testing.assert_array_equal(getattr(tl, k).numpy(), np.asarray(getattr(jl, k)), err_msg=k)
    assert tl.init_from_seq == jl.init_from_seq


@pytest.mark.parametrize("task", TASKS)
def test_deterministic_chain_token_identical(pair, task):
    jm, params, tm = pair
    rs = np.random.RandomState(5)
    B = 4
    js = SamplingConfig(name="deterministic")
    if task == "unconditional":
        jc = jtasks.to_sampler_cond(None, jm.tokenizer, js, batch_size=B)
    else:
        batch = layout_batch(rs, B)
        jc = jtasks.to_sampler_cond(
            jtasks.get_cond(jax.random.PRNGKey(1), batch, jm.tokenizer, task),
            jm.tokenizer, js,
        )
    want = np.asarray(jm.sample_ids(params, jax.random.PRNGKey(0), B, cond=jc, sampling=js))
    got = tm.sample_ids(torch.arange(B), B, cond=cond_to_port(jc),
                        sampling=TSampling(name="deterministic"))
    np.testing.assert_array_equal(got.numpy(), want)
    # a skip-step ladder too (T_eval < T)
    want = np.asarray(jm.sample_ids(params, jax.random.PRNGKey(0), B, cond=jc,
                                    sampling=js, num_timesteps_eval=4))
    got = tm.sample_ids(torch.arange(B), B, cond=cond_to_port(jc),
                        sampling=TSampling(name="deterministic"),
                        num_timesteps_eval=4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["random", "gumbel", "top_p"])
def test_per_row_noise_independent_of_batch_mates(pair, name):
    _, _, tm = pair
    rs = np.random.RandomState(6)
    jt, tt = tokenizers()
    sampling = TSampling(name=name)
    batch = layout_batch(rs, 4)
    cond = ttasks.to_sampler_cond(ttasks.get_cond(batch, tt, "c"), tt, sampling)
    seeds = torch.tensor([11, 22, 33, 44])
    a = tm.sample_ids(seeds, 4, cond=cond, sampling=sampling)
    # rows 1 and 3 keep their seed and cond; their batch-mates change
    other = ttasks.to_sampler_cond(
        ttasks.get_cond(layout_batch(np.random.RandomState(7), 4), tt, "c"), tt, sampling
    )
    mixed = SamplerCond.cat([
        SamplerCond(**{k: getattr(other, k)[:1] for k in SamplerCond.TENSORS}, init_from_seq=True),
        SamplerCond(**{k: getattr(cond, k)[1:2] for k in SamplerCond.TENSORS}, init_from_seq=True),
        SamplerCond(**{k: getattr(other, k)[2:3] for k in SamplerCond.TENSORS}, init_from_seq=True),
        SamplerCond(**{k: getattr(cond, k)[3:] for k in SamplerCond.TENSORS}, init_from_seq=True),
    ])
    b = tm.sample_ids(torch.tensor([5, 22, 7, 44]), 4, cond=mixed, sampling=sampling)
    torch.testing.assert_close(b[1], a[1], rtol=0, atol=0)
    torch.testing.assert_close(b[3], a[3], rtol=0, atol=0)
    # the same seed reproduces, another seed differs
    torch.testing.assert_close(tm.sample_ids(seeds, 4, cond=cond, sampling=sampling), a,
                               rtol=0, atol=0)
    c = tm.sample_ids(torch.tensor([12, 22, 33, 44]), 4, cond=cond, sampling=sampling)
    assert not torch.equal(c[0], a[0])


def test_generator_regime_and_decode(pair):
    _, _, tm = pair
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    out = tm.sample(g1, 3)
    again = tm.sample(g2, 3)
    for k in ("bbox", "label", "mask"):
        torch.testing.assert_close(out[k], again[k], rtol=0, atol=0)
    assert out["bbox"].shape == (3, 5, 4)
    assert ((out["bbox"] >= 0) & (out["bbox"] <= 1)).all()
    ids, steps = tm.sample_ids(torch.Generator().manual_seed(1), 2, get_intermediates=True)
    assert steps.shape == (tm.q.num_timesteps, 2, tm.seq_len)
    torch.testing.assert_close(steps[-1], ids, rtol=0, atol=0)


def test_guidance_not_ported_yet(pair):
    """The guidance hook is ported (relation guidance): it is called once
    per step with the step's model timestep, and an identity hook leaves
    the chain unchanged."""
    _, _, tm = pair
    seen = []

    def run(guidance_fn):
        return sample_chain(tm._predict_start, tm.q, torch.Generator().manual_seed(0),
                            SamplerCond.empty(2, tm.seq_len, "cpu"), TSampling(), pad_id=0,
                            guidance_fn=guidance_fn)

    with torch.no_grad():
        got = run(lambda lp, t, cond: seen.append(t) or lp)
        want = run(None)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert seen == list(range(tm.q.num_timesteps - 1, -1, -1))
