"""Relation-constrained generation held against the JAX package: the 14
penalties and their gradient, the beautify costs, the differentiable box
decode, one guidance call at the configured lambda, a guided reverse chain,
the violation rate, and the sampler's guidance hook and graph plumbing.

Tolerances.  ``relation_lambda`` is 3e6 (1e7 in the strong preset), so a
float32 gradient difference of 1e-7 between the frameworks moves a
log-prob by ~0.3.  The losses and gradients are held to float32 rounding
(rtol 1e-5); one guided update is held relative to its own size
(GUIDED_REL); a guided chain's tokens are held equal to the JAX chain's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu import tasks as jtasks
from layoutdm_tpu.configs import SamplingConfig
from layoutdm_tpu.data.transforms import compose_transform as jax_compose
from layoutdm_tpu.eval.metrics import compute_violation as jax_violation
from layoutdm_tpu.relation import const as jconst
from layoutdm_tpu.relation import guidance as jguid
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.data.relations import RelLoc, RelSize
from layoutdm_tpu_torch.eval.metrics import compute_violation
from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond, sample_chain
from layoutdm_tpu_torch.relation import const as tconst
from layoutdm_tpu_torch.relation import guidance as tguid

from torch_port_helpers import cond_to_port, layout_batch, layoutdm_pair, tokenizers

LOSS_RTOL = 1e-5
GUIDED_REL = 1e-3  # one guided update, against the largest |update|
LAMBDA = tconfigs.SamplingConfig().relation_lambda  # 3e6, the configs' default


def _graph(rs, B, S1, E):
    """Random boxes (canvas at 0) and graphs over every relation bit."""
    bbox = np.concatenate([np.tile([0.5, 0.5, 1.0, 1.0], (B, 1, 1)),
                           0.1 + 0.8 * rs.rand(B, S1 - 1, 4)], axis=1).astype(np.float32)
    src = rs.randint(0, S1 - 1, (B, E))
    dst = src + 1 + rs.randint(0, S1 - 1, (B, E)) % (S1 - 1 - src).clip(1)
    dst = np.minimum(dst, S1 - 1)
    size = rs.choice([RelSize.UNKNOWN, RelSize.SMALLER, RelSize.EQUAL, RelSize.LARGER], (B, E))
    loc = rs.choice([RelLoc.UNKNOWN, RelLoc.LEFT, RelLoc.TOP, RelLoc.RIGHT, RelLoc.BOTTOM,
                     RelLoc.CENTER], (B, E))
    attr = ((1 << size) | (1 << loc)).astype(np.int32)
    label = np.concatenate([np.zeros((B, 1)), 1 + rs.randint(0, 4, (B, S1 - 1))], 1)
    return {
        "bbox": bbox,
        "label": label.astype(np.int32),
        "edge_index": np.stack([src, dst], -1).astype(np.int32),
        "edge_attr": attr,
        "edge_mask": rs.rand(B, E) < 0.8,
    }


def _both(g):
    jr = jguid.RelationData.from_batch(g)
    tr = tguid.RelationData.from_batch(g)
    np.testing.assert_array_equal(tr.src_is_canvas.numpy(), np.asarray(jr.src_is_canvas))
    return jr, tr


def test_relation_losses_and_gradient_match_jax():
    g = _graph(np.random.RandomState(0), 4, 7, 12)
    jr, tr = _both(g)
    jloss = lambda b: jconst.relation_losses(b, *jr)
    want = np.asarray(jloss(jnp.asarray(g["bbox"])))
    bbox = torch.as_tensor(g["bbox"]).requires_grad_()
    got = tconst.relation_losses(bbox, *tr)
    assert got.shape == (4, 14) and (want > 0).sum() > 10  # most terms fire
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL, atol=1e-7)
    want_g = np.asarray(jax.grad(lambda b: jloss(b).mean())(jnp.asarray(g["bbox"])))
    (got_g,) = torch.autograd.grad(got.mean(), bbox)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=LOSS_RTOL, atol=1e-9)


def test_beautify_costs_match_jax():
    rs = np.random.RandomState(1)
    bbox = rs.rand(3, 6, 4).astype(np.float32) * 0.5 + 0.2
    mask = rs.rand(3, 6) < 0.7
    for name in ("beautify_alignment", "beautify_non_overlap"):
        want = np.asarray(getattr(jconst, name)(jnp.asarray(bbox), jnp.asarray(mask)))
        got = getattr(tconst, name)(torch.as_tensor(bbox), torch.as_tensor(mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7)


def test_compute_violation_matches_jax():
    g = _graph(np.random.RandomState(2), 5, 6, 10)
    g["edge_mask"][0] = False  # no active edge: NaN
    args = (g["bbox"], g["label"], g["edge_index"], g["edge_attr"], g["edge_mask"])
    np.testing.assert_array_equal(compute_violation(*args), jax_violation(*args))


@pytest.fixture(scope="module")
def tok():
    return tokenizers()


def _log_probs(rs, tt, B):
    lp = rs.randn(B, tt.max_token_length, tt.N_total).astype(np.float32) * 2
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


@pytest.mark.parametrize("mode", ["average", "gumbel"])
def test_expected_bbox_matches_jax(tok, mode):
    """"gumbel" with the JAX package's own draws injected."""
    jt, tt = tok
    rs = np.random.RandomState(3)
    lp = _log_probs(rs, tt, 3)
    elem_mask = rs.rand(3, tt.max_elements) < 0.8
    key = jax.random.PRNGKey(7)
    want = np.asarray(jguid.expected_bbox(jnp.asarray(lp), jt, jnp.asarray(elem_mask),
                                          mode=mode, tau=0.7, rng=key))
    gumbels = None
    if mode == "gumbel":
        shape = (3, tt.max_elements, tt.N_bbox_per_var)
        gumbels = [torch.as_tensor(np.asarray(jax.random.gumbel(
            jax.random.fold_in(key, k), shape))) for k in range(4)]
    got = tguid.expected_bbox(torch.as_tensor(lp), tt, torch.as_tensor(elem_mask),
                              mode=mode, tau=0.7, gumbels=gumbels)
    assert got.shape == (3, tt.max_elements + 1, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _jax_gumbel_source(base=jax.random.PRNGKey(0)):
    """The draws of the JAX guidance (`guidance.py:187-192` folds the step
    t, then the update k; `expected_bbox` the coordinate), for injection."""
    def gumbel(t, k, coord, shape):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(base, t), k), coord)
        return torch.as_tensor(np.asarray(jax.random.gumbel(key, shape)))
    return gumbel


@pytest.mark.parametrize("mode", ["average", "gumbel"])
def test_one_guidance_call_matches_jax(tok, mode):
    """One step's K updates at the configured lambda; below t = 10 the
    log-probs pass through unchanged."""
    jt, tt = tok
    rs = np.random.RandomState(4)
    B = 3
    batch = layout_batch(rs, B)
    graph = jax_compose(["AddCanvasElement", "AddRelationConstraints(edge_ratio=0.5, seed=0)"])(
        np.random.RandomState(0), dict(batch))
    jr, tr = _both(graph)
    seq = np.asarray(jt.encode(batch)["seq"])
    lp = _log_probs(rs, tt, B)
    js = SamplingConfig(relation_lambda=LAMBDA, relation_mode=mode)
    ts = tconfigs.SamplingConfig(relation_lambda=LAMBDA, relation_mode=mode)
    jg = jguid.make_relation_guidance(jt, js)
    tg = tguid.make_relation_guidance(
        tt, ts, gumbel=_jax_gumbel_source() if mode == "gumbel" else None)
    jcond = types.SimpleNamespace(seq=jnp.asarray(seq), relation=jr)
    tcond = types.SimpleNamespace(seq=torch.as_tensor(seq), relation=tr)
    want = np.asarray(jg(jnp.asarray(lp), 50, jcond))
    got = tg(torch.as_tensor(lp), 50, tcond).numpy()
    update = want - lp
    assert np.abs(update).max() > 1.0  # lambda 3e6 moves the log-probs a lot
    np.testing.assert_allclose(got - lp, update, rtol=0,
                               atol=GUIDED_REL * np.abs(update).max())
    assert np.array_equal(tg(torch.as_tensor(lp), 9, tcond).numpy(), lp)
    no_graph = types.SimpleNamespace(seq=torch.as_tensor(seq), relation=None)
    assert np.array_equal(tg(torch.as_tensor(lp), 50, no_graph).numpy(), lp)


@pytest.mark.parametrize("mode", ["average", "gumbel"])
def test_guided_chain_token_identical_to_jax(mode):
    """A deterministic guided chain (T = 20, guidance at t >= 10), the
    "gumbel" mode with the JAX guidance's draws injected: tokens equal."""
    jm, params, tm = layoutdm_pair(seed=2, backbone={"diffusion_step": 20}, num_timesteps=20,
                                  attn_v2=True)
    rs = np.random.RandomState(8)
    B = 4
    batch = layout_batch(rs, B)
    graph = jax_compose(["AddCanvasElement", "AddRelationConstraints(edge_ratio=0.5, seed=0)"])(
        np.random.RandomState(0), dict(batch))
    jr, tr = _both(graph)
    js = SamplingConfig(name="deterministic", relation_mode=mode)
    ts = tconfigs.SamplingConfig(name="deterministic", relation_mode=mode)
    jc = jtasks.to_sampler_cond(
        jtasks.get_cond(jax.random.PRNGKey(1), batch, jm.tokenizer, "relation"), jm.tokenizer, js)
    jc = jc.replace(relation=tuple(jr))
    tc = cond_to_port(jc)
    tc.relation = tr
    want = np.asarray(jm.sample_ids(params, jax.random.PRNGKey(0), B, cond=jc, sampling=js,
                                    guidance_fn=jguid.make_relation_guidance(jm.tokenizer, js)))
    tg = tguid.make_relation_guidance(
        tm.tokenizer, ts, gumbel=_jax_gumbel_source() if mode == "gumbel" else None)
    got = tm.sample_ids(torch.arange(B), B, cond=tc, sampling=ts, guidance_fn=tg)
    unguided = tm.sample_ids(torch.arange(B), B, cond=cond_to_port(jc), sampling=ts)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not torch.equal(got, unguided)  # the guidance changed the layouts


def test_guidance_runs_between_the_task_constraints_and_pad_suppression():
    """The hook sees the strong replacement and the weak prior applied and
    PAD not yet suppressed (`base.py:246-284`), and its output is sampled."""
    B, S, V, pad_id = 2, 4, 6, 4
    q = types.SimpleNamespace(
        num_classes=V, num_timesteps=3,
        q_posterior_ids=lambda lx, ids, t: torch.zeros((B, S, V)))
    strong = torch.zeros((B, S), dtype=torch.bool)
    strong[:, 0] = True
    cond = SamplerCond(
        seq=torch.full((B, S), 2), strong_mask=strong,
        weak_logits=torch.full((B, S, V), 0.5), weak_mask=torch.ones((B, S), dtype=torch.bool),
        pad_suppress=torch.ones((B, S), dtype=torch.bool))
    seen = []

    def guidance(lp, t, c):
        seen.append((lp.clone(), t, c))
        out = lp.clone()
        out[..., pad_id] = 10.0  # suppressed after the hook
        out[..., 1] = 5.0
        return out

    ids = sample_chain(lambda ids, t: None, q, torch.Generator(), cond,
                       tconfigs.SamplingConfig(name="deterministic"), pad_id,
                       guidance_fn=guidance)
    assert [t for _, t, _ in seen] == [2, 1, 0] and seen[0][2] is cond
    lp = seen[0][0]
    assert lp[0, 0, 2] == 0.5 and lp[0, 0, 0] < -60  # strong: log one-hot + weak
    assert lp[0, 1, 3] == 0.5  # weak prior added
    assert (ids == 1).all()


def test_relation_graphs_travel_with_their_rows():
    g = _graph(np.random.RandomState(5), 3, 5, 4)
    tr = tguid.RelationData.from_batch(g)
    a = SamplerCond.empty(3, 10, "cpu")
    a.relation = tr
    b = SamplerCond.empty(2, 10, "cpu")
    b.relation = tguid.RelationData.empty(2, 4)
    cat = SamplerCond.cat([a, b])
    assert cat.relation.edge_index.shape == (5, 4, 2)
    assert torch.equal(cat.relation.edge_attr[:3], tr.edge_attr)
    assert not cat.relation.edge_mask[3:].any()
    assert cat.to("cpu").relation.edge_mask.shape == (5, 4)
    with pytest.raises(ValueError, match="with and without relation graphs"):
        SamplerCond.cat([a, SamplerCond.empty(2, 10, "cpu")])
