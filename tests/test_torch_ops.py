"""Port ops held against the JAX package: log-space math, token samplers
with injected Gumbel noise, masking — plus the port's import hygiene."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu.ops import log_math as jlm
from layoutdm_tpu.ops import masking as jmask
from layoutdm_tpu.ops import samplers as jsamp
from layoutdm_tpu_torch.ops import log_math as tlm
from layoutdm_tpu_torch.ops import masking as tmask
from layoutdm_tpu_torch.ops import samplers as tsamp

LOG_TOL = 1e-5

REPO = Path(__file__).resolve().parents[1]


def test_log_add_exp_matches_jax_including_both_minus_inf(rng):
    a = rng.randn(64).astype(np.float32) * 30
    b = rng.randn(64).astype(np.float32) * 30
    a[:4] = -np.inf
    b[:2] = -np.inf  # lanes 0-1: both -inf
    want = np.asarray(jlm.log_add_exp(jnp.asarray(a), jnp.asarray(b)))
    got = tlm.log_add_exp(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=LOG_TOL)
    assert not np.isnan(got).any()


def test_log_onehot_matches_jax(rng):
    ids = rng.randint(0, 11, (3, 7))
    want = np.asarray(jlm.log_onehot(jnp.asarray(ids), 11))
    got = tlm.log_onehot(torch.as_tensor(ids), 11).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T,N", [(100, 155), (10, 9), (4, 33)])
def test_schedule_tables_identical(T, N):
    jt = jlm.ScheduleTables(T, N).stacked()
    tt = tlm.ScheduleTables(T, N).stacked()
    assert jt.keys() == tt.keys()
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k])


def test_posterior_tail_matches_jax(rng):
    """The shared Eq.5 tail, with the same (linear) q_pred on both sides."""
    B, S, V = 2, 6, 9
    x0 = np.log(rng.dirichlet(np.ones(V), (B, S))).astype(np.float32)
    qt = rng.randn(B, S, V - 1).astype(np.float32) - 3
    qt1 = rng.randn(B, S, V).astype(np.float32) - 3
    valid = rng.rand(1, 1, V - 1) > 0.2
    t = np.array([3, 0])
    shift = rng.randn(V).astype(np.float32) * 0.1

    def jq(q, tt):
        return q + jnp.asarray(shift) + tt[:, None, None].astype(jnp.float32)

    def tq(q, tt):
        return q + torch.as_tensor(shift) + tt[:, None, None].float()

    want = jlm.posterior_tail(jq, jnp.asarray(x0), jnp.asarray(qt),
                              jnp.asarray(qt1), jnp.asarray(t), jnp.asarray(valid))
    got = tlm.posterior_tail(tq, torch.as_tensor(x0), torch.as_tensor(qt),
                             torch.as_tensor(qt1), torch.as_tensor(t),
                             torch.as_tensor(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOG_TOL)


@pytest.mark.parametrize(
    "name", ["deterministic", "random", "gumbel", "top_k", "top_p", "top_k_top_p"]
)
def test_sample_tokens_exact_with_injected_noise(name):
    """JAX's sampler equals the port's given JAX's own Gumbel draws: the
    categorical draw is `jax.random.gumbel(key)`, the gumbel strategy's
    extra layer is `gumbel_noise(sub)`."""
    rs = np.random.RandomState(3)
    logits = (rs.randn(4, 7, 23) * 2).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jsamp.sample_tokens(key, jnp.asarray(logits), name=name,
                                          temperature=0.8, top_k=4, top_p=0.7))
    draws = []
    if name == "gumbel":
        key, sub = jax.random.split(key)
        draws.append(jsamp.gumbel_noise(sub, logits.shape))
    if name != "deterministic":
        draws.append(jax.random.gumbel(key, logits.shape, jnp.float32))
    noise = torch.as_tensor(np.stack([np.asarray(d) for d in draws])) if draws else None
    got = tsamp.sample_tokens(torch.as_tensor(logits), name=name, temperature=0.8,
                              top_k=4, top_p=0.7, noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_noise_construction_matches_jax():
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, (50,)))
    want = np.asarray(jsamp.gumbel_noise(key, (50,)))
    got = tsamp.gumbel_from_uniform(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_top_p_filter_matches_jax_with_ties():
    logits = np.array([[1.0, 3.0, 3.0, 0.5, -2.0, 3.0]], np.float32)
    for p in (0.1, 0.5, 0.95):
        want = np.asarray(jsamp.top_p_filter(jnp.asarray(logits), p))
        got = tsamp.top_p_filter(torch.as_tensor(logits), p).numpy()
        np.testing.assert_array_equal(got, want)


def test_row_noise_depends_only_on_row_seed():
    seeds = torch.tensor([5, 9, 2**32 - 1, 0])
    a = tsamp.row_uniform(seeds, counter=3, n=1000)
    b = tsamp.row_uniform(torch.tensor([7, 9, 1, 5]), counter=3, n=1000)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    torch.testing.assert_close(a[0], b[3], rtol=0, atol=0)
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], tsamp.row_uniform(seeds, counter=4, n=1000)[0])
    assert (a > 0).all() and (a < 1).all()
    # roughly uniform: mean and variance of 4000 draws
    assert abs(a.mean().item() - 0.5) < 0.02
    assert abs(a.var().item() - 1 / 12) < 0.01


def test_batch_topk_mask_matches_jax(rng):
    scores = rng.rand(6, 9).astype(np.float32)
    mask = rng.rand(6, 9) > 0.3
    topk = np.array([0, 1, 3, 9, 20, 2])
    jo, jk = jmask.batch_topk_mask(jnp.asarray(scores), jnp.asarray(topk),
                                   mask=jnp.asarray(mask))
    to, tk = tmask.batch_topk_mask(torch.as_tensor(scores), torch.as_tensor(topk),
                                   mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_sample_mask_matches_jax_with_injected_scores():
    key = jax.random.PRNGKey(2)
    mask = np.random.RandomState(1).rand(5, 12) > 0.25
    ratio = np.array([0.0, 0.3, 0.5, 0.9, 1.0], np.float32)
    want = np.asarray(jmask.sample_mask(key, jnp.asarray(mask), jnp.asarray(ratio)))
    scores = np.asarray(jax.random.uniform(key, mask.shape))
    got = tmask.sample_mask(torch.as_tensor(mask), torch.as_tensor(ratio),
                            scores=torch.as_tensor(scores))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("what", ["package", "chip_smoke", "kernel_checks", "profile_chain",
                                  "compare_kernels", "compare_end_to_end"])
def test_port_imports_no_jax(what):
    """Every module of the port, and each of the port's scripts (imported,
    not run), imports in a fresh interpreter without loading jax, flax,
    optax or msgpack (the GPU host has none) or any module of the JAX
    package: the port keeps its own copies."""
    if what == "package":
        pkg = REPO / "layoutdm_tpu_torch"
        mods = sorted(
            ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
            for p in pkg.rglob("*.py")
        )
        assert "layoutdm_tpu_torch.serve_cli" in mods and len(mods) >= 30
        assert {"layoutdm_tpu_torch.utils.profiling", "layoutdm_tpu_torch.models.int8_serving",
                "layoutdm_tpu_torch.parallel", "layoutdm_tpu_torch.parallel.mesh",
                "layoutdm_tpu_torch.parallel.tp", "layoutdm_tpu_torch.clustering_cli",
                "layoutdm_tpu_torch.graft_entry", "layoutdm_tpu_torch.demo"} <= set(mods)
        assert {f"layoutdm_tpu_torch.bench.{m}" for m in (
            "common", "flops", "headline", "train", "serve", "zoo", "e2e_bigshape",
            "profile_trace", "int8")} <= set(mods)
    else:
        mods = [what]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'layoutdm_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
