"""The port's training path held against the JAX package on the same
weights and the same injected noise: the forward process, timestep
sampling, the diffusion loss and its LtState update, every parameter's
gradient, the AdamW step with clipping, embedding dropout, cluster fitting,
checkpoints and resume, and the CPU trainer end to end into a job the
port's service serves.  Sizes are the small `torch_port_helpers` ones."""

import functools
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu.configs import build_train_config
from layoutdm_tpu.data.datasets import load_dataset
from layoutdm_tpu.factory import resolve_centers as jax_resolve_centers
from layoutdm_tpu.models.diffusion.loss import LtState as JaxLtState
from layoutdm_tpu.models.diffusion.loss import diffusion_loss as jax_diffusion_loss
from layoutdm_tpu.models.diffusion.loss import sample_time as jax_sample_time
from layoutdm_tpu.ops.samplers import gumbel_noise as jax_gumbel_noise
from layoutdm_tpu.tokenizer.clustering import fit_coordinate_clusters as jax_fit
from layoutdm_tpu.train.step import decay_mask
from layoutdm_tpu.train.step import make_optimizer as jax_make_optimizer
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.factory import resolve_centers
from layoutdm_tpu_torch.models.diffusion.loss import (
    LtState,
    diffusion_loss,
    importance_weights,
    sample_time,
)
from layoutdm_tpu_torch.models.nn import Dropout
from layoutdm_tpu_torch.serve_cli import LayoutService
from layoutdm_tpu_torch.tokenizer.clustering import fit_coordinate_clusters
from layoutdm_tpu_torch.train import checkpoint as ckpt
from layoutdm_tpu_torch.train.loop import main as train_main
from layoutdm_tpu_torch.train.loop import train
from layoutdm_tpu_torch.train.step import (
    clip_by_global_norm,
    decayed_parameter_names,
    init_train_state,
    make_optimizer,
    train_step,
)
from layoutdm_tpu_torch.utils.params import load_job, params_from_flax
from torch_port_helpers import NUM_TIMESTEPS, layout_batch, layoutdm_pair

LOSS_RTOL = 1e-5  # float32 losses: logits agree to ~1e-6, sums of ~100 terms
GRAD_TOL = 1e-4  # per parameter, relative to that parameter's largest gradient
# after 3 AdamW steps of lr 1e-3 (absolute): Adam divides each gradient
# element by its own running scale, so elements whose true gradient is 0
# (the key bias, which softmax ignores) move by float noise over its norm;
# seen at 2.1e-5, bounded by 3 * lr
PARAM_TOL = 5e-5

# the tiny flagship-shaped training run of the CPU trainer tests
TINY = [
    "dataset.max_seq_length=5", "backbone.d_model=128", "backbone.nhead=2",
    "backbone.dim_feedforward=64", "backbone.num_layers=2",
    "model.num_timesteps=10", "backbone.diffusion_step=10",
    "training.sample_plot_epoch_interval=0",
]


@pytest.fixture(scope="module")
def pair():
    return layoutdm_pair(seed=0)


def _tokens(tm, B, seed):
    return tm.tokenizer.encode(layout_batch(np.random.RandomState(seed), B))["seq"]


def _injected(jm, seq, seed):
    """Repeated timesteps and t=0 rows, importance weights, and x_t drawn by
    the JAX package's own corruption."""
    rs = np.random.RandomState(seed)
    B = seq.shape[0]
    t = np.concatenate([[0, 0, 3, 3, 3], rs.randint(0, NUM_TIMESTEPS, B - 5)])
    pt = rs.uniform(0.05, 0.2, B).astype(np.float32)
    _, xt = jm.q.corrupt(jax.random.PRNGKey(seed), jnp.asarray(seq.numpy()), jnp.asarray(t))
    return t, pt, np.asarray(xt)


def _lt(seed):
    rs = np.random.RandomState(seed)
    h = rs.uniform(0, 2, NUM_TIMESTEPS).astype(np.float32)
    c = rs.randint(0, 30, NUM_TIMESTEPS).astype(np.float32)
    return JaxLtState(jnp.asarray(h), jnp.asarray(c)), LtState(torch.as_tensor(h), torch.as_tensor(c))


@functools.lru_cache(maxsize=None)
def _jax_loss(jm, aux=0.1):
    """The summed JAX loss of (params, lt, seq, t, pt, xt) and its
    value-and-grad, jitted, with a deterministic predict_start (rng=None)
    so the auxiliary term stays on without dropout."""

    def f(params, lt, seq, t, pt, xt):
        losses, new_lt, _ = jax_diffusion_loss(
            jm.q, lambda p, ids, tt, rng: jm._predict_start(p, ids, tt, None),
            params, jax.random.PRNGKey(0), seq, lt, aux, True, t=t, pt=pt, xt=xt,
        )
        return sum(losses.values()), (losses, new_lt)

    return jax.jit(f), jax.jit(jax.value_and_grad(f, has_aux=True))


def _jax_args(seq, t, pt, xt):
    return tuple(jnp.asarray(np.asarray(a)) for a in (seq, t, pt, xt))


def _port_loss(tm, seq, t, pt, xt, aux=0.1):
    def f(lt):
        return diffusion_loss(
            tm.q, tm._predict_start, seq, lt, auxiliary_loss_weight=aux,
            t=torch.as_tensor(t), pt=torch.as_tensor(pt), xt=torch.as_tensor(xt),
        )

    return f


def test_corrupt_matches_jax_with_its_gumbel_noise(pair):
    jm, _, tm = pair
    seq = _tokens(tm, 6, seed=1)
    t = np.array([0, 1, 4, 5, 8, 9])
    key = jax.random.PRNGKey(7)
    _, want = jm.q.corrupt(key, jnp.asarray(seq.numpy()), jnp.asarray(t))
    B, S = seq.shape
    A, Vp = tm.q.A, tm.q.Vp
    noise = np.array(jax_gumbel_noise(key, (B, S // A, A, Vp), jnp.float32))
    got = tm.q.corrupt(seq, torch.as_tensor(t), noise=torch.as_tensor(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # with a generator: valid ids for each attribute slot
    g = torch.Generator().manual_seed(0)
    drawn = tm.q.corrupt(seq, torch.as_tensor(t), g).numpy()
    legal = tm.tokenizer.token_mask() | (np.arange(tm.num_classes) == tm.num_classes - 1)
    assert legal[np.arange(S)[None, :], drawn].all()


def test_sample_time_regimes_and_weights():
    T, B = NUM_TIMESTEPS, 20000
    g = torch.Generator().manual_seed(0)
    # uniform below 11 visits in some bucket
    lt = LtState(torch.rand(T, generator=g), torch.full((T,), 11.0))
    lt.count[3] = 10.0
    t, pt = sample_time(g, lt, B, T)
    assert t.min() >= 0 and t.max() < T
    np.testing.assert_array_equal(pt.numpy(), np.full(B, 1.0 / T, np.float32))
    # importance-sampled above: pt is the JAX package's weight of each t
    lt.count[3] = 11.0
    jlt = JaxLtState(jnp.asarray(lt.history.numpy()), jnp.asarray(lt.count.numpy()))
    jt, jpt = jax_sample_time(jax.random.PRNGKey(0), jlt, 64, T)
    weights = importance_weights(lt)
    np.testing.assert_allclose(weights[np.asarray(jt)].numpy(), np.asarray(jpt), rtol=1e-6)
    assert weights[0] == weights[1]
    t, pt = sample_time(g, lt, B, T)
    np.testing.assert_array_equal(pt.numpy(), weights[t].numpy())
    freq = np.bincount(t.numpy(), minlength=T) / B
    np.testing.assert_allclose(freq, weights.numpy(), atol=0.01)  # ~4 sigma


def test_diffusion_loss_and_lt_state_match_jax(pair):
    jm, params, tm = pair
    seq = _tokens(tm, 12, seed=2)
    t, pt, xt = _injected(jm, seq, seed=3)
    jlt, plt = _lt(4)
    (_, (want, want_lt)) = _jax_loss(jm)[0](params, jlt, *_jax_args(seq, t, pt, xt))
    got, got_lt = _port_loss(tm, seq, t, pt, xt)(plt)
    assert set(got) == set(want) == {"kl_loss", "aux_loss"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_lt.history.numpy(), np.asarray(want_lt.history), rtol=1e-5)
    np.testing.assert_array_equal(got_lt.count.numpy(), np.asarray(want_lt.count))
    # evaluation drops the auxiliary loss
    losses, _ = diffusion_loss(
        tm.q, tm._predict_start, seq, plt, is_train=False,
        t=torch.as_tensor(t), pt=torch.as_tensor(pt), xt=torch.as_tensor(xt),
    )
    assert set(losses) == {"kl_loss"}


def test_every_parameter_gradient_matches_jax_grad(pair):
    jm, params, tm = pair
    seq = _tokens(tm, 12, seed=5)
    t, pt, xt = _injected(jm, seq, seed=6)
    jlt, plt = _lt(7)
    _, grads = _jax_loss(jm)[1](params, jlt, *_jax_args(seq, t, pt, xt))
    want = params_from_flax(jax.tree.map(np.asarray, grads))
    tm.net.zero_grad(set_to_none=True)
    losses, _ = _port_loss(tm, seq, t, pt, xt)(plt)
    sum(losses.values()).backward()
    got = {n: p.grad for n, p in tm.net.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        scale = want[n].abs().max().item()
        err = (g - want[n]).abs().max().item()
        assert err <= GRAD_TOL * max(scale, 1e-6), (n, err, scale)
    tm.net.zero_grad(set_to_none=True)


def test_decayed_parameters_match_jax_decay_mask(pair):
    _, params, tm = pair
    mask = params_from_flax(jax.tree.map(lambda m: np.float32(m), decay_mask(params)))
    want = {n for n, m in mask.items() if m.item() == 1.0}
    got = set(decayed_parameter_names(tm.net))
    assert got == want
    # the Dense inside each AdaLayerNorm does not decay
    assert "backbone.layers.0.norm1.cond.linear.weight" not in got
    assert "head.weight" in got and "backbone.layers.1.attn.qkv.weight" in got


def test_three_adamw_steps_with_clipping_match_optax():
    jm, params, tm = layoutdm_pair(seed=1)
    lr, wd, betas, clip = 1e-3, 0.1, (0.9, 0.98), 0.5
    opt = jax_make_optimizer(lr=lr, weight_decay=wd, betas=betas, grad_norm_clip=clip)
    opt_state = opt.init(params)
    update = jax.jit(opt.update)
    state = init_train_state(tm, make_optimizer(tm.net, lr, wd, betas), clip)
    jlt, state.lt_state = _lt(8)
    norms = []
    for i in range(3):
        seq = _tokens(tm, 12, seed=10 + i)
        t, pt, xt = _injected(jm, seq, seed=20 + i)
        (_, (_, jlt)), grads = _jax_loss(jm)[1](params, jlt, *_jax_args(seq, t, pt, xt))
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        train_step(state, None, loss_fn=_port_loss(tm, seq, t, pt, xt))
        norms.append(float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(grads)))))
    assert min(norms) > clip  # the clip engaged at every step
    assert state.step == 3
    want = params_from_flax(jax.tree.map(np.asarray, params))
    for n, p in tm.net.state_dict().items():
        err = (p - want[n]).abs().max().item()
        assert err <= PARAM_TOL, (n, err)
    np.testing.assert_allclose(state.lt_state.history.numpy(), np.asarray(jlt.history), rtol=1e-5)


def test_clip_by_global_norm_is_optax_rule():
    p = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))]
    p[0].grad, p[1].grad = torch.tensor([3.0, 0.0, 0.0]), torch.tensor([0.0, 4.0])
    assert clip_by_global_norm(p, 10.0).item() == 5.0
    assert p[0].grad.tolist() == [3.0, 0.0, 0.0]  # norm <= max: untouched
    clip_by_global_norm(p, 1.0)
    torch.testing.assert_close(p[1].grad, torch.tensor([0.0, 0.8]), rtol=0, atol=1e-7)


def test_embedding_dropout_matches_flax_under_the_same_mask(pair):
    jm, params, tm = pair
    rs = np.random.RandomState(9)
    B, S, D = 3, tm.seq_len, tm.backbone_cfg.d_model
    ids = rs.randint(0, tm.num_classes, (B, S))
    t = rs.randint(0, NUM_TIMESTEPS, B)
    keep = rs.rand(B, S, D) < 0.9

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, fnn.Dropout) and context.method_name == "__call__" and mod.rate > 0:
            x = args[0]
            return jnp.where(keep, x / (1.0 - mod.rate), 0.0).astype(x.dtype)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(intercept):
        want = jm.net.apply({"params": params}, jnp.asarray(ids), jnp.asarray(t),
                            deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    got = tm.net(torch.as_tensor(ids), torch.as_tensor(t), Dropout(masks=[keep]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    plain = tm.net(torch.as_tensor(ids), torch.as_tensor(t))
    assert (got - plain).abs().max() > 1e-2  # the mask did something


def test_generator_dropout_and_attention_dropout_guard():
    _, _, tm = layoutdm_pair(seed=2, backbone=dict(dropout=0.1))
    ids, t = torch.zeros((2, tm.seq_len), dtype=torch.long), torch.zeros(2, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.net(ids, t, Dropout(torch.Generator().manual_seed(0)))
    tm.net(ids, t)  # evaluation needs no probability tensor
    d = Dropout(torch.Generator().manual_seed(0))
    x = torch.ones(1000)
    y = d(x, 0.25)
    assert set(y.unique().tolist()) <= {0.0, float(np.float32(1.0 / 0.75))}
    assert 0.2 < (y == 0).float().mean() < 0.3
    assert d(x, 0.0) is x


def test_model_loss_and_preprocess(pair):
    _, _, tm = pair
    g = torch.Generator().manual_seed(0)
    batch = layout_batch(np.random.RandomState(11), 8)
    tokens = tm.preprocess(batch, g)
    lt = tm.init_state()
    losses, new_lt = tm.loss(tokens, lt, g)
    assert set(losses) == {"kl_loss", "aux_loss"}
    assert all(torch.isfinite(v) for v in losses.values())
    assert new_lt.count.sum() == 8
    # seq_type "set": element slots shuffled per row, attributes kept together
    tm.cfg.seq_type = "set"
    try:
        shuffled = tm.preprocess(batch, g)
    finally:
        tm.cfg.seq_type = "poset"
    C = tm.tokenizer.N_var_per_element
    a = tokens["seq"].reshape(8, -1, C).numpy()
    b = shuffled["seq"].reshape(8, -1, C).numpy()
    for r in range(8):
        assert sorted(map(tuple, a[r])) == sorted(map(tuple, b[r]))
    assert not np.array_equal(a, b)


def test_kmeans_centers_match_jax_and_cache(tmp_path):
    boxes = np.random.RandomState(0).rand(5000, 4).astype(np.float32)
    for method in ("kmeans", "percentile"):
        want = jax_fit(boxes, (8, 32), method)
        got = fit_coordinate_clusters(boxes, (8, 32), method)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    cfgs = [
        build("layoutdm", "synthetic", [
            f"dataset.dir={tmp_path}/{pkg}/datasets", "dataset.max_seq_length=5",
            "data.num_bin_bboxes=8",
        ])
        for pkg, build in (("jax", build_train_config), ("port", tconfigs.build_train_config))
    ]
    data = load_dataset("synthetic", "", "train", 5)
    want = jax_resolve_centers(cfgs[0], data)
    got = resolve_centers(cfgs[1], data)
    np.testing.assert_array_equal(got, want)
    cached = tmp_path / "port" / "clustering_weights" / "synthetic_max5_kmeans_train_clusters.npz"
    assert cached.exists()
    np.testing.assert_array_equal(resolve_centers(cfgs[1]), np.sort(want, axis=1))


def test_checkpoint_round_trip(pair, tmp_path):
    _, _, tm = pair
    state = init_train_state(tm, make_optimizer(tm.net), 1.0)
    g = torch.Generator().manual_seed(0)
    train_step(state, tm.preprocess(layout_batch(np.random.RandomState(0), 4)), g)
    ckpt.save_train_state(state, str(tmp_path), {"torch": g.get_state()})
    ckpt.save_params(tm.net.state_dict(), str(tmp_path), "best")
    _, _, other = layoutdm_pair(seed=3)
    restored = init_train_state(other, make_optimizer(other.net), 1.0)
    gens = ckpt.load_train_state(restored, str(tmp_path))
    assert restored.step == 1 and torch.equal(gens["torch"], g.get_state())
    assert torch.equal(restored.lt_state.count, state.lt_state.count)
    for (n, a), b in zip(tm.net.state_dict().items(), other.net.state_dict().values()):
        assert torch.equal(a, b), n
    s0, s1 = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert s0["param_groups"] == s1["param_groups"]
    for k in s0["state"]:
        assert torch.equal(s0["state"][k]["exp_avg_sq"], s1["state"][k]["exp_avg_sq"])
    best = torch.load(tmp_path / "params.pt", weights_only=True)
    assert all(torch.equal(best[n], v) for n, v in tm.net.state_dict().items())
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_resume_equals_an_uninterrupted_run(tmp_path):
    def cfg(job, epochs):
        return tconfigs.build_train_config("layoutdm", "synthetic", TINY + [
            f"job_dir={tmp_path}/{job}", f"dataset.dir={tmp_path}/datasets",
            "data.batch_size=512", f"training.epochs={epochs}",
        ])

    full = train(cfg("full", 2), device="cpu")
    train(cfg("cut", 1), device="cpu")
    resumed = train(cfg("cut", 2), device="cpu")
    assert resumed == full
    a = torch.load(tmp_path / "full" / "final_params.pt", weights_only=True)
    b = torch.load(tmp_path / "cut" / "final_params.pt", weights_only=True)
    for n in a:
        assert torch.equal(a[n], b[n]), n
    rows = [json.loads(x) for x in open(tmp_path / "cut" / "metrics.jsonl")]
    assert [r["epoch"] for r in rows] == [0, 1]


def test_cpu_trainer_cli_writes_a_job_the_service_serves(tmp_path):
    args = ["layoutdm", "synthetic", "debug=true", "seed=0,1", "data.batch_size=16",
            f"job_dir={tmp_path}/job", f"dataset.dir={tmp_path}/datasets", *TINY]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(args)  # the device defaults to cuda; this host has none
    results = train_main(args + ["device=cpu"])
    assert set(results) == {0, 1}
    job = tmp_path / "job" / "seed_0"
    for f in ("config.json", "params.pt", "final_params.pt", "last_state.pt",
              "resume.json", "metrics.jsonl", "result.json"):
        assert (job / f).exists(), f
    assert os.listdir(job / "logs")
    rows = [json.loads(x) for x in open(job / "metrics.jsonl")]
    assert len(rows) == 2 and all(np.isfinite(r["val_loss"]) for r in rows)
    assert (tmp_path / "clustering_weights").is_dir()  # kmeans fitted and cached
    cfg, sd = load_job(str(job))
    assert cfg.data.bbox_quantization == "kmeans" and cfg.backbone.d_model == 128
    service = LayoutService(str(job), max_batch_size=4, device="cpu")
    try:
        out = service.generate("unconditional", 2, 5, None)
    finally:
        service.close()
    assert len(out["layouts"]) == 2
    for lay in out["layouts"]:
        assert len(lay["label"]) == len(lay["bbox"]) <= 5


def _fidnet_dir(root, S, seed=0):
    """A FIDNetV3 ``.pth.tar`` for synthetic at max S under ``root``."""
    from layoutdm_tpu_torch.eval.fidnet import FIDNetV3

    torch.manual_seed(seed)
    model = FIDNetV3(5, max_bbox=S, device="cpu")
    os.makedirs(root / f"synthetic-max{S}")
    torch.save({"state_dict": model.state_dict()},
               root / f"synthetic-max{S}" / "model_best.pth.tar")
    return str(root)


def test_fid_probe_writes_a_finite_fid_val(tmp_path):
    """With extractor weights for the dataset, every epoch (2 epochs:
    max(2 // 10, 1)) writes ``fid_val`` to metrics.jsonl and ``val/fid`` to
    TensorBoard; the probe draws from a stream of its own, so the trained
    weights are those of a run without it."""
    def cfg(job, fid_dir):
        return tconfigs.build_train_config("layoutdm", "synthetic", TINY + [
            "debug=true", "data.batch_size=16", f"job_dir={tmp_path}/{job}",
            f"dataset.dir={tmp_path}/datasets", f"fid_weight_dir={fid_dir}"])

    fid_dir = _fidnet_dir(tmp_path / "fid", 5)
    train(cfg("probed", fid_dir), device="cpu")
    rows = [json.loads(x) for x in open(tmp_path / "probed" / "metrics.jsonl")]
    fids = [r for r in rows if "fid_val" in r]
    assert [r["epoch"] for r in fids] == [0, 1]
    assert all(np.isfinite(r["fid_val"]) for r in fids)
    events = b"".join(p.read_bytes() for p in (tmp_path / "probed" / "logs").iterdir())
    assert b"val/fid" in events
    train(cfg("plain", str(tmp_path / "no_fid")), device="cpu")
    a = torch.load(tmp_path / "probed" / "final_params.pt", weights_only=True)
    b = torch.load(tmp_path / "plain" / "final_params.pt", weights_only=True)
    for n in a:
        assert torch.equal(a[n], b[n]), n


def test_training_fid_on_injected_layouts_matches_jax(tmp_path):
    """``_compute_training_fid`` of both packages on the same 512 sampled
    layouts (injected in place of each model's sampler) against the same
    512 val layouts, through the same FIDNet file: n > 256 feature
    dimensions, so FID agrees within 1e-3 relative.  The extractor and the
    val features are cached across probes."""
    from types import SimpleNamespace

    from layoutdm_tpu.train.loop import _compute_training_fid as jax_fid
    from layoutdm_tpu_torch.train.loop import _compute_training_fid as port_fid

    S, n = 5, 512
    fid_dir = _fidnet_dir(tmp_path, S, seed=3)
    rs = np.random.RandomState(0)
    val = SimpleNamespace(**layout_batch(rs, n, max_elements=S, num_categories=5))
    fake = layout_batch(rs, n, max_elements=S, num_categories=5)
    overrides = [f"dataset.max_seq_length={S}", f"fid_weight_dir={fid_dir}"]
    jcfg = build_train_config("layoutdm", "synthetic", overrides)
    tcfg = tconfigs.build_train_config("layoutdm", "synthetic", overrides)
    jmodel = SimpleNamespace(sample=lambda params, rng, k: {x: fake[x][:k] for x in fake})
    tmodel = SimpleNamespace(device=torch.device("cpu"), sample=lambda gen, k: {
        x: torch.as_tensor(fake[x][:k]) for x in fake})
    want = jax_fid(jcfg, jmodel, SimpleNamespace(params=None), val, None, n_samples=n)
    cache = {}
    got = port_fid(tcfg, tmodel, None, val, n_samples=n, cache=cache)
    assert np.isfinite(got) and abs(got - want) <= 1e-3 * abs(want), (got, want)
    feats_real = cache["feats_real"]
    assert port_fid(tcfg, tmodel, None, val, n_samples=n, cache=cache) == got
    assert cache["feats_real"] is feats_real and feats_real.shape == (n, 256)
