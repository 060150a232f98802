"""The port's parallel training (`layoutdm_tpu_torch.parallel`, the mesh
steps of `train.step`, the trainer's ``training.num_devices``) on gloo
processes on the CPU, world 2 and world 4 (data 2 x model 2), held to the
single-process port step and to the JAX single-device step on the same
weights and the same injected noise (`test_torch_train.py`'s
``_injected``), at `tests/test_tp.py`'s tolerances; the shard_map step's
LtState merge held to a host simulation of its collectives, after
`tests/test_train.py::test_shardmap_step_equals_host_simulation`; the
data-parallel step of MaskGIT and RUITE, whose losses are masked means,
held to the single-process step on the full batch.

The ranks run `torch_parallel_worker.run`, spawned once a world size."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from layoutdm_tpu.models.diffusion.loss import LtState as JaxLtState
from layoutdm_tpu.models.diffusion.loss import diffusion_loss as jax_diffusion_loss
from layoutdm_tpu.train.step import make_optimizer as jax_make_optimizer
from layoutdm_tpu_torch.configs import build_train_config
from layoutdm_tpu_torch.models.diffusion.loss import LtState
from layoutdm_tpu_torch.parallel.mesh import make_mesh
from layoutdm_tpu_torch.train.loop import train
from layoutdm_tpu_torch.train.step import (
    clip_by_global_norm,
    eval_loss,
    fold_in,
    train_step,
)
from layoutdm_tpu_torch.utils.params import params_from_flax
from torch_parallel_worker import build, injected_loss, run, zoo_run
from torch_port_helpers import (
    BACKBONE,
    MAX_ELEMENTS,
    NUM_BINS,
    NUM_CATEGORIES,
    NUM_TIMESTEPS,
    jax_decayed_names,
    layout_batch,
    layoutdm_pair,
)

B = 8
ADAMW = (1e-3, 0.1, (0.9, 0.98))  # lr, weight decay, betas
CLIP = 0.5  # engages at each step
SEED = 11
LOSS_TOL = dict(rtol=2e-5, atol=1e-5)  # tests/test_tp.py
PARAM_TOL = 3e-4
TRAINER = ["debug=true", "dataset.max_seq_length=5", "data.bbox_quantization=linear",
           "data.batch_size=8", "backbone.d_model=64", "backbone.nhead=2",
           "backbone.dim_feedforward=32", "backbone.num_layers=1", "model.num_timesteps=10",
           "backbone.diffusion_step=10", "training.sample_plot_epoch_interval=0"]
ZOO = ["maskgit", "ruite"]  # cross-entropy over masked / non-PAD tokens
ZOO_TINY = ["dataset.max_seq_length=5", "data.bbox_quantization=linear",
            "backbone.d_model=64", "backbone.nhead=2", "backbone.dim_feedforward=64",
            "backbone.num_layers=1"]


def _zoo_case(experiment, seq_seed):
    """A family on weights from a seed, and its tokens of a batch whose
    rows differ in their element counts, so the ranks' token counts differ."""
    from layoutdm_tpu_torch.factory import build_model

    cfg = build_train_config(experiment, "synthetic", ZOO_TINY)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    batch = layout_batch(np.random.RandomState(seq_seed), B, 5, model.tokenizer.N_category)
    tokens = model.preprocess(batch, torch.Generator().manual_seed(7))
    return {"experiment": experiment, "overrides": ZOO_TINY,
            "state_dict": model.net.state_dict(), "tokens": tokens, "adamw": ADAMW,
            "clip": CLIP, "seed": SEED}


def _injected(corrupt, seq, seed):
    """t (t = 0 and repeated t included), pt and x_t by the JAX package's
    (jitted) ``q.corrupt``."""
    rs = np.random.RandomState(seed)
    t = np.concatenate([[0, 0, 3, 3, 3], rs.randint(0, NUM_TIMESTEPS, B - 5)])
    pt = rs.uniform(0.05, 0.2, B).astype(np.float32)
    _, xt = corrupt(jax.random.PRNGKey(seed), jnp.asarray(seq), jnp.asarray(t))
    return {"t": torch.as_tensor(t), "pt": torch.as_tensor(pt),
            "xt": torch.as_tensor(np.array(xt))}


def _jax_trajectory(jm, params, case):
    """The JAX single-device step (its loss with a deterministic
    predict_start, optax's AdamW with clipping) on the injected noise."""
    def f(p, lt, seq, t, pt, xt):
        losses, new_lt, _ = jax_diffusion_loss(
            jm.q, lambda pp, ids, tt, rng: jm._predict_start(pp, ids, tt, None),
            p, jax.random.PRNGKey(0), seq, lt, 0.1, True, t=t, pt=pt, xt=xt)
        return sum(losses.values()), new_lt

    grad = jax.value_and_grad(f, has_aux=True)
    opt = jax_make_optimizer(lr=ADAMW[0], weight_decay=ADAMW[1], betas=ADAMW[2],
                             grad_norm_clip=CLIP)

    @jax.jit
    def step(p, opt_state, lt, *args):
        (loss, lt), g = grad(p, lt, *args)
        updates, opt_state = opt.update(g, opt_state, p)
        return jax.tree.map(lambda a, u: a + u, p, updates), opt_state, lt, loss

    opt_state, lt = opt.init(params), JaxLtState(*(jnp.asarray(x.numpy()) for x in case["lt"]))
    losses = []
    for noise in case["noise"]:
        params, opt_state, lt, loss = step(
            params, opt_state, lt, jnp.asarray(case["seq"].numpy()),
            *(jnp.asarray(noise[k].numpy()) for k in ("t", "pt", "xt")))
        losses.append(float(loss))
    return {"losses": losses, "params": params_from_flax(jax.tree.map(np.asarray, params)),
            "lt": lt}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    jm, params, tm = layoutdm_pair(seed=0)
    seq = tm.tokenizer.encode(layout_batch(np.random.RandomState(1), B))["seq"]
    corrupt = jax.jit(jm.q.corrupt)
    rs = np.random.RandomState(4)
    lt = (torch.as_tensor(rs.uniform(0, 2, NUM_TIMESTEPS).astype(np.float32)),
          torch.as_tensor(rs.randint(0, 30, NUM_TIMESTEPS).astype(np.float32)))
    case = {"dir": str(d), "backbone": BACKBONE, "num_timesteps": NUM_TIMESTEPS,
            "num_bins": NUM_BINS, "num_categories": NUM_CATEGORIES,
            "max_elements": MAX_ELEMENTS, "state_dict": tm.net.state_dict(), "seq": seq,
            "noise": [_injected(corrupt, seq.numpy(), 20 + i) for i in range(2)], "lt": lt,
            "adamw": ADAMW, "clip": CLIP, "seed": SEED,
            "trainer": TRAINER + [f"dataset.dir={d}/datasets"],
            "jax_decayed": jax_decayed_names(params),
            "zoo": {e: _zoo_case(e, 30 + i) for i, e in enumerate(ZOO)}}
    torch.save(case, d / "case.pt")
    for world in (2, 4):
        mp.spawn(run, args=(world, str(d / "case.pt")), nprocs=world, join=True)
    outs = {**torch.load(d / "world2.pt", weights_only=False),
            **torch.load(d / "world4.pt", weights_only=False)}
    # the single-process port step on the same noise
    model, state = build(case)
    port = {"losses": [train_step(state, None, loss_fn=injected_loss(model, case, i, 0, B))
                       ["loss"].item() for i in range(len(case["noise"]))],
            "params": model.net.state_dict(), "lt": state.lt_state}
    return case, outs, port, _jax_trajectory(jm, params, case)


def _close_params(got, want, tol):
    assert set(got) == set(want)
    err = max((got[k] - want[k]).abs().max().item() for k in want)
    assert err < tol, err


@pytest.mark.parametrize("run_name", ["dp", "dp_multislice", "tp2", "tp4"])
def test_parallel_steps_equal_the_single_process_and_jax_steps(runs, run_name):
    case, outs, port, jx = runs
    got = outs[run_name]
    np.testing.assert_allclose(got["losses"], port["losses"], **LOSS_TOL)
    np.testing.assert_allclose(got["losses"], jx["losses"], **LOSS_TOL)
    _close_params(got["params"], port["params"], PARAM_TOL)
    _close_params(got["params"], jx["params"], PARAM_TOL)
    np.testing.assert_allclose(got["lt"].history.numpy(), np.asarray(jx["lt"].history), rtol=1e-5)
    np.testing.assert_array_equal(got["lt"].count.numpy(), np.asarray(jx["lt"].count))


def test_tp_splits_the_ffn_and_its_adam_moments(runs):
    """The FFN and its AdamW moments split over the model group; the
    weight-decay groups of the split net are the JAX ``decay_mask``'s."""
    case, outs, _, _ = runs
    assert outs["tp4"]["decayed"] == case["jax_decayed"]
    assert outs["tp4"]["decay_groups"]
    D = int(case["backbone"]["d_model"] * 29 / 32)
    F = int(case["backbone"]["dim_feedforward"] * 29 / 32)
    assert outs["tp4"]["shapes"] == {"linear1": (F // 2, D), "linear2": (D, F // 2),
                                     "linear1_exp_avg": (F // 2, D),
                                     "linear2_exp_avg_sq": (D, F // 2)}
    # a degree that does not divide the FFN width (58 over 4) raises
    assert outs["degree_error"] == ("TP degree 4 does not divide dim 0 of "
                                    f"backbone.layers.0.linear1.weight (shape ({F}, {D}))")


def test_dp_step_draws_the_full_batch_noise(runs):
    """Without injected noise: each rank draws the whole batch's timesteps,
    corruption and dropout from the same generator and keeps its rows, so
    the step is the single-process step on the full batch."""
    case, outs, _, _ = runs
    model, state = build(case)
    loss = train_step(state, case["seq"], torch.Generator().manual_seed(SEED))["loss"].item()
    got = outs["dp_own"]
    np.testing.assert_allclose(got["loss"], loss, **LOSS_TOL)
    _close_params(got["params"], model.net.state_dict(), PARAM_TOL)
    np.testing.assert_allclose(got["lt"].history.numpy(), state.lt_state.history.numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(got["lt"].count.numpy(), state.lt_state.count.numpy())
    want_eval = eval_loss(model, state.lt_state, case["seq"], torch.Generator().manual_seed(3))
    np.testing.assert_allclose(got["eval"], want_eval.item(), rtol=1e-5)


@pytest.mark.parametrize("experiment", ZOO)
def test_dp_step_of_a_masked_mean_loss_equals_the_full_batch_step(runs, experiment):
    """Two data-parallel steps and the validation loss of a family whose
    cross-entropy is a mean over masked (MaskGIT) or non-PAD (RUITE)
    tokens: the full batch's masked mean, not the mean of the ranks'."""
    case, outs, _, _ = runs
    want = zoo_run(case["zoo"][experiment], lambda m, st: train_step,
                   lambda m: lambda lt, tokens, gen: eval_loss(m, lt, tokens, gen))
    got = outs[f"zoo_{experiment}"]
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
    np.testing.assert_allclose(got["eval"], want["eval"], **LOSS_TOL)
    _close_params(got["params"], want["params"], PARAM_TOL)
    if want["aux"] is not None:  # MaskGIT's element-count histogram
        np.testing.assert_allclose(got["aux"].probs.numpy(), want["aux"].probs.numpy(),
                                   rtol=1e-6)


def test_shardmap_lt_state_equals_host_simulation(runs):
    """Per shard i: the loss of rows i with a generator seeded
    ``fold_in(seed, i)``; then the mean gradient, the mean loss, the mean
    history and the summed visit counts, one clipped AdamW step."""
    case, outs, _, _ = runs
    model, state = build(case)
    params = dict(model.net.named_parameters())
    grads, totals, lts, n = [], [], [], 2
    for i in range(n):
        m_i, s_i = build(case)
        gen = torch.Generator().manual_seed(fold_in(SEED, i))
        losses, new_lt = m_i.loss(case["seq"][i * B // n:(i + 1) * B // n], s_i.lt_state, gen)
        total = sum(losses.values())
        total.backward()
        grads.append({k: p.grad for k, p in m_i.net.named_parameters()})
        totals.append(total.item())
        lts.append(new_lt)
    for k, p in params.items():
        p.grad = sum(g[k] for g in grads) / n
    clip_by_global_norm(params.values(), CLIP)
    state.optimizer.step()
    old = LtState(*case["lt"])
    got = outs["shardmap"]
    np.testing.assert_allclose(got["loss"], np.mean(totals), rtol=1e-5)
    for k, p in model.net.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), p.numpy(), rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(got["lt"].history.numpy(),
                               torch.stack([x.history for x in lts]).mean(0).numpy(),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(
        got["lt"].count.numpy(),
        (old.count + sum(x.count - old.count for x in lts)).numpy())


def test_num_devices_must_match_the_world_size(runs, tmp_path):
    _, outs, _, _ = runs
    assert "num_devices=3 but the launched world size is 2" in outs["num_devices_error"]
    # no process group: the world is one process
    with pytest.raises(ValueError, match="num_devices=2 but the launched world size is 1"):
        make_mesh(2)
    cfg = build_train_config("layoutdm", "synthetic", TRAINER + [
        f"dataset.dir={tmp_path}/datasets", f"job_dir={tmp_path}/job",
        "training.num_devices=2"])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        train(cfg, device="cpu")


def test_tp_gathered_params_drive_the_chain(runs):
    """The FFN-split net's chain (its products summed over the model group)
    gives the tokens of the unsplit net on the gathered parameters."""
    case, outs, _, _ = runs
    model, _ = build(case)
    model.net.load_state_dict(outs["tp4"]["params"])
    want = model.sample_ids(torch.arange(8, dtype=torch.int64), 8, num_timesteps_eval=4)
    torch.testing.assert_close(outs["tp4"]["chain"], want, rtol=0, atol=0)


def test_trainer_over_two_ranks_equals_one(runs, tmp_path):
    """``training.num_devices=2`` under two gloo ranks: the losses of one
    process, and one writer of the job (rank 0)."""
    case, outs, _, _ = runs
    cfg = build_train_config("layoutdm", "synthetic", case["trainer"] + [
        f"job_dir={tmp_path}/job"])
    want = train(cfg, device="cpu")
    got = outs["trainer"]
    np.testing.assert_allclose(got["best_val_loss"], want["best_val_loss"], rtol=1e-4)
    for k, v in want["final_train"].items():
        np.testing.assert_allclose(got["final_train"][k], v, rtol=1e-4, err_msg=k)
    job = os.path.join(case["dir"], "dp_job")
    assert {"config.json", "params.pt", "final_params.pt", "last_state.pt", "resume.json",
            "metrics.jsonl", "result.json"} <= set(os.listdir(job))
    with open(os.path.join(job, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0, 1]  # written once, by rank 0
