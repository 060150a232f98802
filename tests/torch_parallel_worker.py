"""The ranks of `tests/test_torch_parallel.py`: gloo processes on the CPU,
spawned with ``torch.multiprocessing``.  Each rank imports torch and the
port only (no jax), rebuilds the tiny LayoutDM from the case file the test
wrote, runs the data-parallel, shard_map and tensor-parallel steps on its
rows of the injected noise, and the data-parallel step of the families
whose loss is a masked mean (MaskGIT, RUITE) on their own draws; rank 0
writes what the test compares."""

import os

import torch
import torch.distributed as dist

from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.models.diffusion.loss import LtState, diffusion_loss
from layoutdm_tpu_torch.models.layoutdm import LayoutDM
from layoutdm_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh, shard_rows
from layoutdm_tpu_torch.parallel.tp import (
    gathered_state_dict,
    make_train_step_tp,
    shard_train_state,
    state_shardings,
)
from layoutdm_tpu_torch.tokenizer.bbox import BboxTokenizer
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer
from layoutdm_tpu_torch.train.step import (
    decayed_parameter_names,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    make_train_step_shardmap,
)


def build(case):
    tok = LayoutSequenceTokenizer(
        bbox_tokenizer=BboxTokenizer(num_bins=case["num_bins"], shared_vocab="x-y-w-h"),
        num_categories=case["num_categories"], max_elements=case["max_elements"],
        pad_until_max=True)
    model = LayoutDM(tconfigs.BackboneConfig(**case["backbone"]), tok,
                     tconfigs.ModelConfig(num_timesteps=case["num_timesteps"]), device="cpu")
    model.net.load_state_dict(case["state_dict"])
    state = init_train_state(model, make_optimizer(model.net, *case["adamw"]), case["clip"])
    state.lt_state = LtState(case["lt"][0].clone(), case["lt"][1].clone())
    return model, state


def build_zoo(zc):
    """A family of `factory.build_model` on the case's weights, its train
    state, and a generator for its draws."""
    from layoutdm_tpu_torch.factory import build_model

    model = build_model(tconfigs.build_train_config(zc["experiment"], "synthetic",
                                                    zc["overrides"]), device="cpu")
    model.net.load_state_dict(zc["state_dict"])
    state = init_train_state(model, make_optimizer(model.net, *zc["adamw"]), zc["clip"])
    return model, state, torch.Generator().manual_seed(zc["seed"])


def zoo_run(zc, step_fn, eval_fn):
    """Two steps on the family's own draws, then the validation loss."""
    model, state, gen = build_zoo(zc)
    step = step_fn(model, state)
    losses = [step(state, zc["tokens"], gen)["loss"].item() for _ in range(2)]
    val = eval_fn(model)(state.lt_state, zc["tokens"], torch.Generator().manual_seed(3))
    return {"losses": losses, "params": model.net.state_dict(), "aux": state.lt_state,
            "eval": val.item()}


def injected_loss(model, case, step, lo, hi):
    """Rows [lo, hi) of step ``step``'s injected loss."""
    t, pt, xt = (case["noise"][step][k][lo:hi] for k in ("t", "pt", "xt"))
    return lambda lt: diffusion_loss(model.q, model._predict_start, case["seq"][lo:hi], lt,
                                     t=t, pt=pt, xt=xt)


def trajectory(case, step_fn, model, state, lo, hi):
    losses = []
    for i in range(len(case["noise"])):
        losses.append(step_fn(state, case["seq"], None,
                              loss_fn=injected_loss(model, case, i, lo, hi))["loss"].item())
    return losses


def moments_shape(state, p):
    return tuple(state.optimizer.state[p]["exp_avg"].shape)


def world2(case, out):
    mesh = make_mesh(2)
    # the data-parallel step on the injected noise, and on its own draws
    model, state = build(case)
    lo, hi = shard_rows(case["seq"].shape[0], mesh)
    dp = make_train_step(model, state.optimizer, mesh)
    out["dp"] = {"losses": trajectory(case, dp, model, state, lo, hi),
                 "params": model.net.state_dict(), "lt": state.lt_state}
    model, state = build(case)
    dp = make_train_step(model, state.optimizer, mesh)
    gen = torch.Generator().manual_seed(case["seed"])
    out["dp_own"] = {"loss": dp(state, case["seq"], gen)["loss"].item(),
                     "params": model.net.state_dict(), "lt": state.lt_state,
                     "eval": make_eval_step(model, mesh)(
                         state.lt_state, case["seq"], torch.Generator().manual_seed(3)).item()}
    # the shard_map step, each rank its own rows' noise
    model, state = build(case)
    step = make_train_step_shardmap(model, state.optimizer, mesh)
    out["shardmap"] = {"loss": step(state, case["seq"], case["seed"])["loss"].item(),
                       "params": model.net.state_dict(), "lt": state.lt_state}
    # the masked cross-entropy families: a masked mean over the full batch
    for name, zc in case["zoo"].items():
        out[f"zoo_{name}"] = zoo_run(
            zc, lambda m, st: make_train_step(m, st.optimizer, mesh),
            lambda m: make_eval_step(m, mesh))
    # tensor parallelism of degree 2 (one data shard)
    tp_mesh = make_mesh(2, model_parallel=2)
    model, state = build(case)
    shard_train_state(state, tp_mesh)
    tp = make_train_step_tp(model, state.optimizer, tp_mesh, state)
    lo, hi = shard_rows(case["seq"].shape[0], tp_mesh)
    out["tp2"] = {"losses": trajectory(case, tp, model, state, lo, hi),
                  "params": gathered_state_dict(state, tp_mesh), "lt": state.lt_state}
    # num_devices against the world size
    try:
        make_mesh(3)
    except ValueError as e:
        out["num_devices_error"] = str(e)
    # the trainer over the mesh: rank 0 writes the job
    from layoutdm_tpu_torch.configs import build_train_config
    from layoutdm_tpu_torch.train.loop import train

    cfg = build_train_config("layoutdm", "synthetic", case["trainer"] + [
        f"job_dir={case['dir']}/dp_job", "training.num_devices=2"])
    out["trainer"] = train(cfg, device="cpu")


def world4(case, out):
    # the data-parallel step over a ("dcn", "data") mesh: the batch split
    # over the flattened data group, 2 rows a rank
    ms = make_multislice_mesh(2)
    model, state = build(case)
    lo, hi = shard_rows(case["seq"].shape[0], ms)
    dp = make_train_step(model, state.optimizer, ms)
    out["dp_multislice"] = {"losses": trajectory(case, dp, model, state, lo, hi),
                            "params": model.net.state_dict(), "lt": state.lt_state,
                            "rows": (lo, hi)}
    mesh = make_mesh(4, model_parallel=2)  # data 2 x model 2
    model, state = build(case)
    shard_train_state(state, mesh)
    tp = make_train_step_tp(model, state.optimizer, mesh, state)
    lo, hi = shard_rows(case["seq"].shape[0], mesh)
    l1 = model.net.backbone.layers[0].linear1.weight
    l2 = model.net.backbone.layers[0].linear2.weight
    out["tp4"] = {"losses": trajectory(case, tp, model, state, lo, hi),
                  "params": gathered_state_dict(state, mesh), "lt": state.lt_state,
                  "decayed": set(decayed_parameter_names(model.net)),
                  "decay_groups": [{id(p) for p in g["params"]}
                                   for g in state.optimizer.param_groups]
                  == [{id(p) for p in g["params"]} for g in make_optimizer(
                      model.net, *case["adamw"]).param_groups],
                  "shapes": {"linear1": tuple(l1.shape), "linear2": tuple(l2.shape),
                             "linear1_exp_avg": moments_shape(state, l1),
                             "linear2_exp_avg_sq": tuple(
                                 state.optimizer.state[l2]["exp_avg_sq"].shape)}}
    # the split net drives the chain (its FFN sums over the model group)
    out["tp4"]["chain"] = model.sample_ids(torch.arange(8, dtype=torch.int64), 8,
                                           num_timesteps_eval=4)
    # a degree that does not divide the FFN width
    try:
        state_shardings(build(case)[1], make_mesh(4, model_parallel=4))
    except ValueError as e:
        out["degree_error"] = str(e)


def run(rank, world, case_path):
    torch.set_num_threads(1)
    case = torch.load(case_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{case['dir']}/store{world}",
                            world_size=world, rank=rank)
    try:
        out = {}
        (world2 if world == 2 else world4)(case, out)
        if rank == 0:
            torch.save(out, os.path.join(case["dir"], f"world{world}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()

