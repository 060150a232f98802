"""Entry points of the port (counterpart of ``__graft_entry__.py``):
the flagship denoiser's forward, and the flagship-scale multi-rank dry run.

    python -m layoutdm_tpu_torch.graft_entry --n_devices N [--device cpu]

`entry` is the flagship denoiser's forward (vocab 155, 125 tokens,
d_model 464, 8 heads of 58, FFN 1856, 4 layers, float32, random weights
from seed 0) on two all-zero rows.  `dryrun_multichip` spawns ``n`` ranks
(one GPU each on NCCL, or gloo processes on the CPU) and runs the JAX dry
run's five programs over a ``("data", "model")`` mesh at flagship shapes,
``B = 2n`` rows:

1. the data-parallel train step (`train.step.make_train_step` over the
   mesh): finite, and, since every rank draws the full batch's noise and
   keeps its rows, the loss of the one-process `train_step` on the same
   generator seed (JAX checks only that it is finite);
2. the shard_map step (`make_train_step_shardmap`): finite, and different
   by design (each shard draws its own noise);
3. the batch-sharded chain: each rank samples its rows at T_eval = 20 with
   the random sampler from row seeds ``arange(lo, hi)``, the ranks gather
   the ids (`parallel.mesh.gather_rows`); every rank contributed, and the
   ids are those of one process sampling ``arange(B)`` (a row's noise is
   hashed from its own seed, `ops.samplers.row_gumbel`);
4. for even ``n``, the TP x DP step (`parallel.tp`, model axis 2): finite,
   and each rank holds half of every ``linear1``;
5. batch-sharded FIDNetV3 features (25 labels, 25 elements, seeded init)
   gathered over the ranks: (B, 256), finite, every rank contributed, and
   within 1e-4 of one process extracting the whole batch.

Rank 0 prints the JAX dry run's summary line and the call returns a dict
of the losses, the contributing ranks, the features' error and rank 0's
K1 / K2 launches by step; a failure in any rank fails the call.  The
references of one process (the train step, the chain, the features) run
on rank 0.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import sys
import tempfile
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from layoutdm_tpu_torch.utils.device import require_device

T_EVAL = 20  # the dry run's chain length (the program's structure is T=100's)
LOSS_TOL = dict(rtol=2e-5, atol=1e-5)  # data-parallel step against `train_step`
FEATURE_TOL = 1e-4  # float32 features, summation order only
TIMEOUT_S = 600  # a rank that waits longer on a collective fails the call


def _flagship(device):
    from layoutdm_tpu_torch.bench.headline import build_flagship, flagship_config

    return build_flagship(flagship_config(dtype="float32"), device)


def entry(device="cuda", state_dict=None) -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """``(fn, (seq, t))``: the flagship denoiser's forward on (2, 125)
    zero ids at t = 0; ``fn(seq, t)`` gives (2, 125, 155) logits.  On the
    card it launches K1 once a layer.  ``state_dict``: weights to load in
    place of the seeded ones (e.g. `utils.params.params_from_flax` of the
    JAX entry's)."""
    model = _flagship(require_device(device))
    if state_dict is not None:
        model.net.load_state_dict(state_dict)
    seq = torch.zeros((2, model.seq_len), dtype=torch.int64, device=model.device)
    t = torch.zeros((2,), dtype=torch.int64, device=model.device)

    @torch.inference_mode()
    def fwd(seq, t):
        return model.net(seq, t)

    return fwd, (seq, t)


@contextlib.contextmanager
def _threads(n: int):
    """``n`` CPU threads inside the block: rank 0's one-process references,
    which the other ranks wait on, take their threads too."""
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _launches() -> Dict[str, int]:
    from layoutdm_tpu_torch.ops import attention

    return {"K1": attention.LAUNCHES, "K2": attention.LAUNCHES_BWD}


def _layout_batch(model, B: int) -> Dict[str, np.ndarray]:
    """The dry run's batch (`__graft_entry__.py:69-81`): 1..25 elements a
    row from ``RandomState(0)``, labels zeroed past the count."""
    tok = model.tokenizer
    rng = np.random.RandomState(0)
    n = rng.randint(1, tok.max_elements + 1, size=(B,))
    mask = np.arange(tok.max_elements)[None, :] < n[:, None]
    return {"label": rng.randint(0, tok.N_category, size=mask.shape) * mask,
            "bbox": rng.rand(*mask.shape, 4).astype(np.float32), "mask": mask}


def _dryrun(n: int, device: torch.device) -> Dict:
    from layoutdm_tpu_torch.configs import SamplingConfig
    from layoutdm_tpu_torch.eval.fidnet import FIDNetV3, make_feature_extractor
    from layoutdm_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_batch, shard_rows
    from layoutdm_tpu_torch.parallel.tp import make_train_step_tp, shard_train_state
    from layoutdm_tpu_torch.train.step import (
        init_train_state,
        make_optimizer,
        make_train_step,
        make_train_step_shardmap,
        train_step,
    )

    lead = dist.get_rank() == 0
    model = _flagship(device)
    init = {k: v.clone() for k, v in model.net.state_dict().items()}
    B, S = 2 * n, model.seq_len
    batch = _layout_batch(model, B)
    tokens = model.preprocess(batch, torch.Generator().manual_seed(7))
    mesh = make_mesh(n)
    out = {"backend": dist.get_backend(), "world_size": n, "batch": B, "dtype": "float32",
           "num_layers": model.backbone_cfg.num_layers, "t_eval": T_EVAL, "losses": {},
           "launches_by_step": {}}
    launches = out["launches_by_step"]

    def fresh():
        model.net.load_state_dict(init)
        return init_train_state(model, make_optimizer(model.net, lr=1e-3))

    def gen():
        return torch.Generator(device=device).manual_seed(1)

    def run(name, fn):
        before = _launches()
        value = fn()
        launches[name] = {k: v - before[k] for k, v in _launches().items()}
        return value

    def finite_loss(name, step, *args):
        loss = run(name, lambda: step(*args)["loss"].item())
        if not np.isfinite(loss):
            raise AssertionError(f"{name} loss {loss}")
        out["losses"][name] = loss
        return loss

    # 1. the data-parallel step, and the one-process step it equals
    st = fresh()
    dp = finite_loss("data_parallel", make_train_step(model, st.optimizer, mesh), st, tokens,
                     gen())
    trained = {k: v.clone() for k, v in model.net.state_dict().items()}
    if lead:
        st = fresh()
        with _threads(n):
            one = finite_loss("train_step", train_step, st, tokens, gen())
        if not abs(dp - one) <= LOSS_TOL["atol"] + LOSS_TOL["rtol"] * abs(one):
            raise AssertionError(f"data-parallel loss {dp} != train_step's {one}")

    # 2. the shard_map step
    st = fresh()
    finite_loss("shard_map", make_train_step_shardmap(model, st.optimizer, mesh), st, tokens, 1)

    # 3. the batch-sharded chain on the data-parallel step's weights
    model.net.load_state_dict(trained)
    sampling = SamplingConfig(name="random")
    lo, hi = shard_rows(B, mesh)

    def chain(seeds):
        return model.sample_ids(seeds.to(device), len(seeds), sampling=sampling,
                                num_timesteps_eval=T_EVAL)

    own = run("chain", lambda: chain(torch.arange(lo, hi)))
    ids, out["chain_ranks"] = gather_rows(own, mesh)
    if ids.shape != (B, S) or sorted(out["chain_ranks"]) != list(range(n)):
        raise AssertionError(f"chain ids {tuple(ids.shape)} from ranks {out['chain_ranks']}")
    if not (int(ids.min()) >= 0 and int(ids.max()) < model.num_classes):
        raise AssertionError(f"chain ids outside [0, {model.num_classes})")
    if lead:
        with _threads(n):
            want = run("chain_one_process", lambda: chain(torch.arange(B)))
        out["chain_equal_one_process"] = torch.equal(ids, want)
        if not out["chain_equal_one_process"]:
            raise AssertionError("the gathered chain differs from one process's")

    # 4. TP x DP, even world sizes (the JAX dry run's condition)
    if n % 2 == 0:
        mesh_tp = make_mesh(n, model_parallel=2)
        st = shard_train_state(fresh(), mesh_tp)
        finite_loss("tensor_parallel", make_train_step_tp(model, st.optimizer, mesh_tp, st),
                    st, tokens, gen())
        local = model.net.backbone.layers[0].linear1.weight.shape[0]
        full = init["backbone.layers.0.linear1.weight"].shape[0]
        if local != full // 2:
            raise AssertionError(f"linear1 holds {local} of {full} hidden units")
        out["tp_linear1_rows"] = [local, full]

    # 5. batch-sharded FIDNetV3 features
    torch.manual_seed(3)
    tok = model.tokenizer
    fidnet = FIDNetV3(num_labels=tok.N_category, max_bbox=tok.max_elements, device=device)
    extract = make_feature_extractor(fidnet)
    rows = shard_batch(batch, mesh)
    own = run("features", lambda: extract(rows["bbox"], rows["label"], rows["mask"]))
    feats, out["feature_ranks"] = gather_rows(own, mesh)
    if (feats.shape != (B, fidnet.d_model) or sorted(out["feature_ranks"]) != list(range(n))
            or not bool(torch.isfinite(feats).all())):
        raise AssertionError(f"features {tuple(feats.shape)} from ranks {out['feature_ranks']}")
    if lead:
        with _threads(n):
            want = extract(batch["bbox"], batch["label"], batch["mask"])
        out["feature_max_abs_err"] = (feats - want).abs().max().item()
        if not out["feature_max_abs_err"] <= FEATURE_TOL:
            raise AssertionError(f"features differ from one process's by "
                                 f"{out['feature_max_abs_err']}")

    out["launches"] = {k: sum(v[k] for v in launches.values()) for k in ("K1", "K2")}
    losses = out["losses"]
    out["summary"] = (
        f"dryrun_multichip({n}) ok: flagship train loss={losses['data_parallel']:.4f} "
        f"(data parallel, = train_step) / {losses['shard_map']:.4f} (shard_map; differs "
        f"by design — each shard's seed draws its own noise, equality is pinned by "
        f"tests/test_torch_parallel.py::test_shardmap_lt_state_equals_host_simulation)"
        + (f" / {losses['tensor_parallel']:.4f} (tp x dp)" if n % 2 == 0 else "")
        + f", sampler sharded over {len(out['chain_ranks'])} devices, eval features "
        f"sharded over {len(out['feature_ranks'])}"
    )
    return out


def _rank(rank: int, world: int, device_type: str, work_dir: str) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        # a child process does not inherit the parent's flags
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        torch.set_num_threads(1)
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=f"file://{work_dir}/store",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = _dryrun(world, device)
        if rank == 0:
            print(out["summary"], flush=True)
            with open(os.path.join(work_dir, "result.json"), "w") as f:
                json.dump(out, f)
        dist.barrier(device_ids=[rank] if device_type == "cuda" else None)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> Dict:
    """The flagship-scale dry run over ``n_devices`` spawned ranks (module
    docstring): NCCL with one GPU a rank on the card, gloo on the CPU
    (``device="cpu"``).  Raises without CUDA, or when the host has fewer
    GPUs than ranks; never falls back to the CPU."""
    device = require_device(device)
    if n_devices < 1:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need {n_devices} GPUs, the host has "
                         f"{torch.cuda.device_count()}: NCCL runs one GPU a rank")
    with tempfile.TemporaryDirectory() as work_dir:
        mp.spawn(_rank, args=(n_devices, device.type, work_dir), nprocs=n_devices, join=True)
        with open(os.path.join(work_dir, "result.json")) as f:
            return json.load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_devices", type=int, default=1)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    print(json.dumps(dryrun_multichip(a.n_devices, a.device)))
    return 0


if __name__ == "__main__":
    # through the module's own name, so the spawned ranks unpickle `_rank`
    from layoutdm_tpu_torch import graft_entry

    sys.exit(graft_entry.main())
