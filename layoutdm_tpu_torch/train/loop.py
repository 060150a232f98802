"""Training loop and entry point (port of ``layoutdm_tpu/train/loop.py``;
reference `main.py:57-205`).

    python -m layoutdm_tpu_torch.train.loop <experiment> <dataset> [k=v ...] [device=cuda|cpu]

``<experiment>``: ``layoutdm``, ``vqdiffusion``, ``maskgit``, ``blt``,
``ruite``, ``autoreg``, ``bart``, ``diffusionlm``, ``bitdiffusion`` (and
their ``configs.EXPERIMENTS`` aliases; ``model.transformer_type=aggregated``
trains the aggregated LayoutDM).

Per epoch: shuffled host batches -> tokenize -> one train step per batch on
the device; the validation loss; the host-side LR schedule; best/last
checkpoints with the full train state; ``metrics.jsonl`` and TensorBoard
events under ``<job_dir>/logs``; and, every ``max(epochs // 10, 1)``
epochs when ``{fid_weight_dir}/{name}-max{S}`` exists, an FID of 256
samples against the val split (``fid_val``, ``val/fid``).  ``resume.json`` is written last and
atomically, so a job killed anywhere resumes from a consistent state.
``seed=0,1,2`` trains one job per seed into ``<job_dir>/seed_<i>``.

The device is CUDA unless ``device=cpu`` is given; without CUDA the trainer
refuses to start.  Data loading, transforms, schedulers and the events
writer are the port's copies of the JAX package's numpy-only modules.

``training.num_devices=N`` trains data-parallel over N processes, one a
device, as the JAX trainer does over an N-device mesh:

    torchrun --nproc_per_node=N -m layoutdm_tpu_torch.train.loop <experiment> <dataset> \
        training.num_devices=N [k=v ...]

Every rank reads the same batches and draws the same noise; each trains
on its rows of the batch (`train.step.make_train_step`).  The batch size
is rounded up to a multiple of N, validation tail batches that do not
split run whole on every rank, and only rank 0 writes the job directory
(checkpoints, ``metrics.jsonl``, events, FID probes).  ``num_devices``
other than 0 (the world size) or the launched world size raises.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from layoutdm_tpu_torch.configs import TrainConfig
from layoutdm_tpu_torch.data.datasets import load_dataset
from layoutdm_tpu_torch.data.loader import batch_iterator
from layoutdm_tpu_torch.data.transforms import compose_transform
from layoutdm_tpu_torch.train.schedulers import (
    build_scheduler,
    restore_scheduler_state,
    scheduler_state,
)
from layoutdm_tpu_torch.utils.tb import EventsWriter
from layoutdm_tpu_torch.factory import build_model, build_tokenizer
from layoutdm_tpu_torch.train import checkpoint as ckpt
from layoutdm_tpu_torch.parallel.mesh import batch_shards, make_mesh, replicate
from layoutdm_tpu_torch.train.step import (
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_learning_rate,
)
from layoutdm_tpu_torch.utils.device import require_device
from layoutdm_tpu_torch.utils.params import write_atomic

logger = logging.getLogger(__name__)


def _generator_states(gen: torch.Generator, rng_np: np.random.RandomState) -> Dict:
    _, keys, pos, has_gauss, cached = rng_np.get_state()
    return {
        "torch": gen.get_state(),
        "numpy_keys": torch.as_tensor(keys.astype(np.int64)),
        "numpy_pos": int(pos),
        "numpy_has_gauss": int(has_gauss),
        "numpy_cached_gaussian": float(cached),
    }


def _restore_generators(states: Dict, gen: torch.Generator,
                        rng_np: np.random.RandomState) -> None:
    gen.set_state(states["torch"])
    rng_np.set_state((
        "MT19937", states["numpy_keys"].numpy().astype(np.uint32),
        states["numpy_pos"], states["numpy_has_gauss"],
        states["numpy_cached_gaussian"],
    ))


def _render_samples(model, gen, path: str, num_categories: int, tb, epoch: int) -> None:
    """Sample 16 layouts from ``gen``; with ``tb`` (rank 0), render them."""
    from layoutdm_tpu_torch.utils.visualization import save_image

    layouts = model.sample(gen, 16)  # every rank, so that the generators stay in step
    if tb is None:
        return
    save_image({k: v.cpu().numpy() for k, v in layouts.items()}, path, num_categories)
    from PIL import Image

    with Image.open(path) as img:
        tb.image("samples", img, epoch)


def train(cfg: TrainConfig, device="cuda") -> Dict:
    device = require_device(device)
    rng_np = np.random.RandomState(cfg.seed)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)

    cfg.dataset.ensure_registered()  # custom datasets (docs/custom_dataset.md)
    train_data = load_dataset(
        cfg.dataset.name, cfg.dataset.dir, "train", cfg.dataset.max_seq_length
    )
    val_data = load_dataset(
        cfg.dataset.name, cfg.dataset.dir, "val", cfg.dataset.max_seq_length
    )
    transform = compose_transform(list(cfg.data.transforms))

    tokenizer = build_tokenizer(cfg, train_data)
    model = build_model(
        cfg, tokenizer, device, generator=torch.Generator().manual_seed(cfg.seed)
    )
    optimizer = make_optimizer(
        model.net,
        lr=cfg.optimizer.lr,
        weight_decay=cfg.training.weight_decay,
        betas=tuple(cfg.optimizer.betas),
    )
    state = init_train_state(model, optimizer, cfg.training.grad_norm_clip)
    n_params = sum(p.numel() for p in model.net.parameters())
    logger.info("params: %.2fM on %s", n_params / 1e6, device)

    # the data-parallel mesh (JAX `train/loop.py:66-71`): without a process
    # group and with num_devices 0 or 1, one process trains alone
    n_dev = cfg.training.num_devices
    mesh = make_mesh(n_dev) if dist.is_initialized() or n_dev > 1 else None
    n_data = 1 if mesh is None else batch_shards(mesh)
    is_main = mesh is None or dist.get_rank() == 0
    B = cfg.data.batch_size
    if B % n_data:
        B = (B // n_data + 1) * n_data
        logger.info("batch_size rounded to %d for %d-way DP", B, n_data)
    if mesh is not None:
        replicate(model.net.state_dict())
    train_step = make_train_step(model, optimizer, mesh)
    eval_step = make_eval_step(model, mesh)
    # unsharded step for validation tail batches that do not split
    eval_step_tail = make_eval_step(model, None)
    scheduler = build_scheduler(
        cfg.scheduler.name,
        cfg.optimizer.lr,
        warmup_epochs=cfg.scheduler.warmup_epochs,
        warmup_lr=cfg.scheduler.warmup_lr,
        factor=cfg.scheduler.factor,
        patience=cfg.scheduler.patience,
        threshold=cfg.scheduler.threshold,
        total_epochs=cfg.training.epochs,
    )

    job_dir = cfg.job_dir
    log_path = os.path.join(job_dir, "metrics.jsonl")
    tb = None  # rank 0 writes the job directory
    if is_main:
        ckpt.save_config(cfg, job_dir)
        tb = EventsWriter(os.path.join(job_dir, "logs"))
    best_val = float("inf")
    start_epoch = 0

    meta_path = os.path.join(job_dir, "resume.json")
    if os.path.exists(os.path.join(job_dir, ckpt.STATE_FILE)) and os.path.exists(meta_path):
        _restore_generators(ckpt.load_train_state(state, job_dir), gen, rng_np)
        with open(meta_path) as f:
            meta = json.load(f)
        start_epoch = meta["epoch"] + 1
        best_val = meta["best_val"]
        restore_scheduler_state(scheduler, meta.get("scheduler", {}))
        if "lr" in meta.get("scheduler", {}):
            set_learning_rate(state, meta["scheduler"]["lr"])
        logger.info("resumed from epoch %d (best_val %.4f)", start_epoch, best_val)

    epochs = 2 if cfg.debug else cfg.training.epochs
    fid_cache = {}  # FID extractor + val features, loaded once per run
    totals = {}
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        totals, n_steps = {}, 0
        for batch in batch_iterator(train_data, B, rng_np, transform, drop_last=True):
            metrics = train_step(state, model.preprocess(batch, gen), gen)
            n_steps += 1
            for k, v in metrics.items():
                # summed on the device; read once per epoch
                totals[k] = totals.get(k, 0.0) + v
            if cfg.debug and n_steps >= 2:
                break
        totals = {k: float(v) / max(n_steps, 1) for k, v in totals.items()}

        # validation (`main.py:271-294`): per-sample weighted mean
        val_losses, n_val = 0.0, 0
        for batch in batch_iterator(val_data, B, rng_np, transform, drop_last=False):
            bsz = batch["label"].shape[0]
            step_fn = eval_step if bsz % n_data == 0 else eval_step_tail
            tokens = model.preprocess(batch, gen)
            val_losses += bsz * float(step_fn(state.lt_state, tokens, gen))
            n_val += bsz
            if cfg.debug and n_val >= 2 * B:
                break
        val_loss = val_losses / max(n_val, 1)

        lr = scheduler.step(epoch, val_loss)
        set_learning_rate(state, lr)

        row = {
            "epoch": epoch,
            "lr": lr,
            "val_loss": val_loss,
            "sec": time.time() - t0,
            **{f"train_{k}": v for k, v in totals.items()},
        }
        logger.info("epoch %d: %s", epoch, row)
        if val_loss < best_val:
            best_val = val_loss
            if is_main:
                ckpt.save_params(model.net.state_dict(), job_dir, "best", state.lt_state)
        if is_main:
            with open(log_path, "a") as f:
                f.write(json.dumps(row) + "\n")
            tb.scalar("lr", lr, epoch)
            tb.scalar("val/loss", val_loss, epoch)
            for k, v in totals.items():
                tb.scalar(f"train/{k}", v, epoch)
            ckpt.save_train_state(state, job_dir, _generator_states(gen, rng_np))
            meta = {"epoch": epoch, "best_val": best_val,
                    "scheduler": scheduler_state(scheduler)}
            # the commit record of the state files above
            write_atomic(meta_path, json.dumps(meta).encode())

        interval = cfg.training.sample_plot_epoch_interval
        if interval > 0 and (epoch + 1) % interval == 0:
            try:
                _render_samples(
                    model, gen, os.path.join(job_dir, f"samples_epoch{epoch}.png"),
                    cfg.dataset.num_categories, tb, epoch,
                )
            except Exception as e:  # rendering must never kill training
                logger.warning("sample render failed: %s", e)

        # periodic FID against the val split (`main.py:153-193`), only when
        # extractor weights are available
        fid_every = max(epochs // 10, 1)
        if is_main and (epoch + 1) % fid_every == 0 and os.path.isdir(os.path.join(
            cfg.fid_weight_dir, f"{cfg.dataset.name}-max{cfg.dataset.max_seq_length}"
        )):
            try:
                # a stream of its own, so that probing leaves training's as it was
                probe_gen = torch.Generator(device=device).manual_seed(cfg.seed + epoch)
                fid = _compute_training_fid(cfg, model, probe_gen, val_data, cache=fid_cache)
                with open(log_path, "a") as f:
                    f.write(json.dumps({"epoch": epoch, "fid_val": fid}) + "\n")
                logger.info("epoch %d FID(val) %.3f", epoch, fid)
                tb.scalar("val/fid", fid, epoch)
            except Exception as e:  # as the JAX probe: a probe never kills training
                logger.warning("FID eval failed: %s", e, exc_info=True)

    result = {"best_val_loss": best_val, "final_train": totals}
    if is_main:
        tb.close()
        ckpt.save_params(model.net.state_dict(), job_dir, "final")
        with open(os.path.join(job_dir, "result.json"), "w") as f:
            json.dump(result, f)
    return result


def _compute_training_fid(cfg, model, gen, val_data, n_samples=256, cache=None) -> float:
    """In-training FID probe (`main.py:153-193`): features of ``n_samples``
    layouts sampled with ``gen`` against those of the val split.  With a
    ``cache`` dict the extractor and the val features are loaded once per
    run and reused by every later probe."""
    from layoutdm_tpu_torch.eval.fidnet import load_fidnet_v3, make_feature_extractor
    from layoutdm_tpu_torch.eval.metrics import compute_generative_model_scores
    from layoutdm_tpu_torch.eval_cli import extract_in_batches

    if cache is None:
        cache = {}
    if "extract" not in cache:
        cache["extract"] = make_feature_extractor(load_fidnet_v3(
            cfg.dataset.name, cfg.dataset.num_categories, cfg.fid_weight_dir,
            cfg.dataset.max_seq_length, device=model.device,
        ))
    extract = cache["extract"]
    if "feats_real" not in cache:
        cache["feats_real"] = extract_in_batches(
            extract, val_data.bbox, val_data.label, val_data.mask)
    layouts = {k: v.cpu().numpy() for k, v in model.sample(gen, n_samples).items()}
    feats_fake = extract_in_batches(extract, layouts["bbox"], layouts["label"], layouts["mask"])
    return float(compute_generative_model_scores(cache["feats_real"], feats_fake)["fid"])


def main(argv=None):
    import argparse

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(
        description="train: layoutdm_tpu_torch.train.loop <experiment> <dataset> "
        "[k=v ...] [device=cuda|cpu]"
    )
    p.add_argument("experiment")
    p.add_argument("dataset")
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    device = "cuda"
    overrides = []
    for o in a.overrides:
        if o.startswith("device="):
            device = o.split("=", 1)[1]
        else:
            overrides.append(o)
    require_device(device)
    launched = "LOCAL_RANK" in os.environ and not dist.is_initialized()
    if launched:  # torchrun: one process a device, the group from its environment
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl" if torch.device(device).type == "cuda" else "gloo")
    try:
        return _run(a, overrides, device)
    finally:
        if launched:
            dist.destroy_process_group()


def _run(a, overrides, device):
    import copy

    from layoutdm_tpu_torch.configs import build_train_config

    # multi-seed sweep: `seed=0,1,2` trains one job per seed into seed_<i>
    seed_ov = [o for o in overrides if o.startswith("seed=")]
    if seed_ov and "," in seed_ov[0]:
        seeds = [int(s) for s in seed_ov[0].split("=")[1].split(",")]
        rest = [o for o in overrides if not o.startswith("seed=")]
        base_cfg = build_train_config(a.experiment, a.dataset, rest)
        results = {}
        for s in seeds:
            cfg = copy.deepcopy(base_cfg)
            cfg.seed = s
            cfg.training.seed = s
            cfg.job_dir = os.path.join(base_cfg.job_dir, f"seed_{s}")
            results[s] = train(cfg, device)
        return results

    return train(build_train_config(a.experiment, a.dataset, overrides), device)


if __name__ == "__main__":
    main()
