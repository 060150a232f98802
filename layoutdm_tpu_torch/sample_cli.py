"""Batch sampling CLI over a dataset split (port of
``layoutdm_tpu/sample_cli.py``; reference `src/trainer/trainer/test.py`).

    python -m layoutdm_tpu_torch.sample_cli job_dir=<dir> result_dir=<dir> \
        cond=unconditional|c|cwh|partial|refinement|relation [k=v ...] [device=cpu]

Loads a job of the port's trainer (``config.json`` + ``params.pt`` [+
``aux_state.pt``], or ``seed_*`` subdirectories of such jobs) of any family
`factory.build_model` builds (LayoutDM, VQDiffusion, MaskGIT, BLT, RUITE,
the autoregressive model, BART, DiffusionLM, BitDiffusion), builds the
task's condition for every batch of the test split
(``is_validation=true``: the val split), runs
the reverse chain, timed (``ms per sample``, as `test.py:270-271`), and
writes ``{results, inputs, train_cfg, test_cfg, ms_per_sample
[, violation_rate]}`` to ``<result_dir>/<cond>_<split>_seed_<i>.pkl``, the
JAX CLI's file names and keys.  ``k=v`` are `configs.TestConfig` fields;
``trace_dir=<dir>`` traces the sampling with ``torch.profiler`` into a
Chrome trace under ``<dir>`` (`utils.profiling.maybe_trace`).
The device is CUDA unless ``device=cpu`` is given, and the CLI raises
without CUDA.  The denoiser path follows the JAX package's switches in the
environment (``LAYOUTDM_TPU_ATTN_V2=1``, ``LAYOUTDM_TPU_SMAJOR=1``,
``LAYOUTDM_TPU_FUSED_BLOCK=1``, ``LAYOUTDM_TPU_FUSED_FFN=1``; see
`factory.build_model`).

Relation-constrained generation adds the canvas element and samples
relations (``AddCanvasElement``, ``AddRelationConstraints(edge_ratio=0.1,
seed=0)``), guides the chain with them (`relation.guidance`) and reports
the share of those relations the generated layouts break; the zoo's
samplers take no guidance and ignore it, as in the JAX package.  The
trainer's aux state is loaded where the job has one: MaskGIT and BLT draw
the element counts of unconditional layouts from it.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import pickle
import time
from typing import Dict, List

import numpy as np
import torch

from layoutdm_tpu_torch.configs import (
    TestConfig,
    apply_overrides,
    build_sampling_config,
    to_dict,
)
from layoutdm_tpu_torch.data.datasets import load_dataset
from layoutdm_tpu_torch.data.loader import batch_iterator, split_num_samples
from layoutdm_tpu_torch.data.transforms import AddCanvasElement, compose_transform
from layoutdm_tpu_torch.eval.metrics import compute_violation
from layoutdm_tpu_torch.factory import build_model, build_tokenizer
from layoutdm_tpu_torch.relation.guidance import RelationData, make_relation_guidance
from layoutdm_tpu_torch.tasks import get_cond, to_sampler_cond
from layoutdm_tpu_torch.utils.device import require_device
from layoutdm_tpu_torch.utils.params import (
    CONFIG_FILE,
    job_path,
    load_aux_state,
    load_job,
    path_exists,
)
from layoutdm_tpu_torch.utils.profiling import maybe_trace

logger = logging.getLogger(__name__)

RELATION_TRANSFORMS = ["AddCanvasElement", "AddRelationConstraints(edge_ratio=0.1, seed=0)"]


def resolve_seed_dirs(job_dir: str) -> List[str]:
    if path_exists(job_path(job_dir, CONFIG_FILE)):
        return [job_dir]
    subs = sorted(glob.glob(os.path.join(job_dir, "seed_*")))
    if subs:
        return subs
    raise FileNotFoundError(f"no config.json under {job_dir}")


def _filter_invalid(layouts: Dict[str, torch.Tensor]):
    """Decoded batch -> list of (bbox float32 (n, 4), label int32 (n,)) of
    the valid elements (`test.py:42-49`), the JAX CLI's types."""
    bbox = layouts["bbox"].cpu().numpy().astype(np.float32)
    label = layouts["label"].cpu().numpy().astype(np.int32)
    mask = layouts["mask"].cpu().numpy()
    return [(bbox[i][mask[i]], label[i][mask[i]]) for i in range(bbox.shape[0])]


def run_sampling(test_cfg: TestConfig, seed_dir: str, device="cuda") -> Dict:
    device = require_device(device)
    train_cfg, state_dict = load_job(seed_dir)
    if test_cfg.dataset_dir:
        train_cfg.dataset.dir = test_cfg.dataset_dir
    train_cfg.data.pad_until_max = True  # `test.py:100`

    tokenizer = build_tokenizer(train_cfg)
    model = build_model(train_cfg, tokenizer, device)
    model.net.load_state_dict(state_dict)
    state = load_aux_state(model.init_state(), seed_dir)
    logger.info("denoiser: %s on %s", model.denoiser_path, device)
    sampling = build_sampling_config(test_cfg, train_cfg)

    split = "val" if test_cfg.is_validation else "test"
    train_cfg.dataset.ensure_registered()
    data = load_dataset(
        train_cfg.dataset.name, train_cfg.dataset.dir, split,
        train_cfg.dataset.max_seq_length,
    )
    if test_cfg.debug_num_samples > 0:
        n = test_cfg.debug_num_samples
        data = type(data)(data.name, data.bbox[:n], data.label[:n], data.mask[:n], data.labels)

    # the chain's noise on the model's device; the conditions' draws
    # (partial, refinement) on the CPU, as `tasks.get_cond` takes them
    gen = torch.Generator(device=device).manual_seed(train_cfg.seed)
    cond_gen = torch.Generator().manual_seed(train_cfg.seed)
    rng_np = np.random.RandomState(train_cfg.seed)
    B = test_cfg.max_batch_size
    results, inputs, violations = [], [], []
    t_total, n_total = 0.0, 0

    def timed(fn):
        nonlocal t_total, n_total
        t0 = time.perf_counter()
        layouts = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_total += time.perf_counter() - t0
        n_total += layouts["bbox"].shape[0]
        results.extend(_filter_invalid(layouts))
        return layouts

    # a profiler trace of the sampling, where trace_dir asks for one
    with maybe_trace(test_cfg.trace_dir):
        if test_cfg.cond == "unconditional":
            sizes = split_num_samples(test_cfg.num_uncond_samples, B)
            if test_cfg.warmup and sizes:
                # kernel builds and allocator warm-up outside the timed region
                model.sample(gen, sizes[0], sampling=sampling, state=state)
            for n in sizes:
                timed(lambda: model.sample(gen, n, sampling=sampling, state=state))
        else:
            relation = test_cfg.cond == "relation"
            transform = compose_transform(RELATION_TRANSFORMS) if relation else None
            # one guidance closure; each batch's graphs ride in its cond
            guidance = make_relation_guidance(
                tokenizer, sampling, generator=torch.Generator(device=device).manual_seed(0)
            ) if relation else None
            # num_run > 1: several outputs per condition (`hydra_configs.py:17`)
            batches = [
                b
                for _ in range(max(test_cfg.num_run, 1))
                for b in batch_iterator(data, B, rng_np, shuffle=False, drop_last=False)
            ]
            warmed = set()
            for batch in batches:
                cond = get_cond(batch, tokenizer, test_cfg.cond,
                                model_type=train_cfg.model.name, generator=cond_gen)
                sc = to_sampler_cond(cond, tokenizer, sampling)
                if relation:
                    graph = transform(rng_np, dict(batch))
                    sc.relation = RelationData.from_batch(graph)
                n = batch["label"].shape[0]

                def run(rng):
                    return model.sample(rng, n, cond=sc, sampling=sampling, guidance_fn=guidance,
                                        state=state)

                if test_cfg.warmup and n not in warmed:
                    run(torch.Generator(device=device).manual_seed(0))
                    warmed.add(n)
                layouts = timed(lambda: run(gen))
                if test_cfg.cond in ("partial", "refinement"):
                    seq = torch.as_tensor(cond["seq"])
                    if "bos" in tokenizer.special_tokens:  # decode takes the ids after BOS
                        seq = seq[:, 1:]
                    inputs.extend(_filter_invalid(tokenizer.decode(seq)))
                if relation:
                    # the generated boxes behind the canvas, for the violation check
                    S1 = graph["bbox"].shape[1]
                    gen_bbox = np.zeros((n, S1, 4), np.float32)
                    gen_bbox[:, 0] = AddCanvasElement.x
                    gen_bbox[:, 1:] = layouts["bbox"].cpu().numpy()[:, : S1 - 1]
                    v = compute_violation(gen_bbox, graph["label"], graph["edge_index"],
                                          graph["edge_attr"], graph["edge_mask"])
                    violations.extend(v[~np.isnan(v)].tolist())

    ms_per_sample = 1e3 * t_total / max(n_total, 1)
    logger.info("%s: %.1f ms per sample", test_cfg.cond, ms_per_sample)
    out = {
        "results": results,
        "inputs": inputs,
        "train_cfg": to_dict(train_cfg),
        "test_cfg": to_dict(test_cfg),
        "ms_per_sample": ms_per_sample,
    }
    if violations:
        out["violation_rate"] = float(np.mean(violations))
        logger.info("violation rate: %.4f", out["violation_rate"])
    return out


def main(argv=None) -> List[str]:
    """Run the CLI; returns the pickles written."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(
        description="sample: layoutdm_tpu_torch.sample_cli job_dir=<dir> "
        "result_dir=<dir> cond=<task> [k=v ...] [device=cuda|cpu]"
    )
    p.add_argument("overrides", nargs="*", help="key=value TestConfig fields")
    a = p.parse_args(argv)
    device = "cuda"
    overrides = []
    for o in a.overrides:
        if o.startswith("device="):
            device = o.split("=", 1)[1]
        else:
            overrides.append(o)
    device = require_device(device)
    cfg = TestConfig()
    apply_overrides(cfg, overrides)
    if not cfg.job_dir:
        p.error("job_dir=<job directory> is required")
    os.makedirs(cfg.result_dir, exist_ok=True)
    paths = []
    for i, seed_dir in enumerate(resolve_seed_dirs(cfg.job_dir)):
        out = run_sampling(cfg, seed_dir, device)
        split = "val" if cfg.is_validation else "test"
        path = os.path.join(cfg.result_dir, f"{cfg.cond}_{split}_seed_{i}.pkl")
        with open(path, "wb") as f:
            pickle.dump(out, f)
        logger.info("wrote %s (%d layouts)", path, len(out["results"]))
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
