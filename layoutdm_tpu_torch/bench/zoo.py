"""Sampling throughput of every model family, the flagship's T ladder and
its relation-guided chain (port of ``bin/bench_zoo.py``).

    python -m layoutdm_tpu_torch.bench.zoo [--batch 256] [--iters 10] [--out DIR]

(``--batch`` and ``--iters`` are the JAX script's ``ZOO_BATCH`` and
``ZOO_ITERS``.)

One method for all: ``sample_ids`` at B=256 on the synthetic dataset's
shapes (5 categories, 25 elements), random sampler, untrained weights
from a seed (throughput does not depend on weight values), bf16
activations (the JAX bench keeps the overlays' float32 default, which the
TPU's matrix unit multiplies at bf16 precision unless asked otherwise).
A run is ``--iters`` sampling calls, host clock around them ending in a
synchronise; one warm-up run, then 3 timed runs; ``ms_per_batch`` is the
median run over ``--iters``.

- the nine overlays of `EXPERIMENTS`, unconditional (RUITE refines a
  random layout: its unconditional output is a constant dummy);
- the flagship LayoutDM at T_eval = 25, 50 and 100 (the service's
  ``timestep_ladder``);
- the flagship guided by relations (`relation.guidance`: a few gradient
  steps on the log-probs at each step from t = 10), against the
  unconditional T=100 row.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from layoutdm_tpu_torch.bench.common import (
    DEFAULT_OUT,
    card,
    emit,
    random_layouts,
    require_device,
    row,
    timed_runs,
    write_rows,
)
from layoutdm_tpu_torch.configs import SamplingConfig, build_train_config

EXPERIMENTS = (
    "layoutdm",
    "vqdiffusion",
    "maskgit_cvpr2022",
    "blt_eccv2022",
    "layout_transformer_iccv2021",
    "bart",
    "ruite",
    "diffusionlm_neurips2022",
    "bitdiffusion",
)
LADDER = (25, 50, 100)


def build(experiment: str, device, overrides: Sequence[str] = ()):
    from layoutdm_tpu_torch.factory import build_model, build_tokenizer

    cfg = build_train_config(experiment, "synthetic", ["model.dtype=bfloat16", *overrides])
    tokenizer = build_tokenizer(cfg)
    model = build_model(cfg, tokenizer, device, generator=torch.Generator().manual_seed(0))
    model.net.eval()
    return cfg, model


def timed_sampling(sample: Callable[[torch.Generator], object], batch: int, iters: int,
                   runs: int, device, info: Dict, **fields) -> Dict:
    """A row of ``runs`` runs of ``iters`` calls of ``sample(generator)``."""
    def run(i):
        for k in range(iters):
            sample(torch.Generator(device=device).manual_seed(1000 * i + k))

    sec = [s / iters for s in timed_runs(run, runs, warmup=1, device=device)["runs"]]
    ms = 1e3 * statistics.median(sec)
    return row(device, info, [1e3 * s for s in sec], "ms per batch", metric="zoo",
               batch=batch, iters=iters, ms_per_batch=ms, layouts_per_sec=1e3 * batch / ms,
               **fields)


def relation_cond(model, cfg, batch: int, sampling: SamplingConfig, device):
    """Random layouts of ``cfg``'s shape conditioned on the relation task,
    with their relation graphs (10% of the pairs, as ``sample_cli``)."""
    from layoutdm_tpu_torch.data.transforms import compose_transform
    from layoutdm_tpu_torch.relation.guidance import RelationData
    from layoutdm_tpu_torch.tasks import get_cond, to_sampler_cond

    rs = np.random.RandomState(0)
    lay = random_layouts(rs, batch, cfg.dataset.max_seq_length, cfg.dataset.num_categories)
    lay["bbox"] = np.concatenate([rs.uniform(0.2, 0.8, (batch, lay["bbox"].shape[1], 2)),
                                  rs.uniform(0.05, 0.4, (batch, lay["bbox"].shape[1], 2))],
                                 axis=-1).astype(np.float32)
    cond = to_sampler_cond(get_cond(lay, model.tokenizer, "relation",
                                    generator=torch.Generator().manual_seed(3)),
                           model.tokenizer, sampling)
    transform = compose_transform(
        ["AddCanvasElement", "AddRelationConstraints(edge_ratio=0.1, seed=0)"])
    cond.relation = RelationData.from_batch(transform(rs, dict(lay)))
    return cond.to(device)


def run(device="cuda", batch: int = 256, iters: int = 10, runs: int = 3,
        experiments: Sequence[str] = EXPERIMENTS, ladder: Sequence[int] = LADDER,
        relation: bool = True, overrides: Sequence[str] = (), out: str = DEFAULT_OUT
        ) -> List[Dict]:
    """The zoo's rows; ``overrides`` (``key=value``, every overlay) shrink
    the models for a CPU rehearsal."""
    from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond
    from layoutdm_tpu_torch.relation.guidance import make_relation_guidance

    device = require_device(device)
    info = card(device)
    sampling = SamplingConfig(name="random")
    rows = []
    for name in experiments:
        cfg, model = build(name, device, overrides)
        state = model.init_state()
        cond = None
        if name == "ruite":
            cond = SamplerCond.empty(batch, model.seq_len, device)
            cond.seq = torch.randint(0, model.num_classes, (batch, model.seq_len),
                                     generator=torch.Generator().manual_seed(9)).to(device)
        rows.append(emit(timed_sampling(
            lambda g: model.sample_ids(g, batch, cond=cond, sampling=sampling, state=state),
            batch, iters, runs, device, info, experiment=name)))
        del model

    cfg, model = build("layoutdm", device, overrides)
    for t_eval in ladder:
        rows.append(emit(timed_sampling(
            lambda g: model.sample_ids(g, batch, sampling=sampling, num_timesteps_eval=t_eval),
            batch, iters, runs, device, info, experiment="layoutdm", t_eval=t_eval,
            path=model.denoiser_path)))
    if relation:
        cond = relation_cond(model, cfg, batch, sampling, device)
        guidance = make_relation_guidance(
            model.tokenizer, sampling, generator=torch.Generator(device=device).manual_seed(0))
        rows.append(emit(timed_sampling(
            lambda g: model.sample_ids(g, batch, cond=cond, sampling=sampling,
                                       guidance_fn=guidance),
            batch, iters, runs, device, info, experiment="layoutdm+relation_guidance",
            path=model.denoiser_path)))
    write_rows(out, "zoo", rows)
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=DEFAULT_OUT)
    a = ap.parse_args(argv)
    return run(a.device, a.batch, a.iters, out=a.out)


if __name__ == "__main__":
    main()
