"""The traced stretch that the per-phase metrics read: the program's
spans (``layoutdm.*``, `layoutdm_tpu_torch.utils.profiling`) and the
device time each launched (`yardstick.spans.reduce`), over one chain at
the cell's batch (sampling) or ``STEPS`` train steps behind ``WARMUP``
(training), recorded with CPU and CUDA activity.

It runs once a traced run, when the first per-phase metric is read, on a
model built anew from the cell's configuration: by then the cell's own
stretch is reduced and its trace deleted, and the training stretch
records device activity alone, which keeps no span.  A kernel's time
depends on the shapes and not on the weights' values, so the weights and
inputs are drawn from a seed of the stretch's own."""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from typing import Callable, Dict, Optional

import numpy as np
import torch

from perfbench.lib import program, registry
from perfbench.reference import denoiser
from perfbench.reference.tokens import Vocab
from perfbench.yardstick import spans as yspans
from perfbench.yardstick import trace as ytrace

SEED = 0
WARMUP = 3
STEPS = 10


def of_run(run: Dict) -> Optional[Dict]:
    """The reduction of the run's per-phase stretch (made on the first
    call, kept in the run's trace); None where the run recorded no device
    time."""
    t = run["trace"]
    if not t or t.get("busy_s", 0) <= 0:
        return None
    if "phases" not in t:
        t["phases"] = measure(run["cfg"], run["cell"], torch.device("cuda"))
        print(f"phases: {json.dumps(t['phases'])}", file=sys.stderr)
    return t["phases"]


def ms_per_step(run: Dict, name: str, per: str, minus: Optional[str] = None) -> Optional[float]:
    """Device milliseconds of span ``name``, less those of span ``minus``,
    over the times span ``per`` ran; None where the stretch has none of
    them."""
    r = of_run(run)
    if not r:
        return None
    s = r["spans"]
    if any(k not in s for k in [name, per] + ([minus] if minus else [])) or not s[per]["count"]:
        return None
    device_s = s[name]["device_s"] - (s[minus]["device_s"] if minus else 0.0)
    return 1e3 * device_s / s[per]["count"]


def measure(cfg: Dict, cell: Dict, device) -> Dict:
    """The stretch of ``cell``'s traffic on ``device``, reduced."""
    model = program.build(cfg, denoiser.make_params(cfg, Vocab.of(cfg).size, SEED, device),
                          device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    if cell["traffic"] == "train":
        return _profiled(_train_steps(model, cfg, cell, gen), device)
    sampling = registry.traffic(cell["traffic"]).sampling()
    return _profiled(lambda: model.sample(gen, cell["batch"], sampling=sampling), device)


def _train_steps(model, cfg: Dict, cell: Dict, gen) -> Callable[[], None]:
    """``STEPS`` train steps as the cell runs them, on one batch of
    ``cell["batch"]`` layouts, behind ``WARMUP`` steps run here."""
    from layoutdm_tpu_torch.train.step import init_train_state, make_optimizer, train_step

    pc = program.train_config(cfg)
    opt = make_optimizer(model.net, pc.optimizer.lr, pc.training.weight_decay,
                         tuple(pc.optimizer.betas))
    state = init_train_state(model, opt, pc.training.grad_norm_clip)
    layouts = registry.traffic("train").pool_layouts(
        np.random.default_rng(SEED), cell["batch"], cfg["max_elements"], cfg["num_categories"])
    batch = model.preprocess(layouts, gen)
    for _ in range(WARMUP):
        train_step(state, batch, gen)

    def steps():
        for _ in range(STEPS):
            train_step(state, batch, gen)

    return steps


def _profiled(fn: Callable[[], object], device) -> Dict:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out_dir = tempfile.mkdtemp(prefix="perfbench-phases-")
    try:
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
        return yspans.reduce(ytrace.load(path))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
