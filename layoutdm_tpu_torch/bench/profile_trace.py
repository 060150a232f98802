"""Capture and summarise a ``torch.profiler`` trace of the flagship's
reverse chain or train step (port of ``bin/profile_trace.py``).

    python -m layoutdm_tpu_torch.bench.profile_trace [--batch 256] [--steps 100] [--top 30]
    python -m layoutdm_tpu_torch.bench.profile_trace --train [--batch 1024] [--steps 10]
    python -m layoutdm_tpu_torch.bench.profile_trace --summarize DIR   # parse only

The capture runs the chain (``--steps`` reverse steps, random sampler,
generator regime) or ``--steps`` train steps once untraced (kernel builds,
allocator), then once inside `utils.profiling.maybe_trace`, which writes a
Chrome trace ``trace_<pid>.json`` under ``--trace_dir``.  The summary reads
the newest trace there: the device time of every kernel summed by name
over the whole trace (divide by ``--steps`` for a step), its instance
count, and the aten operation that launched it (the innermost CPU
operation around the launch on the host, joined by the launch's
correlation id; ``-`` for a kernel launched outside any, as the port's
ctypes-bound CUDA kernels are).
"""

from __future__ import annotations

import argparse
import bisect
import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import torch

from layoutdm_tpu_torch.bench.common import (
    DEFAULT_OUT,
    card,
    emit,
    random_layouts,
    require_device,
    row,
    sync,
)

CARD_FILE = "card.json"  # the capture's device, card and step count, beside its trace


def capture(trace_dir: str, batch: int = 256, steps: int = 100, train: bool = False,
            device="cuda", seed: int = 0, overrides: Sequence[str] = ()) -> None:
    from layoutdm_tpu_torch.bench.headline import build_flagship, flagship_config
    from layoutdm_tpu_torch.configs import SamplingConfig
    from layoutdm_tpu_torch.utils.profiling import maybe_trace

    device = require_device(device)
    cfg = flagship_config(overrides=overrides)
    model = build_flagship(cfg, device, seed)
    if train:
        from layoutdm_tpu_torch.train.step import init_train_state, make_optimizer, train_step

        state = init_train_state(model, make_optimizer(model.net), cfg.training.grad_norm_clip)
        tokens = model.preprocess(random_layouts(np.random.RandomState(seed), batch,
                                                 cfg.dataset.max_seq_length,
                                                 cfg.dataset.num_categories))
        gen = torch.Generator(device=device).manual_seed(seed + 1)

        def work():
            for _ in range(steps):
                m = train_step(state, tokens, gen)
            float(m["loss"])
    else:
        sampling = SamplingConfig(name="random")

        def work():
            model.sample_ids(torch.Generator(device=device).manual_seed(seed), batch,
                             sampling=sampling, num_timesteps_eval=steps)
            sync(device)

    work()  # kernel builds, allocator, GEMM heuristics: outside the trace
    with maybe_trace(trace_dir):
        work()
    with open(os.path.join(trace_dir, CARD_FILE), "w") as f:
        json.dump(dict(card(device), device=device.type, steps=steps), f)


def latest_trace(trace_dir: str) -> str:
    paths = sorted(glob.glob(os.path.join(trace_dir, "trace_*.json")), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace_*.json under {trace_dir}")
    return paths[-1]


def _launching_ops(events: List[Dict]) -> Dict[int, str]:
    """Correlation id -> the innermost ``cpu_op`` around the runtime call
    that launched it, on the same host thread."""
    ops = defaultdict(list)  # (pid, tid) -> [(start, end, name)]
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("ph") == "X":
            ops[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    for spans in ops.values():
        spans.sort()
    starts = {k: [s for s, _, _ in v] for k, v in ops.items()}
    out = {}
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or "correlation" not in e.get(
                "args", {}):
            continue
        key, ts = (e["pid"], e["tid"]), e["ts"]
        spans = ops.get(key, ())
        i = bisect.bisect_right(starts.get(key, []), ts) - 1
        # the latest-starting op that still covers the launch is the innermost
        name = "-"
        while i >= 0:
            s, end, n = spans[i]
            if end >= ts:
                name = n
                break
            i -= 1
        out[e["args"]["correlation"]] = name
    return out


def summarize(trace_dir: str, top: int = 30) -> Dict:
    """Device time by kernel in the newest trace under ``trace_dir``: a
    row with the total, the kernel count and the ``top`` kernels (ms over
    the trace, instances, launching aten op), also printed as a table.
    The row names the device and card of the capture (`CARD_FILE`; for a
    trace from elsewhere, the trace's own GPU name and no power limit)."""
    path = latest_trace(trace_dir)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    try:
        with open(os.path.join(trace_dir, CARD_FILE)) as f:
            info = json.load(f)
    except FileNotFoundError:
        gpus = trace.get("deviceProperties") or []
        info = {"device": "cuda" if gpus else "cpu", "steps": None, "power_limit_w": None,
                "card": gpus[0]["name"] if gpus else "cpu"}
    steps = info["steps"]
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    launched_by = _launching_ops(events)
    ms, count, op = defaultdict(float), defaultdict(int), {}
    for e in kernels:
        name = e["name"]
        ms[name] += e.get("dur", 0) / 1e3
        count[name] += 1
        op.setdefault(name, launched_by.get(e.get("args", {}).get("correlation"), "-"))
    total = sum(ms.values())
    ranked = sorted(ms, key=lambda n: -ms[n])[:top]
    print(f"== {os.path.basename(path)}: {total:.3f} ms of kernels, {len(kernels)} launches ==")
    for name in ranked:
        print(f"  {ms[name]:10.3f} ms x{count[name]:<7} {op[name][:40]:40} {name[:110]}")
    runs = [ms[n] for n in ranked] or [0.0]
    return row(info["device"], info, runs, "ms (top kernels)", metric="trace_kernel_ms",
               trace=os.path.basename(path), trace_bytes=os.path.getsize(path),
               events=len(events), kernel_ms=total, kernels=len(kernels),
               kernel_names=len(ms), steps=steps,
               kernel_ms_per_step=total / steps if steps else None,
               top=[{"kernel": n[:160], "ms": ms[n], "count": count[n], "aten_op": op[n]}
                    for n in ranked])


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--train", action="store_true",
                    help="trace --steps train steps instead of the chain")
    ap.add_argument("--trace_dir", default=os.path.join(DEFAULT_OUT, "trace"))
    ap.add_argument("--summarize", nargs="?", const="", default=None,
                    help="parse the newest trace under this directory (default "
                         "--trace_dir) and capture nothing")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value config fields")
    a = ap.parse_args(argv)
    if a.summarize is not None:
        return emit(summarize(a.summarize or a.trace_dir, a.top))
    capture(a.trace_dir, a.batch, a.steps, a.train, a.device, overrides=a.overrides)
    return emit(summarize(a.trace_dir, a.top))


if __name__ == "__main__":
    main()
