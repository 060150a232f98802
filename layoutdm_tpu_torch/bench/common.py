"""What every bench entry point shares: the device guard, the card's
identity, run timing and the row format.

A row is one JSON line.  Each carries the device it ran on (``"cuda"`` or
``"cpu"``), the card's name (``"cpu"`` on the CPU) and power limit in
watts (None on the CPU), the repeated measurements it summarises
(``runs``, in ``runs_unit``) and their ``spread`` (min, quartiles, max).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from layoutdm_tpu_torch.utils.device import require_device  # noqa: F401  (re-exported)

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit (a card
# set below it runs slower under load): HBM bytes/s, and operations/s in
# bf16 on the tensor cores and in float32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the reference sampler on a CPU, measured before the JAX package existed
# (BASELINE.md, "Measured baseline"); vs_baseline is a row's value over it
CPU_REFERENCE_LAYOUTS_PER_SEC = 0.32

# where an entry point writes its rows unless given --out
DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "layoutdm_bench")

# keys a CPU row never carries: they name a rate of the card
DEVICE_ONLY_KEYS = ("achieved_tflops", "achieved_tops", "gemm_ceiling_tflops", "mfu",
                    "mfu_vs_gemm_ceiling")


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_card(device):
        torch.cuda.synchronize()


def card(device) -> Dict:
    """The card's name, power limit (W), SM clock (MHz) and temperature
    (C) as ``nvidia-smi`` reads them; on the CPU the name is ``"cpu"``
    and the rest None."""
    if not on_card(device):
        return {"card": "cpu", "power_limit_w": None, "sm_clock_mhz": None,
                "temperature_c": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[torch.device(device).index or 0]
    name, limit, clock, temp = (f.strip() for f in line.split(","))
    return {"card": name, "power_limit_w": float(limit), "sm_clock_mhz": float(clock),
            "temperature_c": float(temp)}


def spread(values: List[float]) -> Dict[str, float]:
    """Min, quartiles and max of ``values``."""
    q1, med, q3 = np.percentile(values, [25, 50, 75])
    return {"min": float(min(values)), "q1": float(q1), "median": float(med),
            "q3": float(q3), "max": float(max(values))}


def timed_runs(fn: Callable[[int], object], n: int, warmup: int = 1, device="cuda") -> Dict:
    """Host-clock seconds of ``n`` runs of ``fn(i)`` (i = the run's index,
    0 .. n-1), each ending in a synchronise, after ``warmup`` untimed runs
    (indices n, n+1, ...); every run, their median and quartiles."""
    for i in range(warmup):
        fn(n + i)
    sync(device)
    runs = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        sync(device)
        runs.append(time.perf_counter() - t0)
    return {"runs": runs, "median": statistics.median(runs), **{
        k: v for k, v in spread(runs).items() if k in ("q1", "q3")}}


def cuda_ms(fn: Callable[[], object], iters: int = 25, warmup: int = 5,
            device="cuda") -> float:
    """Median device ms of ``fn()`` over ``iters`` calls after ``warmup``
    untimed ones, CUDA events around each call (the host clock on the
    CPU)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if not on_card(device):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
            continue
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def row(device, info: Dict, runs: List[float], runs_unit: str, **fields) -> Dict:
    """A row of ``fields`` with the device, the card (``info`` from
    `card`) and its runs; a CPU row drops `DEVICE_ONLY_KEYS`."""
    dev = torch.device(device).type
    out = dict(fields)
    if dev != "cuda":
        for k in DEVICE_ONLY_KEYS:
            out.pop(k, None)
    out.update(device=dev, card=info["card"], power_limit_w=info["power_limit_w"],
               runs=list(runs), runs_unit=runs_unit, spread=spread(runs))
    return out


def emit(r: Dict) -> Dict:
    """Print ``r`` as one JSON line and return it."""
    print(json.dumps(r), flush=True)
    return r


def write_rows(out: str, name: str, rows: List[Dict]) -> str:
    """``rows`` as JSON lines in ``<out>/<name>.jsonl``; returns the path."""
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{name}.jsonl")
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path


def mfu_fields(flops_per_item: float, items_per_s: float,
               ceiling_tflops: Optional[float]) -> Dict[str, float]:
    """Achieved TFLOP/s, its share of the bf16 peak (``mfu``) and of the
    measured GEMM ceiling."""
    achieved = items_per_s * flops_per_item / 1e12
    out = {"achieved_tflops": achieved, "mfu": achieved / (PEAK_FLOPS[torch.bfloat16] / 1e12)}
    if ceiling_tflops:
        out["gemm_ceiling_tflops"] = ceiling_tflops
        out["mfu_vs_gemm_ceiling"] = achieved / ceiling_tflops
    return out


def bound(nbytes: float, flops: float, dtype=torch.bfloat16) -> Dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the dtype's peak, whichever is larger."""
    mem_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    op_ms = 1e3 * flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(mem_ms, op_ms),
            "bound_by": "bytes" if mem_ms >= op_ms else "operations",
            "bytes": nbytes, "flops": flops}


def random_layouts(rs: np.random.RandomState, batch: int, max_elements: int,
                   num_categories: int) -> Dict[str, np.ndarray]:
    """A dense layout batch: 1..max elements a row, labels and boxes
    uniform."""
    n = rs.randint(1, max_elements + 1, (batch, 1))
    return {
        "label": rs.randint(0, num_categories, (batch, max_elements)).astype(np.int32),
        "bbox": rs.rand(batch, max_elements, 4).astype(np.float32),
        "mask": np.arange(max_elements)[None] < n,
    }
