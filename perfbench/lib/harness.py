"""One run of one cell: the context a traffic module gets, and the result
line it leads to.

A traffic module's ``run(ctx)`` returns an `Outcome`: the end-to-end
values it measured by the host clock, the requests or rows attempted and
failed, the device's memory peak, the traced stretch (``--trace 1``), the
counters the per-layer metrics read, and the numbers compared for
``correct``, each beside its limit (the cell file's ``limits``)."""

from __future__ import annotations

import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from perfbench.lib import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "layoutdm_tpu")


@dataclass
class Context:
    cell: Dict
    cfg: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float  # host clock at the process's start
    root: str = registry.ROOT

    def seeds(self, n: int) -> List[int]:
        """``n`` independent 32-bit seeds derived from the run's seed."""
        return [int(s) for s in np.random.SeedSequence(self.seed).generate_state(n)]

    @property
    def limits(self) -> Dict[str, float]:
        return self.cell["limits"]


@dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    compared: Dict[str, float]
    counters: Dict = field(default_factory=dict)
    trace: Optional[Dict] = None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a JAX one or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(compared: Dict[str, float], limits: Dict[str, float]):
    """[(name, value, limit, ok)]; a number without a limit is an error."""
    out = []
    for name, value in compared.items():
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        lim = limits[name]
        out.append((name, value, lim, bool(math.isfinite(value) and value <= lim)))
    return out


def e2e_definitions(root: str = registry.ROOT) -> List[Dict]:
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as f:
        return json.load(f)["end_to_end"]


def result_line(ctx: Context, out: Outcome, device_info: Dict) -> Dict:
    """The last line of standard output (and the compared numbers, last on
    standard error)."""
    verdicts = judge(out.compared, ctx.limits)
    correct = all(ok for *_, ok in verdicts) and out.failed < out.attempted
    metrics: Dict[str, Dict] = {}
    if ctx.trace:
        for m in registry.metrics_of(ctx.cell["name"], ctx.root):
            v = m.read({"counters": out.counters, "trace": out.trace, "cfg": ctx.cfg,
                        "cell": ctx.cell})
            if v is not None:
                metrics[m.NAME] = {"value": v, "unit": m.UNIT}
    else:
        for d in e2e_definitions(ctx.root):
            if ctx.cell["name"] in d.get("workloads", [ctx.cell["name"]]):
                metrics[d["name"]] = {"value": out.e2e[d["name"]], "unit": d["unit"]}
    dev = dict(device_info, memory_peak_bytes=int(out.memory_peak_bytes))
    line = {"correct": bool(correct), "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": dev}
    if ctx.trace and out.trace is not None:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.trace["window_s"]
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["compared"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in verdicts}
    for n, v, lim, ok in verdicts:
        print(f"compared {n}: {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    return line
