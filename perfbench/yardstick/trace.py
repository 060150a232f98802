"""Reduction of a ``torch.profiler`` Chrome trace to what the benchmark
reports: device busy seconds (the union of kernel intervals), the traced
window, device time by kernel (with the aten op that launched it, as the
port's ``bench/profile_trace.summarize`` joins them), and the longest idle
gaps of the device named by what the host was doing then."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_ops(events: List[Dict]) -> List[Dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _host_ops(events: List[Dict]):
    """Host operations as (start, end, name), by start."""
    ops = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
           if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
           and e.get("ph") == "X" and not e["name"].startswith("perfbench.")]
    ops.sort()
    return ops


def _doing(ops, starts, at: float, unnamed: str) -> str:
    """The innermost host op running at ``at``: the latest-starting one
    that still covers it (``unnamed`` where none does)."""
    i = bisect.bisect_right(starts, at) - 1
    while i >= 0:
        s, e, n = ops[i]
        if e >= at:
            return n
        i -= 1
    return unnamed


def reduce(events: List[Dict], window: Tuple[float, float], top: int = 10,
           unnamed: str = "host idle") -> Dict:
    """``window``: the traced stretch (start, end) in the trace's
    microseconds.  Returns busy and window seconds, the ``top`` device
    operations by time, the ``top`` longest idle gaps by host activity
    (``unnamed`` where the trace shows none), and every kernel's total
    time and count by name."""
    lo, hi = window
    ops = [e for e in device_ops(events) if e["ts"] < hi and e["ts"] + e.get("dur", 0) > lo]
    spans = _union([(max(e["ts"], lo), min(e["ts"] + e.get("dur", 0), hi)) for e in ops])
    busy_us = sum(e - s for s, e in spans)
    by_name, count = defaultdict(float), defaultdict(int)
    for e in ops:
        by_name[e["name"]] += e.get("dur", 0) / 1e6
        count[e["name"]] += 1
    gaps = []
    prev = lo
    for s, e in spans + [(hi, hi)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host = _host_ops(events)
    starts = [o[0] for o in host]
    idle = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        idle[_doing(host, starts, (s + e) / 2, unnamed)] += (e - s) / 1e6
    ranked = sorted(by_name, key=lambda n: -by_name[n])
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (hi - lo) / 1e6,
        "device_ops": [[n[:120], by_name[n]] for n in ranked[:top]],
        "idle_gaps": [[n[:120], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        "kernel_s": dict(by_name),
        "kernel_count": dict(count),
        "launches": sum(1 for e in ops if e.get("cat") == "kernel"),
    }
