"""Device time by program span: reduces a ``torch.profiler`` Chrome trace,
recorded with CPU and CUDA activity, to the device seconds of the
kernels, copies and fills that each of the program's spans launched.

A device operation is joined to the runtime or driver call that launched
it by ``args.correlation``, and the launch is placed in every span of the
program (a ``user_annotation`` whose name starts with ``prefix``) whose
host interval covers it, on any thread: nesting is inclusive, and the
backward's kernels, which autograd launches from a thread of its own
while the main thread sits in the step's backward span, count there.
Device time whose launch lies in no span is ``outside_s``."""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

from perfbench.yardstick.trace import _union, device_ops

PREFIX = "layoutdm."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _covers(union: List[Tuple[float, float]], starts: List[float], at: float) -> bool:
    i = bisect.bisect_right(starts, at) - 1
    return i >= 0 and at <= union[i][1]


def reduce(events: List[Dict], prefix: str = PREFIX) -> Dict:
    """``{"spans": {name: {"device_s", "count"}}, "outside_s", "device_s"}``:
    each span name's device seconds and how many times it ran, the device
    seconds launched in no span, and all device seconds."""
    intervals = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X" \
                and e["name"].startswith(prefix):
            intervals[e["name"]].append((e["ts"], e["ts"] + e.get("dur", 0)))
    unions = {n: _union(v) for n, v in intervals.items()}
    starts = {n: [s for s, _ in u] for n, u in unions.items()}
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS and e.get("ph") == "X"
                and "correlation" in e.get("args", {})}
    device_s, total, outside = Counter(), 0.0, 0.0
    for op in device_ops(events):
        seconds = op.get("dur", 0) / 1e6
        total += seconds
        at = launched.get(op.get("args", {}).get("correlation"))
        inside = [] if at is None else [n for n in unions if _covers(unions[n], starts[n], at)]
        for n in inside:
            device_s[n] += seconds
        if not inside:
            outside += seconds
    return {"spans": {n: {"device_s": device_s[n], "count": len(v)}
                      for n, v in sorted(intervals.items())},
            "outside_s": outside, "device_s": total}
