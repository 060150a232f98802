"""Traced stretches, reduced by `yardstick.trace.reduce` to busy and
window seconds and the breakdown.

- `Stretch`: ``torch.profiler`` over CPU and CUDA activity from
  ``start()`` to ``stop()``, the window marked on the host; the idle gaps
  are named by the host op that was running.  The sampling cells trace one
  chain so.
- `traced_steps`: a loop of steps under a profiler schedule that runs the
  profiler's start-up and the first steps outside the window, and records
  device activity alone (with the CUDA calls), without the per-op capture
  on the host that would slow a host-heavy step and open gaps on the
  device that the unprofiled step does not have.  The window runs from
  the first device operation recorded to the end of the last.

Each writes its Chrome trace under a directory of the run and deletes it
once reduced."""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch

from perfbench.yardstick import trace as ytrace

WINDOW = "perfbench.window"


class Stretch:
    """``start()`` and ``stop()`` on one thread; ``stop`` returns the
    reduction."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.prof: Optional[torch.profiler.profile] = None
        self.rf = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.rf = torch.profiler.record_function(WINDOW)
        self.rf.__enter__()

    def stop(self) -> Dict:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        path = _export(self.prof, self.out_dir)
        self.prof = None
        events = ytrace.load(path)
        marks = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not marks:
            raise RuntimeError("the traced stretch left no window mark in the trace")
        m = marks[0]
        return _reduced(events, (m["ts"], m["ts"] + m["dur"]), path)


def traced_steps(out_dir: str, step: Callable[[int], None], warmup: int, active: int) -> Dict:
    """``step(k)`` for k < ``warmup + active``; the profiler keeps the last
    ``active`` steps (on a machine without CUDA: the host's ops, so that
    the reduction runs, with no device time)."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
    saved = {}
    sched = torch.profiler.schedule(wait=0, warmup=warmup, active=active, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched,
                                on_trace_ready=lambda p: saved.update(path=_export(p, out_dir))
                                ) as prof:
        for k in range(warmup + active):
            step(k)
            if k == warmup + active - 1 and cuda:
                torch.cuda.synchronize()
            prof.step()
    if "path" not in saved:
        raise RuntimeError("the profiler's schedule saved no trace")
    events = ytrace.load(saved["path"])
    ops = ytrace.device_ops(events)
    if ops:
        window = (min(e["ts"] for e in ops), max(e["ts"] + e.get("dur", 0) for e in ops))
    else:
        window = (0.0, 0.0)
    return _reduced(events, window, saved["path"], unnamed="host outside CUDA calls")


def _export(prof, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def _reduced(events, window, path: str, **kw) -> Dict:
    out = ytrace.reduce(events, window, **kw)
    out["trace_bytes"] = os.path.getsize(path)
    os.remove(path)
    return out
