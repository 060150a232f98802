"""Profiling hooks (port of ``layoutdm_tpu/utils/profiling.py``): the
reference's wall-clock throughput counters (`test.py:270-271`) and an
optional ``torch.profiler`` trace around a region, written as a Chrome
trace that Perfetto and TensorBoard read.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Trace the region's CPU and CUDA activity into
    ``<trace_dir>/trace_<pid>.json`` when a directory is given; with none,
    do nothing.  The profiler leaves grad mode as the caller set it (a
    guided chain runs under ``torch.no_grad``, the others under
    ``torch.inference_mode``)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))


class Throughput:
    """Accumulates (items, seconds) and reports items/sec + ms/item."""

    def __init__(self):
        self.items = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n: int):
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0
        self.items += n

    @property
    def items_per_sec(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    @property
    def ms_per_item(self) -> float:
        return 1e3 * self.seconds / self.items if self.items else 0.0
