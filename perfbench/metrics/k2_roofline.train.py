"""K2's share of its roofline in the train step: the least time the
attention backward of one call could take at the call's shapes (B, S,
d_model; bf16, ``yardstick/roofline.py``) over the mean device time of
K2's kernels (a dq kernel and a dk/dv kernel) a call in the traced steps."""

import importlib.util
import os

from perfbench.reference.denoiser import widths
from perfbench.yardstick.roofline import attention_bwd, bound_ms

_spec = importlib.util.spec_from_file_location(
    "perfbench_metrics_kernels", os.path.join(os.path.dirname(__file__), "_kernels.py"))
_k = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k)

NAME = "k2_roofline.train"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernel K2"
MOVES = "train_samples_per_s"
WORKLOADS = ["rico25-train-b1024"]


def read(run):
    per_call = _k.seconds_per_call(run["trace"], _k.K2, _k.K2_FIRST)
    if per_call is None:
        return None
    c = run["counters"]
    nbytes, flops = attention_bwd(c["batch"], c["seq_len"], widths(run["cfg"])[0])
    return 100.0 * bound_ms(nbytes, flops) / (1e3 * per_call)
