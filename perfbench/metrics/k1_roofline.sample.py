"""K1's share of its roofline in the sampling chain: the least time the
attention of one call could take at the call's shapes (B, S, d_model;
bf16, ``yardstick/roofline.py``) over the mean device time of K1's kernel
a call in the traced chain."""

import importlib.util
import os

from perfbench.reference.denoiser import widths
from perfbench.yardstick.roofline import attention_fwd, bound_ms

_spec = importlib.util.spec_from_file_location(
    "perfbench_metrics_kernels", os.path.join(os.path.dirname(__file__), "_kernels.py"))
_k = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k)

NAME = "k1_roofline.sample"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernel K1"
MOVES = "layouts_per_s"
WORKLOADS = ["rico25-uncond-b1024", "publaynet-e100-uncond-b256"]


def read(run):
    per_call = _k.seconds_per_call(run["trace"], _k.K1, _k.K1)
    if per_call is None:
        return None
    c = run["counters"]
    nbytes, flops = attention_fwd(c["batch"], c["seq_len"], widths(run["cfg"])[0])
    return 100.0 * bound_ms(nbytes, flops) / (1e3 * per_call)
