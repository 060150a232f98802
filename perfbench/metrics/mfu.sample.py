"""The whole step's share of the card's bf16 peak: the analytic FLOPs of
a layout (``yardstick/flops.py``) times the run's layouts per second
(measured by the window, outside the profiled stretch) over 989 TFLOP/s."""

from perfbench.yardstick.flops import flops_per_layout
from perfbench.yardstick.peaks import PEAK_BF16_FLOPS

NAME = "mfu.sample"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "layouts_per_s"
WORKLOADS = ["rico25-uncond-b1024", "publaynet-e100-uncond-b256"]


def read(run):
    rate = run["counters"].get("layouts_per_s")
    if not rate:
        return None
    return 100.0 * flops_per_layout(run["cfg"]) * rate / PEAK_BF16_FLOPS
