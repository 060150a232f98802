"""The whole chain's share of the card's bf16 peak: the analytic FLOPs of
a layout (``yardstick/encdec.py``: the encoder once, the cross keys and
values, 125 decode steps with attention over the prefix and the memory,
the heads) times the run's layouts per second (measured by the window,
outside the profiled stretch) over 989 TFLOP/s."""

from perfbench.yardstick.encdec import flops_per_layout
from perfbench.yardstick.peaks import PEAK_BF16_FLOPS

NAME = "mfu.bart"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "layouts_per_s"
WORKLOADS = ["bart-rico25-c-b4096"]


def read(run):
    rate = run["counters"].get("layouts_per_s")
    if not rate:
        return None
    return 100.0 * flops_per_layout(run["cfg"]) * rate / PEAK_BF16_FLOPS
