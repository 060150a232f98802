"""The whole training step's share of the card's bf16 peak: the analytic
FLOPs of a training sample (``yardstick/flops.py``: a forward and its
backward, 3x the forward) times the window's samples per second over
989 TFLOP/s."""

from perfbench.yardstick.flops import train_flops_per_sample
from perfbench.yardstick.peaks import PEAK_BF16_FLOPS

NAME = "mfu.train"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "whole step"
MOVES = "train_samples_per_s"
WORKLOADS = ["rico25-train-b1024"]


def read(run):
    rate = run["counters"].get("train_samples_per_s")
    if not rate:
        return None
    return 100.0 * train_flops_per_sample(run["cfg"]) * rate / PEAK_BF16_FLOPS
