"""Device milliseconds a train step of its update (``layoutdm.optimizer``:
the clip, the AdamW step), over the ``layoutdm.train_step`` spans of the
stretch (`lib/phases.py`)."""

from perfbench.lib.phases import ms_per_step

NAME = "optimizer_ms.train"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "optimizer"
MOVES = "train_samples_per_s"
WORKLOADS = ["rico25-train-b1024"]


def read(run):
    return ms_per_step(run, "layoutdm.optimizer", per="layoutdm.train_step")
