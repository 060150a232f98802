"""Device milliseconds a train step of its forward: timesteps, corruption,
denoiser, loss and Lt (``layoutdm.forward``), over the
``layoutdm.train_step`` spans of the stretch (`lib/phases.py`)."""

from perfbench.lib.phases import ms_per_step

NAME = "forward_ms.train"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "train forward"
MOVES = "train_samples_per_s"
WORKLOADS = ["rico25-train-b1024"]


def read(run):
    return ms_per_step(run, "layoutdm.forward", per="layoutdm.train_step")
