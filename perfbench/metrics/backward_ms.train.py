"""Device milliseconds a train step of its backward (``layoutdm.backward``:
the summed loss, ``zero_grad``, ``backward``, autograd's own thread
included), over the ``layoutdm.train_step`` spans (`lib/phases.py`)."""

from perfbench.lib.phases import ms_per_step

NAME = "backward_ms.train"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "train backward"
MOVES = "train_samples_per_s"
WORKLOADS = ["rico25-train-b1024"]


def read(run):
    return ms_per_step(run, "layoutdm.backward", per="layoutdm.train_step")
