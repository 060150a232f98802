"""Device milliseconds a reverse step of the denoiser's attention sublayers
and their residuals (``layoutdm.attention``, every layer; K1 in them),
over the ``layoutdm.step`` spans of one chain (`lib/phases.py`)."""

from perfbench.lib.phases import ms_per_step

NAME = "attention_ms.sample"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "denoiser: attention block"
MOVES = "layouts_per_s"
WORKLOADS = ["rico25-uncond-b1024", "publaynet-e100-uncond-b256"]


def read(run):
    return ms_per_step(run, "layoutdm.attention", per="layoutdm.step")
