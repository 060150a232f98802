"""Device milliseconds a reverse step of the denoiser's FFN blocks, ``norm2``
through the residual (``layoutdm.ffn``, every layer), over the
``layoutdm.step`` spans of one chain (`lib/phases.py`)."""

from perfbench.lib.phases import ms_per_step

NAME = "ffn_ms.sample"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "denoiser: FFN block"
MOVES = "layouts_per_s"
WORKLOADS = ["rico25-uncond-b1024", "publaynet-e100-uncond-b256"]


def read(run):
    return ms_per_step(run, "layoutdm.ffn", per="layoutdm.step")
