"""Device milliseconds a decode step spends in the decoder's
cross-attention over the encoder's memory (``layoutdm.cross_attention``:
norm2, the q projection, attention over the cached keys and values, the
out projection, the residual), summed over the layers."""

from perfbench.lib.phases import ms_per_step

NAME = "cross_attn_ms.bart"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "decoder: cross-attention"
MOVES = "layouts_per_s"
WORKLOADS = ["bart-rico25-c-b4096"]


def read(run):
    return ms_per_step(run, "layoutdm.cross_attention", per="layoutdm.decode_step")
