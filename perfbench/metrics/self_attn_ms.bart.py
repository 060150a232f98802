"""Device milliseconds a decode step spends in the decoder's causal
self-attention (``layoutdm.dec_self_attention``: norm1, the cache write,
attention over the prefix, the out projection, the residual), summed
over the layers."""

from perfbench.lib.phases import ms_per_step

NAME = "self_attn_ms.bart"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "decoder: self-attention"
MOVES = "layouts_per_s"
WORKLOADS = ["bart-rico25-c-b4096"]


def read(run):
    return ms_per_step(run, "layoutdm.dec_self_attention", per="layoutdm.decode_step")
