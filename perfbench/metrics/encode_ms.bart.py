"""Device milliseconds a chain spends in ``layoutdm.encode``: the encoder
over the condition and each decoder layer's cross keys and values
projected from its memory, once a chain."""

from perfbench.lib.phases import ms_per_step

NAME = "encode_ms.bart"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "encoder"
MOVES = "layouts_per_s"
WORKLOADS = ["bart-rico25-c-b4096"]


def read(run):
    return ms_per_step(run, "layoutdm.encode", per="layoutdm.encode")
