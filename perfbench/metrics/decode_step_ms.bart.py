"""Device milliseconds a generated token of the cached decode
(``layoutdm.decode_step``: the decoder's layers, the head, the legality
mask, the draw and the forcing), over the steps of one chain
(`lib/phases.py`, the stretch `traffic/encdec_sample.py` records)."""

from perfbench.lib.phases import ms_per_step

NAME = "decode_step_ms.bart"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "decode step"
MOVES = "layouts_per_s"
WORKLOADS = ["bart-rico25-c-b4096"]


def read(run):
    return ms_per_step(run, "layoutdm.decode_step", per="layoutdm.decode_step")
