"""The cached decode step's share of its roofline: the least time a step
of the cell's batch could take (``yardstick/encdec.py``
``decode_step_work``: the decoder's weights once, the self keys and
values up to the step's position, the cross keys and values, the step's
logits, in bf16 over 3.35 TB/s, or its operations over the bf16 peak,
whichever is larger) over the mean device time of ``layoutdm.decode_step``."""

from perfbench.lib.phases import ms_per_step
from perfbench.yardstick.encdec import decode_step_work
from perfbench.yardstick.roofline import bound_ms

NAME = "decode_roofline.bart"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "decode step"
MOVES = "layouts_per_s"
WORKLOADS = ["bart-rico25-c-b4096"]


def read(run):
    ms = ms_per_step(run, "layoutdm.decode_step", per="layoutdm.decode_step")
    if not ms:
        return None
    return 100.0 * bound_ms(*decode_step_work(run["cfg"], run["counters"]["batch"])) / ms
