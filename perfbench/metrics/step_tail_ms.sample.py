"""Device milliseconds a reverse step outside the denoiser call: the
log-softmax, the posterior, the task's conditioning, the noise and the
draw (``layoutdm.step`` less ``layoutdm.denoise``; `lib/phases.py`)."""

from perfbench.lib.phases import ms_per_step

NAME = "step_tail_ms.sample"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "step tail (log-probs, posterior, conditioning, noise, draw)"
MOVES = "layouts_per_s"
WORKLOADS = ["rico25-uncond-b1024", "publaynet-e100-uncond-b256"]


def read(run):
    return ms_per_step(run, "layoutdm.step", per="layoutdm.step", minus="layoutdm.denoise")
