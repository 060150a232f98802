"""Device milliseconds a reverse step of the denoiser call (``layoutdm.denoise``:
embeddings, norms, attention, FFN, head), over the ``layoutdm.step``
spans of one chain (`lib/phases.py`)."""

from perfbench.lib.phases import ms_per_step

NAME = "denoise_ms.sample"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "denoiser"
MOVES = "layouts_per_s"
WORKLOADS = ["rico25-uncond-b1024", "publaynet-e100-uncond-b256"]


def read(run):
    return ms_per_step(run, "layoutdm.denoise", per="layoutdm.step")
