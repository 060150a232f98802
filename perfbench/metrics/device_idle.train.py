"""Share of the traced stretch of training in which no operation ran on
the device: the cell's ``trace_steps`` steps after the window, behind
steps that take the profiler's start-up, with device activity alone
recorded (`lib.stretch.traced_steps`), from the first device operation to
the end of the last."""

NAME = "device_idle.train"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "train_samples_per_s"
WORKLOADS = ["rico25-train-b1024"]


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
