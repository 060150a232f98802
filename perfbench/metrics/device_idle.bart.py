"""Share of the traced stretch (one chain) in which no operation ran on
the device: 1 - union of device-op intervals / the stretch."""

NAME = "device_idle.bart"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "layouts_per_s"
WORKLOADS = ["bart-rico25-c-b4096"]


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
