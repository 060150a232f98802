"""Read the numbers that ``correct`` compares over many seeds in one
process, for the program as it is or with its lower-precision control
switched on, to set each limit between the two readings.

    python3 perfbench/calibrate.py --workload <cell> --seeds 100-111 --seconds 3 \
        [--control int8|fp8] [--fault NAME] [--out FILE]

``--fault`` plants one of the traffic module's ``FAULTS`` in the program
instead.  One JSON line a seed: the compared numbers, the layouts or requests
attempted and the seconds the seed took.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def seeds(spec: str):
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    import torch

    from perfbench.lib import harness, registry

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.cell(a.workload)
    traffic = registry.traffic(cell["traffic"])
    kw = {}
    if a.control:
        kw["control"] = traffic.CONTROLS[a.control]
    if a.fault:
        kw["fault"] = traffic.FAULTS[a.fault]
    sink = open(a.out, "a") if a.out else None
    for s in seeds(a.seeds):
        t0 = time.perf_counter()
        ctx = harness.Context(cell=cell, cfg=registry.config(cell["config"]), seed=s,
                              seconds=a.seconds, trace=False, device=torch.device("cuda"),
                              started=t0)
        try:
            out = traffic.run(ctx, **kw)
            row = {"seed": s, "control": a.control, "fault": a.fault, "compared": out.compared,
                   "attempted": out.attempted, "failed": out.failed, "e2e": out.e2e}
        except Exception as e:  # a control that crashes has failed; go on
            row = {"seed": s, "control": a.control, "fault": a.fault, "error": repr(e)[:500]}
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
