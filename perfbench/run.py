"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``perfbench/cells/<cell>.json``; it names its configuration
(``perfbench/configs/<config>.json``) and its traffic module
(``perfbench/traffic/<traffic>.py``).  With ``--trace 0`` the line carries
the cell's end-to-end metrics (``BENCHMARK.json``), with ``--trace 1`` its
per-layer metrics (``perfbench/metrics/*.py`` whose ``WORKLOADS`` name the
cell) and the breakdown of a traced stretch.  The run needs as many CUDA
devices as the cell asks for and stops otherwise; it never falls back to
the CPU.  Run it from the root of a checkout.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# a library the port uses must not bring JAX in through its own imports
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from perfbench.lib import harness, registry

    cell = registry.cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: cell {a.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = harness.Context(cell=cell, cfg=registry.config(cell["config"]), seed=a.seed,
                          seconds=a.seconds, trace=bool(a.trace), device=torch.device("cuda"),
                          started=STARTED)
    out = registry.traffic(cell["traffic"]).run(ctx)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"]}
    line = harness.result_line(ctx, out, info)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
