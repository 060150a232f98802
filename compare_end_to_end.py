"""Time two end-to-end metrics of this checkout against another checkout on
one NVIDIA GPU: unconditional sampling on the default path (B=1024, T=100,
bfloat16; `chip_smoke.phase_throughput`) and bfloat16 training at B=1024
(`chip_smoke.phase_train`, with one plain step and one profiled step).

    python3 compare_end_to_end.py --base DIR [--out FILE]

DIR is the root of another checkout of the repo, for example the parent
commit unpacked with ``git archive``.  Each measurement runs in a process of
its own, from that checkout's root, in the order base, new, new, base.
Prints the card's name and power limit, then one JSON line per run
(layouts/s, samples/s, ms per train step); ``--out`` also keeps each run's
phase lines.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

CHILD = """
import json, torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
th = c.phase_throughput()
tr = c.phase_train(plain_steps=1, profile_steps_n=1)
print("RESULT " + json.dumps({"layouts_per_s": th["layouts_per_s"],
                              "samples_per_s": tr["samples_per_s"],
                              "ms_per_step": tr["ms_per_step"]}))
"""


def run(root: pathlib.Path) -> tuple:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), proc.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="root of the checkout to compare with")
    ap.add_argument("--out", help="file for each run's phase lines")
    a = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    roots = {"base": pathlib.Path(a.base).resolve(), "new": pathlib.Path(__file__).resolve().parent}
    logs = []
    for which in ("base", "new", "new", "base"):
        result, log = run(roots[which])
        print(json.dumps({"checkout": which, **result, "nvidia_smi": smi}), flush=True)
        logs.append(f"== {which}\n{log}")
    if a.out:
        pathlib.Path(a.out).write_text("\n".join(logs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
