"""Training throughput of the flagship at several batch sizes (port of
``bin/bench_train.py``).

    python -m layoutdm_tpu_torch.bench.train [--out DIR] [key=value ...]

For each batch of 64, 256 and 1024 the flagship train step
(`train.step.train_step`: the importance-sampled loss, its gradient
through K1 and K2, clipping, AdamW, the Lt update) runs 3 runs of 20
steps after a warm-up run, on a fresh model and optimizer, host clock
around each run ending in a synchronise (`headline.train_row`).  A row a
batch gives samples/s
(the median run), ms a step, peak ``max_memory_allocated`` and both MFUs
(against the 989 TFLOP/s bf16 peak and the GEMM ceiling measured at that
batch).  The last row names the batch with the most samples/s.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Sequence

from layoutdm_tpu_torch.bench.common import (
    DEFAULT_OUT,
    card,
    emit,
    require_device,
    write_rows,
)
from layoutdm_tpu_torch.bench.headline import flagship_config, train_row


def run(device="cuda", batches: Sequence[int] = (64, 256, 1024), steps: int = 20,
        runs: int = 3, overrides: Sequence[str] = (),
        out: str = DEFAULT_OUT) -> List[Dict]:
    device = require_device(device)
    info = card(device)
    cfg = flagship_config(overrides=overrides)
    rows = [emit(train_row(cfg, device, info, b, steps, runs,
                           metric=f"rico25_train_samples_per_sec_chip_B{b}")) for b in batches]
    best = max(rows, key=lambda r: r["value"])
    summary = dict(best, metric="rico25_train_samples_per_sec_chip",
                   batches=[r["batch"] for r in rows])
    rows.append(emit(summary))
    if out:
        write_rows(out, "train", rows)
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("overrides", nargs="*", help="key=value config fields")
    a = ap.parse_args(argv)
    return run(a.device, overrides=a.overrides, out=a.out)


if __name__ == "__main__":
    main()
