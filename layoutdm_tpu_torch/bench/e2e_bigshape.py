"""PubLayNet-scale pipeline: train, sample every task and score at
max_elements=100 (S=500 tokens) on synthetic data (port of
``bin/e2e_bigshape.py``).

    python -m layoutdm_tpu_torch.bench.e2e_bigshape [--out DIR] [--epochs 2]

The flagship LayoutDM trains ``--epochs`` epochs at batch 16 on the
synthetic dataset at 100 elements (`train.loop.train`), samples 32
layouts of each of the six tasks at T=20 through the batch CLI
(`sample_cli.main`; relation guidance included), and scores the six
pickles (`eval_cli.evaluate_results`; without FID, as the JAX script:
the repo carries no ``synthetic-max100`` extractor).
Everything goes under ``--out``: the job, the datasets, the pickles and
``summary.json``, whose keys are the JAX script's.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict, Sequence

import numpy as np

from layoutdm_tpu_torch.bench.common import DEFAULT_OUT, card, emit, require_device, row

TASKS = ("unconditional", "c", "cwh", "partial", "refinement", "relation")


def run(out: str = os.path.join(DEFAULT_OUT, "e2e_bigshape"), epochs: int = 2,
        batch_size: int = 16, num_samples: int = 32, num_timesteps: int = 20,
        max_elements: int = 100, device="cuda", overrides: Sequence[str] = ()) -> Dict:
    """The pipeline's summary, its one run the seconds of the whole;
    ``overrides`` (``key=value`` config fields) shrink the model for a CPU
    rehearsal."""
    from layoutdm_tpu_torch.configs import build_train_config
    from layoutdm_tpu_torch.eval_cli import evaluate_results, print_scores
    from layoutdm_tpu_torch.sample_cli import main as sample_main
    from layoutdm_tpu_torch.train.loop import train

    device = require_device(device)
    info = card(device)
    job_dir = os.path.join(out, "job")
    if os.path.exists(job_dir):  # the trainer would resume it
        raise FileExistsError(f"{job_dir} exists: give the pipeline a fresh --out")
    t0 = time.perf_counter()
    cfg = build_train_config("layoutdm", "synthetic", [
        f"job_dir={job_dir}", f"dataset.dir={out}/datasets",
        f"dataset.max_seq_length={max_elements}", f"training.epochs={epochs}",
        f"data.batch_size={batch_size}", "seed=0", *overrides,
    ])
    result = train(cfg, device=device)
    train_s = time.perf_counter() - t0
    if not np.isfinite(result["best_val_loss"]):
        raise AssertionError(f"trainer result {result}")
    summary = {
        "max_elements": max_elements,
        "seq_tokens": max_elements * 5,  # category + 4 box tokens an element
        "epochs": epochs,
        "train_s": train_s,
        "best_val_loss": float(result["best_val_loss"]),
        "tasks": {},
    }

    result_dir = os.path.join(out, "results")
    for task in TASKS:
        t1 = time.perf_counter()
        args = [f"job_dir={job_dir}", f"result_dir={result_dir}", f"cond={task}",
                f"num_timesteps={num_timesteps}", f"max_batch_size={num_samples}",
                f"device={device}"]
        if task == "unconditional":
            args.append(f"num_uncond_samples={num_samples}")
        else:
            args.append(f"debug_num_samples={num_samples}")
        sample_main(args)
        summary["tasks"][task] = {"sample_s": time.perf_counter() - t1}
    pkls = sorted(glob.glob(os.path.join(result_dir, "*.pkl")))
    if len(pkls) < len(TASKS):
        raise AssertionError(f"{len(pkls)} pickles for {len(TASKS)} tasks: {pkls}")

    t2 = time.perf_counter()
    scores = evaluate_results(pkls, device=device)
    print_scores(scores)
    summary["eval_s"] = time.perf_counter() - t2
    summary["metrics"] = {k: float(np.mean(v)) for k, v in sorted(scores.items())}
    summary["artifacts"] = {"job_dir": job_dir, "pickles": len(pkls)}
    summary = row(device, info, [time.perf_counter() - t0], "s", **summary)
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return emit(summary)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(DEFAULT_OUT, "e2e_bigshape"))
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--num_samples", type=int, default=32)
    ap.add_argument("--num_timesteps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value config fields")
    a = ap.parse_args(argv)
    return run(a.out, a.epochs, a.batch_size, a.num_samples, a.num_timesteps,
               device=a.device, overrides=a.overrides)


if __name__ == "__main__":
    main()
