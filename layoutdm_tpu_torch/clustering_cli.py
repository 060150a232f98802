"""Fit per-coordinate clusters for bbox quantization (the port's counterpart
of ``bin/clustering_coordinates.py``; reference
`bin/clustering_coordinates.py:1-71`).

    python -m layoutdm_tpu_torch.clustering_cli <dataset> [--data_dir D] [--out_dir O]
        [--max_seq_length S] [--algorithm kmeans|percentile] [--max_points N] [--seed K]

Fits 1-D clusters of each box coordinate for n_clusters in {2, 4, ..., 256}
on the train split (subsampled to ``--max_points`` boxes) with the port's
`tokenizer.clustering`, and writes
``{dataset}_max{S}_{algorithm}_train_clusters.npz`` under ``--out_dir``,
the file `tokenizer.bbox` and the JAX package read.  Host-only: numpy.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from layoutdm_tpu_torch.data.datasets import load_dataset
from layoutdm_tpu_torch.tokenizer.clustering import fit_coordinate_clusters


def main(argv: Optional[List[str]] = None) -> str:
    """Run the CLI; returns the path written."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("dataset")
    p.add_argument("--data_dir", default="download/datasets")
    p.add_argument("--out_dir", default="download/clustering_weights")
    p.add_argument("--max_seq_length", type=int, default=25)
    p.add_argument("--algorithm", choices=["kmeans", "percentile"], default="kmeans")
    p.add_argument("--max_points", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)

    data = load_dataset(a.dataset, a.data_dir, "train", a.max_seq_length)
    boxes = data.bbox[data.mask]
    n_list = [2**i for i in range(1, 9)]  # 2..256, as the reference
    fitted = fit_coordinate_clusters(boxes, n_list, a.algorithm, a.max_points, a.seed)
    os.makedirs(a.out_dir, exist_ok=True)
    out = os.path.join(
        a.out_dir, f"{a.dataset}_max{a.max_seq_length}_{a.algorithm}_train_clusters.npz"
    )
    np.savez(out, **fitted)
    print(f"wrote {out} ({len(fitted)} center sets)")
    return out


if __name__ == "__main__":
    main()
