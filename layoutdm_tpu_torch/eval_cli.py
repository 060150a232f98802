"""Metrics CLI (port of ``layoutdm_tpu/eval_cli.py``; reference `eval.py`).

    python -m layoutdm_tpu_torch.eval_cli <result_dir> [--fid_weight_dir DIR] [--device cuda|cpu]

Loads result pickles dumped by `sample_cli` (of either package), extracts
FIDNetV3 features for the real split and each seed's generated layouts on
the card, and prints the full metric battery (FID, prdc, max-IoU, average
IoU, alignment, overlap, DocSim, Wasserstein) as mean±std CSV rows over
seeds (`eval.py:86-220`, score printing `eval.py:53-83`).  Without FIDNet
weights for the dataset FID is skipped with a warning.  Runs on CUDA
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import pickle
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from layoutdm_tpu_torch.configs import train_config_from_dict
from layoutdm_tpu_torch.data.datasets import load_dataset
from layoutdm_tpu_torch.data.loader import loader_to_list
from layoutdm_tpu_torch.eval import metrics as M
from layoutdm_tpu_torch.eval.fidnet import load_fidnet_v3, make_feature_extractor
from layoutdm_tpu_torch.utils.device import require_device

logger = logging.getLogger(__name__)


def pad_layout_list(layouts: List, S: int):
    """List of (bbox, label) -> padded dense arrays (`eval.py:28-50`)."""
    B = len(layouts)
    bbox = np.zeros((B, S, 4), np.float32)
    label = np.zeros((B, S), np.int32)
    mask = np.zeros((B, S), bool)
    for i, (b, l) in enumerate(layouts):
        n = min(len(l), S)
        bbox[i, :n] = b[:n]
        label[i, :n] = l[:n]
        mask[i, :n] = True
    return bbox, label, mask


def extract_in_batches(extract, bbox, label, mask, batch=512):
    """Features of numpy layouts, ``batch`` at a time on the extractor's
    device, back as one numpy array."""
    feats = []
    for s in range(0, bbox.shape[0], batch):
        feats.append(
            extract(
                bbox[s : s + batch], label[s : s + batch], mask[s : s + batch]
            ).cpu().numpy()
        )
    return np.concatenate(feats)


def evaluate_results(
    result_paths: List[str],
    fid_weight_dir: Optional[str] = None,
    compute_real: bool = False,
    device="cuda",
) -> Dict[str, List[float]]:
    device = require_device(device)
    with open(result_paths[0], "rb") as f:
        meta = pickle.load(f)
    train_cfg = train_config_from_dict(meta["train_cfg"])
    ds = train_cfg.dataset
    S = ds.max_seq_length

    ds.ensure_registered()
    test_data = load_dataset(ds.name, ds.dir, "test", S)
    real_layouts = loader_to_list(test_data)

    extract = None
    feats_real = None
    if fid_weight_dir:
        try:
            extract = make_feature_extractor(load_fidnet_v3(
                ds.name, len(test_data.labels), fid_weight_dir, S, device
            ))
            feats_real = extract_in_batches(
                extract, test_data.bbox, test_data.label, test_data.mask
            )
        except FileNotFoundError:
            logger.warning("no FIDNet weights under %s; skipping FID", fid_weight_dir)

    scores = defaultdict(list)
    for path in result_paths:
        with open(path, "rb") as f:
            res = pickle.load(f)
        layouts = res["results"]
        bbox, label, mask = pad_layout_list(layouts, S)

        align = M.compute_alignment(bbox, mask)
        over = M.compute_overlap(bbox, mask)
        for k, v in {**align, **over}.items():
            scores[k].append(float(np.mean(v)))
        for k, v in M.compute_average_iou(layouts).items():
            scores[k].append(v)
        if extract is not None:
            feats_fake = extract_in_batches(extract, bbox, label, mask)
            for k, v in M.compute_generative_model_scores(
                feats_real, feats_fake
            ).items():
                scores[k].append(float(v))
        cond = res.get("test_cfg", {}).get("cond", "unconditional")
        if cond != "unconditional":
            n = min(len(real_layouts), len(layouts))
            scores["maximum_iou"].append(
                M.compute_maximum_iou(real_layouts[:n], layouts[:n])
            )
            scores["DocSim"].append(
                M.compute_docsim(real_layouts[:n], layouts[:n])
            )
        for k, v in M.compute_wasserstein_distance(
            real_layouts, layouts, n_classes=len(test_data.labels)
        ).items():
            scores[k].append(v)
        if "violation_rate" in res:
            scores["violation"].append(res["violation_rate"])
        if "ms_per_sample" in res:
            scores["ms_per_sample"].append(res["ms_per_sample"])
    return dict(scores)


def print_scores(scores: Dict[str, List[float]]):
    """mean±std CSV + the paper-table LaTeX row (`eval.py:53-83`, the
    `& mean\\std{relstd}\\%` format printed at `eval.py:75`)."""
    keys = sorted(scores)
    print(",".join(keys))
    means = [np.mean(scores[k]) for k in keys]
    stds = [np.std(scores[k]) for k in keys]
    print(",".join(f"{m:.4f}±{s:.4f}" for m, s in zip(means, stds)))
    tex = ""
    for m, s in zip(means, stds):
        stdp = s * 100.0 / m if m else 0.0
        tex += f"& {m:.4f}\\std{{{stdp:.1f}}}\\% "
    print(tex + "\\\\")


def compute_real_baseline(
    dataset_name: str,
    data_dir: str,
    max_seq_length: int,
    fid_weight_dir: Optional[str] = None,
    device="cuda",
) -> Dict[str, List[float]]:
    """val-vs-test oracle baseline (`eval.py --compute_real`, SURVEY §3.3)."""
    device = require_device(device)
    val = load_dataset(dataset_name, data_dir, "val", max_seq_length)
    test = load_dataset(dataset_name, data_dir, "test", max_seq_length)
    scores = defaultdict(list)
    for k, v in {
        **M.compute_alignment(val.bbox, val.mask),
        **M.compute_overlap(val.bbox, val.mask),
    }.items():
        scores[k].append(float(np.mean(v)))
    val_list, test_list = loader_to_list(val), loader_to_list(test)
    scores["maximum_iou"].append(
        M.compute_maximum_iou(test_list, val_list)
    )
    for k, v in M.compute_wasserstein_distance(
        test_list, val_list, n_classes=len(val.labels)
    ).items():
        scores[k].append(v)
    if fid_weight_dir:
        extract = make_feature_extractor(load_fidnet_v3(
            dataset_name, len(val.labels), fid_weight_dir, max_seq_length, device
        ))
        fr = extract_in_batches(extract, test.bbox, test.label, test.mask)
        fv = extract_in_batches(extract, val.bbox, val.label, val.mask)
        for k, v in M.compute_generative_model_scores(fr, fv).items():
            scores[k].append(float(v))
    return dict(scores)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("result_dir")
    p.add_argument("--fid_weight_dir", default=None)
    p.add_argument("--cond", default=None, help="filter pickles by cond")
    p.add_argument(
        "--compute_real", action="store_true",
        help="report the val-vs-test oracle baseline instead",
    )
    p.add_argument("--dataset", default="rico25")
    p.add_argument("--data_dir", default="download/datasets")
    p.add_argument("--max_seq_length", type=int, default=25)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    require_device(a.device)
    if a.compute_real:
        scores = compute_real_baseline(
            a.dataset, a.data_dir, a.max_seq_length, a.fid_weight_dir, a.device
        )
        print_scores(scores)
        return scores
    pattern = f"{a.cond}_*seed_*.pkl" if a.cond else "*.pkl"
    paths = sorted(glob.glob(os.path.join(a.result_dir, pattern)))
    if not paths:
        p.error(f"no result pickles in {a.result_dir}")
    scores = evaluate_results(paths, a.fid_weight_dir, device=a.device)
    print_scores(scores)
    return scores


if __name__ == "__main__":
    main()
