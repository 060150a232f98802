"""Render CLI (port of ``layoutdm_tpu/render_cli.py``; reference
`render.py:37-227`): re-render generated layouts (and inputs for
partial/refinement) as image grids with a per-sample alignment/overlap CSV.

    python -m layoutdm_tpu_torch.render_cli <result.pkl> [--out_dir DIR] [--image_dir DIR]

Host only (PIL and numpy): it reads the pickles ``sample_cli`` of either
package writes."""

from __future__ import annotations

import argparse
import csv
import logging
import os
import pickle

import numpy as np

from layoutdm_tpu_torch.configs import train_config_from_dict
from layoutdm_tpu_torch.eval import metrics as M
from layoutdm_tpu_torch.eval_cli import pad_layout_list
from layoutdm_tpu_torch.registry import DATASET_CANVAS
from layoutdm_tpu_torch.utils.visualization import save_image

logger = logging.getLogger(__name__)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("result_path")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument(
        "--image_dir",
        default=None,
        help="directory of raw screenshots (rico 'combined/'); renders the "
        "test-split ground truth in real-image mode (`render.py` + "
        "`rico.py:178-216`)",
    )
    a = p.parse_args(argv)

    with open(a.result_path, "rb") as f:
        res = pickle.load(f)
    cfg = train_config_from_dict(res["train_cfg"])
    out_dir = a.out_dir or os.path.splitext(a.result_path)[0] + "_render"
    os.makedirs(out_dir, exist_ok=True)

    S = cfg.dataset.max_seq_length
    n_cat = cfg.dataset.num_categories  # triggers ensure_registered()
    canvas = DATASET_CANVAS.get(cfg.dataset.name, (360, 520))

    layouts = res["results"][: a.num_samples]
    bbox, label, mask = pad_layout_list(layouts, S)
    save_image(
        {"bbox": bbox, "label": label, "mask": mask},
        os.path.join(out_dir, "generated.png"),
        n_cat,
        canvas_size=canvas,
    )
    if res.get("inputs"):
        ib, il, im = pad_layout_list(res["inputs"][: a.num_samples], S)
        save_image(
            {"bbox": ib, "label": il, "mask": im},
            os.path.join(out_dir, "inputs.png"),
            n_cat,
            canvas_size=canvas,
        )

    if a.image_dir:
        # real-image GT rendering: background screenshots + cropped patches
        from layoutdm_tpu_torch.data.datasets import load_dataset
        from layoutdm_tpu_torch.utils.visualization import get_original_resources

        data = load_dataset(
            cfg.dataset.name, cfg.dataset.dir, "test", S
        )
        if data.names is None:
            logger.warning(
                "processed npz has no source names (re-ingest to enable "
                "real-image rendering); skipping"
            )
        else:
            k = min(a.num_samples, 16, len(data))
            gt_bbox = [data.bbox[i][data.mask[i]] for i in range(k)]
            resources = get_original_resources(
                a.image_dir, [str(n) for n in data.names[:k]], gt_bbox
            )
            save_image(
                {
                    "bbox": data.bbox[:k],
                    "label": data.label[:k],
                    "mask": data.mask[:k],
                },
                os.path.join(out_dir, "real_gt.png"),
                n_cat,
                canvas_size=canvas,
                batch_resources=resources,
            )
            logger.info("real-image GT grid -> %s/real_gt.png", out_dir)

    # per-sample CSV (`render.py:222-225`)
    align = M.compute_alignment(bbox, mask)
    over = M.compute_overlap(bbox, mask)
    with open(os.path.join(out_dir, "scores.csv"), "w", newline="") as f:
        w = csv.writer(f)
        keys = list(align) + list(over)
        w.writerow(["index"] + keys)
        for i in range(bbox.shape[0]):
            w.writerow(
                [i]
                + [f"{align[k][i]:.4f}" for k in align]
                + [f"{over[k][i]:.4f}" for k in over]
            )
    logger.info("rendered %d layouts to %s", len(layouts), out_dir)


if __name__ == "__main__":
    main()
