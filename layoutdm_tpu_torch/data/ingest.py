"""One-command dataset ingestion with schema validation and a split report
(port of ``layoutdm_tpu/data/ingest.py``, on the port's parsers and
registry):

    python -m layoutdm_tpu_torch.data.ingest rico25 --data_dir download/datasets
    python -m layoutdm_tpu_torch.data.ingest publaynet --data_dir download/datasets

Validates the raw archive is present and schema-conformant, runs the parser
(``data/datasets.py``), writes the processed `.npz` splits, and prints a
report: split sizes, label histogram, element-count stats, bbox-range
check, and output checksums.  Host only (numpy).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

from layoutdm_tpu_torch.data.datasets import SPLITS, load_dataset
from layoutdm_tpu_torch.registry import DATASET_LABELS

EXPECTED_RAW = {
    "rico25": ["rico_dataset_v0.1_semantic_annotations.zip"],
    "rico13": ["rico_dataset_v0.1_semantic_annotations.zip"],
    "rico5": ["rico_dataset_v0.1_semantic_annotations.zip"],
    "publaynet": ["train.json", "val.json"],
}


def _sha256(path: str, max_bytes: int = 1 << 26) -> str:
    """Fingerprint of the first max_bytes (full multi-GB archives would add
    seconds of pointless IO; the prefix is plenty to detect a swap)."""
    h = hashlib.sha256()
    read = 0
    with open(path, "rb") as f:
        while read < max_bytes:
            chunk = f.read(min(1 << 20, max_bytes - read))
            if not chunk:
                break
            h.update(chunk)
            read += len(chunk)
    return h.hexdigest()[:16]


def _check_raw(name: str, raw_dir: str) -> None:
    missing = [
        f
        for f in EXPECTED_RAW[name]
        if not os.path.exists(os.path.join(raw_dir, f))
    ]
    if missing:
        print(f"ERROR: missing raw file(s) under {raw_dir}: {missing}")
        print(
            "Expected layout: <data_dir>/<name>-max<S>/raw/"
            + " + ".join(EXPECTED_RAW[name])
        )
        sys.exit(1)
    # light schema probe before the full parse
    f0 = os.path.join(raw_dir, EXPECTED_RAW[name][0])
    if f0.endswith(".zip"):
        import zipfile

        with zipfile.ZipFile(f0) as z:
            names = [n for n in z.namelist() if n.endswith(".json")]
            if not names:
                print(f"ERROR: {f0} contains no .json entries")
                sys.exit(1)
            probe = json.loads(z.open(names[0]).read())
            for key in ("bounds", "children"):
                if key not in probe:
                    print(
                        f"ERROR: schema probe failed — first JSON entry "
                        f"lacks '{key}' (not a Rico semantic-annotations "
                        f"archive?)"
                    )
                    sys.exit(1)
            print(f"raw ok: {len(names)} annotation files, sha {_sha256(f0)}")
    else:
        with open(f0) as fh:
            probe = json.load(fh)
        for key in ("images", "annotations", "categories"):
            if key not in probe:
                print(
                    f"ERROR: schema probe failed — {f0} lacks '{key}' "
                    f"(not a COCO file?)"
                )
                sys.exit(1)
        print(
            f"raw ok: {len(probe['images'])} images / "
            f"{len(probe['annotations'])} annotations, sha {_sha256(f0)}"
        )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "dataset",
        help="built-in name (%s) or a custom dataset registered via "
        "--register_module" % "/".join(sorted(EXPECTED_RAW)),
    )
    p.add_argument("--data_dir", default="download/datasets")
    p.add_argument("--max_seq_length", type=int, default=25)
    p.add_argument(
        "--force", action="store_true", help="re-parse even if npz exist"
    )
    p.add_argument(
        "--register_module",
        default="",
        help="dotted module path or .py file whose import registers a "
        "custom dataset (registry.register_dataset; docs/custom_dataset.md)",
    )
    a = p.parse_args(argv)

    if a.register_module:
        from layoutdm_tpu_torch.registry import import_registrations

        import_registrations(a.register_module)
    if a.dataset not in DATASET_LABELS:
        p.error(
            f"unknown dataset {a.dataset!r}; built-ins: "
            f"{sorted(EXPECTED_RAW)}; custom datasets need "
            "--register_module"
        )

    root = os.path.join(a.data_dir, f"{a.dataset}-max{a.max_seq_length}")
    raw_dir = os.path.join(root, "raw")
    proc_dir = os.path.join(root, "processed")
    if a.dataset in EXPECTED_RAW:
        _check_raw(a.dataset, raw_dir)
    else:
        # custom dataset: its registered parser owns the raw schema
        print(f"custom dataset {a.dataset!r}: raw validation delegated to "
              "its registered parser")

    if a.force:
        for s in SPLITS:
            path = os.path.join(proc_dir, f"{s}.npz")
            if os.path.exists(path):
                os.remove(path)

    labels = DATASET_LABELS[a.dataset]
    total = 0
    for s in SPLITS:
        d = load_dataset(a.dataset, a.data_dir, s, a.max_seq_length)
        n = len(d)
        total += n
        counts = d.mask.sum(axis=1)
        hist = np.bincount(
            d.label[d.mask].reshape(-1), minlength=len(labels)
        )
        top = np.argsort(-hist)[:3]
        in_range = bool(
            (d.bbox[d.mask] >= 0).all() and (d.bbox[d.mask] <= 1).all()
        )
        path = os.path.join(proc_dir, f"{s}.npz")
        print(
            f"{s:>5}: {n:7d} layouts | elements/layout "
            f"min {int(counts.min()) if n else 0} / "
            f"median {int(np.median(counts)) if n else 0} / "
            f"max {int(counts.max()) if n else 0} | bbox in [0,1]: "
            f"{in_range} | top labels: "
            + ", ".join(f"{labels[i]}({hist[i]})" for i in top)
            + f" | sha {_sha256(path)}"
        )
        if not in_range:
            print(f"ERROR: {s} split has bboxes outside [0,1]")
            return 1
    print(f"total: {total} layouts -> {proc_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
