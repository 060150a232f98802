"""Datasets: Rico (5/13/25 labels), PubLayNet, and a synthetic generator.

Re-design of `datasets/{dataset,base,rico,publaynet}.py` (~880 LoC of
torch-geometric machinery): layouts are PADDED DENSE ARRAYS from the moment
of preprocessing — ``bbox (M,S,4) f32 / label (M,S) i32 / mask (M,S) bool``
saved as one ``.npz`` per split — because everything downstream (tokenizer,
model, eval) is static-shape XLA.  No sparse Data/Batch objects, no collate.

Parsing semantics match the reference exactly:
* Rico (`rico.py:83-173`): semantic-annotation zip; drop screens with
  non-zero origin or landscape (H < W); drop elements with labels outside
  the set or out-of-canvas/degenerate bounds; drop layouts with 0 or >S
  elements; center-xywh normalized; seeded shuffle; 85/5/10 split.
* PubLayNet (`publaynet.py:28-116`): COCO annotations; same bbox validation;
  95/5 of train -> train/val, official val -> test.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from layoutdm_tpu_torch.registry import DATASET_LABELS, DATASET_PARSERS


@dataclass
class LayoutData:
    """One split of a dataset, padded dense."""

    name: str
    bbox: np.ndarray  # (M, S, 4) float32, center-xywh in [0,1]
    label: np.ndarray  # (M, S) int32
    mask: np.ndarray  # (M, S) bool
    labels: Tuple[str, ...]  # category names
    # per-layout source name (rico: annotation filename, publaynet:
    # page file_name) — the provenance real-image rendering needs
    # (`rico.py:178-216`); None for synthetic/legacy caches
    names: "np.ndarray | None" = None

    def __len__(self) -> int:
        return self.bbox.shape[0]

    @property
    def max_elements(self) -> int:
        return self.bbox.shape[1]

    def slice(self, idx) -> Dict[str, np.ndarray]:
        return {
            "bbox": self.bbox[idx],
            "label": self.label[idx],
            "mask": self.mask[idx],
        }


def _pad_layouts(
    layouts: List[Tuple[np.ndarray, np.ndarray]], S: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    M = len(layouts)
    bbox = np.zeros((M, S, 4), np.float32)
    label = np.zeros((M, S), np.int32)
    mask = np.zeros((M, S), bool)
    for i, lay in enumerate(layouts):
        b, l = lay[0], lay[1]
        n = len(l)
        bbox[i, :n] = b
        label[i, :n] = l
        mask[i, :n] = True
    return bbox, label, mask


# ---------------------------------------------------------------------------
# raw parsers
# ---------------------------------------------------------------------------


def _append_child(element, elements):
    # recursive child flattening (`rico.py:71-76`)
    for child in element.get("children", []):
        elements.append(child)
        _append_child(child, elements)
    return elements


def parse_rico(
    raw_zip: str, labels: Tuple[str, ...], max_seq_length: int
) -> List[Tuple[np.ndarray, np.ndarray]]:
    from zipfile import ZipFile

    label2index = {l: i for i, l in enumerate(labels)}
    label_set = set(labels)
    out = []
    with ZipFile(raw_zip) as z:
        names = sorted(n for n in z.namelist() if n.endswith(".json"))
        for name in names:
            ann = json.loads(z.open(name).read())
            B = ann["bounds"]
            W, H = float(B[2]), float(B[3])
            if B[0] != 0 or B[1] != 0 or H < W:
                continue

            def is_valid(e):
                if e.get("componentLabel") not in label_set:
                    return False
                x1, y1, x2, y2 = e["bounds"]
                if x1 < 0 or y1 < 0 or W < x2 or H < y2:
                    return False
                return x2 > x1 and y2 > y1

            elements = [e for e in _append_child(ann, []) if is_valid(e)]
            n = len(elements)
            if n == 0 or n > max_seq_length:
                continue
            boxes, cats = [], []
            for e in elements:
                x1, y1, x2, y2 = e["bounds"]
                boxes.append(
                    [
                        (x1 + x2) / 2.0 / W,
                        (y1 + y2) / 2.0 / H,
                        (x2 - x1) / W,
                        (y2 - y1) / H,
                    ]
                )
                cats.append(label2index[e["componentLabel"]])
            out.append(
                (np.asarray(boxes, np.float32), np.asarray(cats, np.int32),
                 name)
            )
    return out


def parse_publaynet(
    coco_json: str, labels: Tuple[str, ...], max_seq_length: int
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """COCO-format parser (`publaynet.py:40-106`) without pycocotools.

    Semantics match the reference exactly: landscape pages (H < W) are
    skipped; INVALID annotations are filtered out while the page is kept
    (`publaynet.py:49-63` — the reference only drops a page when zero valid
    elements remain or it exceeds max_seq_length).
    """
    with open(coco_json) as f:
        coco = json.load(f)
    cat_map = {}
    for c in coco["categories"]:
        name = c["name"]
        if name in labels:
            cat_map[c["id"]] = labels.index(name)
    images = {im["id"]: im for im in coco["images"]}
    by_image: Dict[int, list] = {im_id: [] for im_id in images}
    for a in coco["annotations"]:
        by_image.setdefault(a["image_id"], []).append(a)

    out = []
    for img_id in sorted(by_image):
        im = images[img_id]
        W, H = float(im["width"]), float(im["height"])
        if H < W:  # landscape pages skipped (`publaynet.py:46-47`)
            continue
        boxes, cats = [], []
        # pycocotools' getAnnIds preserves file order per image — keep it
        for a in by_image[img_id]:
            x1, y1, w, h = a["bbox"]
            x2, y2 = x1 + w, y1 + h
            # invalid elements are filtered, the page is kept
            if x1 < 0 or y1 < 0 or W < x2 or H < y2 or x2 <= x1 or y2 <= y1:
                continue
            if a["category_id"] not in cat_map:
                continue
            boxes.append(
                [(x1 + w / 2) / W, (y1 + h / 2) / H, w / W, h / H]
            )
            cats.append(cat_map[a["category_id"]])
        n = len(boxes)
        if n == 0 or n > max_seq_length:
            continue
        out.append(
            (np.asarray(boxes, np.float32), np.asarray(cats, np.int32),
             im.get("file_name", str(img_id)))
        )
    return out


def _seeded_permutation(n: int, seed: int = 0) -> np.ndarray:
    """The REFERENCE's split permutation: `torch.randperm` under
    `torch.Generator().manual_seed(seed)` (`rico.py:160-163`,
    `publaynet.py:105-108`).  Split membership must match the reference
    bit-for-bit so metrics computed against its released weights use the
    same test split; numpy fallback only if torch is unavailable."""
    try:
        import torch

        g = torch.Generator().manual_seed(seed)
        return torch.randperm(n, generator=g).numpy()
    except ImportError:  # pragma: no cover
        import warnings

        warnings.warn(
            "torch unavailable: split permutation falls back to numpy and "
            "will NOT match the reference's split membership"
        )
        return np.random.RandomState(seed).permutation(n)


# ---------------------------------------------------------------------------
# synthetic dataset — structured random layouts for tests / benches / CI
# ---------------------------------------------------------------------------


def synthetic_layouts(
    n: int, max_elements: int, num_categories: int = 5, seed: int = 0
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Layouts with learnable structure: vertically stacked rows whose
    category correlates with height/width — enough signal for integration
    tests to observe a decreasing loss."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rng.randint(1, max_elements + 1)
        ys = np.sort(rng.rand(k))
        cats = rng.randint(0, num_categories, k)
        h = 0.05 + 0.1 * (cats + 1) / num_categories + 0.02 * rng.rand(k)
        w = 0.3 + 0.5 * (cats + 1) / num_categories * rng.rand(k)
        x = 0.5 + 0.1 * rng.randn(k)
        bbox = np.stack(
            [x.clip(0.1, 0.9), ys.clip(0.05, 0.95), w.clip(0.05, 1), h.clip(0.02, 1)],
            axis=1,
        ).astype(np.float32)
        out.append((bbox, cats.astype(np.int32)))
    return out


# ---------------------------------------------------------------------------
# loading with processed-cache, seeded shuffle and splits
# ---------------------------------------------------------------------------

SPLITS = ("train", "val", "test")


def load_dataset(
    name: str,
    data_dir: str,
    split: str,
    max_seq_length: int = 25,
    synthetic_size: int = 2048,
    seed: int = 0,
) -> LayoutData:
    assert split in SPLITS
    if name == "synthetic":
        sizes = {"train": synthetic_size, "val": synthetic_size // 8,
                 "test": synthetic_size // 8}
        layouts = synthetic_layouts(
            sizes[split], max_seq_length, seed=seed + SPLITS.index(split)
        )
        bbox, label, mask = _pad_layouts(layouts, max_seq_length)
        return LayoutData(name, bbox, label, mask, DATASET_LABELS["rico5"])

    if name not in DATASET_LABELS:
        raise KeyError(
            f"unknown dataset {name!r}; built-ins are "
            f"{sorted(DATASET_LABELS)} — register custom datasets via "
            "layoutdm_tpu_torch.registry.register_dataset (docs/custom_dataset.md)"
        )
    labels = DATASET_LABELS[name]
    proc_dir = os.path.join(data_dir, f"{name}-max{max_seq_length}", "processed")
    proc_path = os.path.join(proc_dir, f"{split}.npz")
    if os.path.exists(proc_path):
        z = np.load(proc_path)
        return LayoutData(
            name, z["bbox"], z["label"], z["mask"], labels,
            names=z["names"] if "names" in z.files else None,
        )

    raw_dir = os.path.join(data_dir, f"{name}-max{max_seq_length}", "raw")
    os.makedirs(proc_dir, exist_ok=True)
    if name.startswith("rico"):
        raw_zip = os.path.join(
            raw_dir, "rico_dataset_v0.1_semantic_annotations.zip"
        )
        layouts = parse_rico(raw_zip, labels, max_seq_length)
        # the reference's seeded shuffle + 85/5/10 (`rico.py:160-173`)
        idx = _seeded_permutation(len(layouts))
        layouts = [layouts[i] for i in idx]
        N = len(layouts)
        cuts = {
            "train": slice(0, int(N * 0.85)),
            "val": slice(int(N * 0.85), int(N * 0.90)),
            "test": slice(int(N * 0.90), N),
        }
        parts = {s: layouts[c] for s, c in cuts.items()}
    elif name == "publaynet":
        train = parse_publaynet(
            os.path.join(raw_dir, "train.json"), labels, max_seq_length
        )
        val = parse_publaynet(
            os.path.join(raw_dir, "val.json"), labels, max_seq_length
        )
        # seeded shuffle of train, then 95/5 -> train/val; official val ->
        # test (`publaynet.py:105-116`)
        idx = _seeded_permutation(len(train))
        train = [train[i] for i in idx]
        s = int(len(train) * 0.95)
        parts = {"train": train[:s], "val": train[s:], "test": val}
    elif name in DATASET_PARSERS:
        parsed = DATASET_PARSERS[name](raw_dir, max_seq_length)
        if isinstance(parsed, dict):
            missing = [s for s in SPLITS if s not in parsed]
            if missing:
                raise ValueError(
                    f"custom parser for {name!r} returned splits "
                    f"{sorted(parsed)} — missing {missing}"
                )
            parts = {s: list(parsed[s]) for s in SPLITS}
        else:
            # flat list -> the reference's seeded shuffle + 85/5/10
            layouts = list(parsed)
            idx = _seeded_permutation(len(layouts))
            layouts = [layouts[i] for i in idx]
            N = len(layouts)
            parts = {
                "train": layouts[: int(N * 0.85)],
                "val": layouts[int(N * 0.85) : int(N * 0.90)],
                "test": layouts[int(N * 0.90) :],
            }
    else:
        raise KeyError(
            f"dataset {name!r} has no processed cache at {proc_path}, no "
            "built-in parser, and no registered custom parser — either "
            "ship pre-built .npz splits or pass parser= to "
            "registry.register_dataset (docs/custom_dataset.md)"
        )

    for s, ls in parts.items():
        bbox, label, mask = _pad_layouts(ls, max_seq_length)
        np.savez_compressed(
            os.path.join(proc_dir, f"{s}.npz"),
            bbox=bbox, label=label, mask=mask,
            names=np.asarray(
                [lay[2] if len(lay) > 2 else "" for lay in ls]
            ),
        )
    z = np.load(proc_path)
    return LayoutData(
        name, z["bbox"], z["label"], z["mask"], labels,
        names=z["names"] if "names" in z.files else None,
    )
