"""Layout rendering — PIL, host-side (`helpers/visualization.py:17-371`).

Renders decoded layouts as translucent colored rectangles (area-sorted so
small elements stay visible), grid montages, label cards, and GIFs of the
intermediate diffusion states.  Colors follow a deterministic HSV wheel per
category (the reference samples a seaborn palette; any stable palette works).
"""

from __future__ import annotations

import colorsys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    from PIL import Image, ImageDraw

    HAS_PIL = True
except Exception:  # pragma: no cover
    HAS_PIL = False


def category_colors(n: int) -> List[Tuple[int, int, int]]:
    cols = []
    for i in range(n):
        r, g, b = colorsys.hsv_to_rgb(i / max(n, 1), 0.65, 0.95)
        cols.append((int(r * 255), int(g * 255), int(b * 255)))
    return cols


def convert_layout_to_image(
    bbox: np.ndarray,  # (N, 4) xywh
    label: np.ndarray,  # (N,)
    colors: Sequence[Tuple[int, int, int]],
    canvas_size: Tuple[int, int] = (360, 520),
    resources: Optional[Dict] = None,
    names: Optional[Sequence[str]] = None,
) -> "Image.Image":
    """One layout -> PIL image (`visualization.py:17-63`): draw large areas
    first, translucent fill + solid outline.

    ``resources`` enables the reference's real-image mode
    (`visualization.py:26-57`): ``{"img_bg": PIL image,
    "cropped_patches": [PIL patch per element]}`` — the background screenshot
    is used as the canvas and each element is rendered by pasting its
    cropped real-image patch (resized to the element's box) instead of a
    colored rectangle.  ``names`` draws the category name at each box's
    top-left corner.
    """
    assert HAS_PIL, "Pillow not available"
    W, H = canvas_size
    if resources:
        img = resources["img_bg"].resize((W, H)).convert("RGBA")
    else:
        img = Image.new("RGBA", (W, H), (255, 255, 255, 255))
    draw = ImageDraw.Draw(img, "RGBA")
    if len(label):
        area = bbox[:, 2] * bbox[:, 3]
        order = np.argsort(-area)
        for i in order:
            x, y, w, h = bbox[i]
            l, t = (x - w / 2) * W, (y - h / 2) * H
            r, b = (x + w / 2) * W, (y + h / 2) * H
            c = colors[int(label[i]) % len(colors)]
            if resources:
                # paste the element's cropped real-image patch
                # (`visualization.py:50-57`)
                li, ti, ri, bi = int(l), int(t), int(r), int(b)
                pw, ph = max(ri - li, 1), max(bi - ti, 1)
                patch = resources["cropped_patches"][int(i)].resize((pw, ph))
                img.paste(patch.convert("RGBA"), (li, ti))
            else:
                draw.rectangle(
                    [l, t, r, b], fill=c + (100,), outline=c + (255,), width=2
                )
            if names is not None:
                draw.text(
                    (max(l, 0) + 2, max(t, 0) + 2),
                    names[int(label[i]) % len(names)],
                    fill=(0, 0, 0, 255),
                )
    return img.convert("RGB")


def save_image(
    layouts: Dict[str, np.ndarray],  # {bbox (B,S,4), label (B,S), mask (B,S)}
    out_path: str,
    num_categories: int,
    canvas_size: Tuple[int, int] = (360, 520),
    ncols: Optional[int] = None,
    batch_resources: Optional[Dict] = None,
    names: Optional[Sequence[str]] = None,
) -> None:
    """Batch -> grid montage (`visualization.py:66-115`).

    ``batch_resources``: per-sample lists/dicts for real-image rendering —
    ``{"img_bg": [B PIL images], "cropped_patches": [B lists of patches]}``.
    """
    colors = category_colors(num_categories)
    bbox = np.asarray(layouts["bbox"])
    label = np.asarray(layouts["label"])
    mask = np.asarray(layouts["mask"])
    B = bbox.shape[0]
    imgs = []
    for i in range(B):
        res = (
            {k: v[i] for k, v in batch_resources.items()}
            if batch_resources
            else None
        )
        imgs.append(
            convert_layout_to_image(
                bbox[i][mask[i]], label[i][mask[i]], colors, canvas_size,
                resources=res, names=names,
            )
        )
    _save_grid(imgs, out_path, canvas_size, ncols)


def _text_card(
    lines,
    out_size: Tuple[int, int],
    colors: Optional[Sequence[Tuple[int, int, int]]] = None,
    color_ids: Optional[Sequence[int]] = None,
) -> "Image.Image":
    W, H = out_size
    img = Image.new("RGB", (W, H), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    y = 8
    for i, line in enumerate(lines):
        col = (0, 0, 0)
        if colors is not None and color_ids is not None:
            col = colors[color_ids[i] % len(colors)]
        draw.text((8, y), line, fill=col)
        y += 14
        if y > H - 14:
            break
    return img


def save_label(
    layouts: Dict[str, np.ndarray],
    out_path: str,
    label_names: Sequence[str],
    canvas_size: Tuple[int, int] = (360, 520),
    ncols: Optional[int] = None,
) -> None:
    """Card listing each layout's category names (`visualization.py:118-183`)."""
    colors = category_colors(len(label_names))
    label = np.asarray(layouts["label"])
    mask = np.asarray(layouts["mask"])
    B = label.shape[0]
    cards = []
    for i in range(B):
        ls = label[i][mask[i]]
        cards.append(
            _text_card(
                [label_names[int(l)] for l in ls], canvas_size, colors, ls
            )
        )
    _save_grid(cards, out_path, canvas_size, ncols)


def save_label_with_size(
    layouts: Dict[str, np.ndarray],
    out_path: str,
    label_names: Sequence[str],
    canvas_size: Tuple[int, int] = (360, 520),
    ncols: Optional[int] = None,
) -> None:
    """Label + (w, h) card (`visualization.py:186-233`)."""
    colors = category_colors(len(label_names))
    label = np.asarray(layouts["label"])
    bbox = np.asarray(layouts["bbox"])
    mask = np.asarray(layouts["mask"])
    cards = []
    for i in range(label.shape[0]):
        ls = label[i][mask[i]]
        bs = bbox[i][mask[i]]
        lines = [
            f"{label_names[int(l)]} ({b[2]:.2f}x{b[3]:.2f})"
            for l, b in zip(ls, bs)
        ]
        cards.append(_text_card(lines, canvas_size, colors, ls))
    _save_grid(cards, out_path, canvas_size, ncols)


REL_TEXT = {
    1: "smaller than",
    2: "equal to",
    3: "larger than",
    5: "left of",
    6: "above",
    7: "right of",
    8: "below",
    9: "around",
}


def save_relation(
    layouts: Dict[str, np.ndarray],
    edges: Dict[str, np.ndarray],  # edge_index/edge_attr/edge_mask (B, E, ..)
    out_path: str,
    label_names: Sequence[str],
    canvas_size: Tuple[int, int] = (360, 520),
    ncols: Optional[int] = None,
) -> None:
    """Relation-triplet card (`visualization.py:249-351`): one line per
    imposed constraint, 'A <rel> B'."""
    label = np.asarray(layouts["label"])
    cards = []
    names = ["canvas"] + list(label_names)
    for b in range(label.shape[0]):
        lines = []
        for e in range(edges["edge_index"].shape[1]):
            if not edges["edge_mask"][b, e]:
                continue
            i, j = edges["edge_index"][b, e]
            attr = int(edges["edge_attr"][b, e])
            li = names[int(label[b, i])] if int(label[b, i]) < len(names) else "?"
            lj = names[int(label[b, j])] if int(label[b, j]) < len(names) else "?"
            for bit, text in REL_TEXT.items():
                if attr & (1 << bit):
                    lines.append(f"{lj} {text} {li}")
        cards.append(_text_card(lines, canvas_size))
    _save_grid(cards, out_path, canvas_size, ncols)


def _save_grid(imgs, out_path, canvas_size, ncols=None):
    W, H = canvas_size
    B = len(imgs)
    ncols = ncols or int(np.ceil(np.sqrt(B)))
    nrows = int(np.ceil(B / ncols))
    pad = 4
    grid = Image.new(
        "RGB",
        (ncols * (W + pad) + pad, nrows * (H + pad) + pad),
        (220, 220, 220),
    )
    for i, im in enumerate(imgs):
        r, c = divmod(i, ncols)
        grid.paste(im, (pad + c * (W + pad), pad + r * (H + pad)))
    grid.save(out_path)


def save_gif(
    frames: List[Dict[str, np.ndarray]],
    out_path: str,
    num_categories: int,
    index: int = 0,
    canvas_size: Tuple[int, int] = (360, 520),
    duration_ms: int = 80,
) -> None:
    """Intermediate diffusion states -> GIF (`visualization.py:354-371`)."""
    colors = category_colors(num_categories)
    imgs = []
    for fr in frames:
        m = np.asarray(fr["mask"])[index]
        imgs.append(
            convert_layout_to_image(
                np.asarray(fr["bbox"])[index][m],
                np.asarray(fr["label"])[index][m],
                colors,
                canvas_size,
            )
        )
    imgs[0].save(
        out_path,
        save_all=True,
        append_images=imgs[1:],
        duration=duration_ms,
        loop=0,
    )


def get_original_resources(
    image_dir: str,
    names: Sequence[str],
    bboxes: Sequence[np.ndarray],  # per-layout (n_i, 4) xywh
) -> Dict[str, list]:
    """Load per-layout real-image resources for real-image rendering
    (`datasets/rico.py:178-216`): for each layout, open the source
    screenshot ``{image_dir}/{name}.jpg``, crop each element's patch, and
    white out the element regions in the background copy.

    Returns ``{"img_bg", "img_original", "cropped_patches"}`` consumable by
    `save_image(batch_resources=...)`.
    """
    import os

    img_bg, img_original, cropped = [], [], []
    for name, bbox in zip(names, bboxes):
        base = os.path.basename(str(name)).replace(".json", ".jpg")
        img = Image.open(os.path.join(image_dir, base)).convert("RGB")
        img_original.append(img.copy())
        W, H = img.size
        draw = ImageDraw.Draw(img)
        patches = []
        for x, y, w, h in np.asarray(bbox):
            l = int((x - w / 2) * W)
            t = int((y - h / 2) * H)
            r = int((x + w / 2) * W)
            b = int((y + h / 2) * H)
            patches.append(img.crop((l, t, r, b)))
            draw.rectangle([(l, t), (r, b)], fill=(255, 255, 255))
        img_bg.append(img)
        cropped.append(patches)
    return {
        "img_bg": img_bg,
        "img_original": img_original,
        "cropped_patches": cropped,
    }
