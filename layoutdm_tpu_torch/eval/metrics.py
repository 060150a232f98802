"""Layout quality metrics (port of ``layoutdm_tpu/eval/metrics.py``;
reference `trainer/helpers/metric.py:37-556`).

Batched geometry metrics (alignment, overlap) are vectorized numpy on dense
(B, S, 4) arrays; set-matching metrics (maximum IoU, DocSim) run on the
host through the port's native engine (``layoutdm_tpu_torch/native``: the
Hungarian solver, the max-IoU score matrix and DocSim pairs in C++), with
the Python versions kept as its plain twins.  FID and PRDC are numpy and
scipy.  Everything here runs on the host: only the FID features come from
the card (``eval/fidnet.py``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy import linalg
from scipy.optimize import linear_sum_assignment
from scipy.stats import wasserstein_distance

from layoutdm_tpu_torch import native
from layoutdm_tpu_torch.data.relations import (
    RelLoc,
    RelSize,
    detect_loc_relation,
    detect_size_relation,
)

Layout = Tuple[np.ndarray, np.ndarray]  # (bbox (N,4), label (N,))


def _ltrb(b):
    return (
        b[..., 0] - b[..., 2] / 2,
        b[..., 1] - b[..., 3] / 2,
        b[..., 0] + b[..., 2] / 2,
        b[..., 1] + b[..., 3] / 2,
    )


# ---------------------------------------------------------------------------
# FID + precision/recall/density/coverage
# ---------------------------------------------------------------------------


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (the `pytorch_fid` formula)."""
    diff = mu1 - mu2
    # no ``disp=False``: SciPy 1.18 removed it (the root is the same)
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(
        diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def compute_prdc(
    real: np.ndarray, fake: np.ndarray, nearest_k: int = 5
) -> Dict[str, float]:
    """Precision/recall/density/coverage [Naeem+ ICML'20], as used at
    `metric.py:52-54`."""

    def pdist(a, b):
        return np.sqrt(
            np.maximum(
                (a**2).sum(1)[:, None] + (b**2).sum(1)[None] - 2 * a @ b.T, 0
            )
        )

    d_rr = pdist(real, real)
    np.fill_diagonal(d_rr, np.inf)
    r_radii = np.sort(d_rr, axis=1)[:, nearest_k - 1]
    d_ff = pdist(fake, fake)
    np.fill_diagonal(d_ff, np.inf)
    f_radii = np.sort(d_ff, axis=1)[:, nearest_k - 1]
    d_rf = pdist(real, fake)  # (N_real, N_fake)

    precision = (d_rf <= r_radii[:, None]).any(axis=0).mean()
    recall = (d_rf <= f_radii[None, :]).any(axis=1).mean()
    density = (d_rf <= r_radii[:, None]).sum(axis=0).mean() / nearest_k
    coverage = (d_rf.min(axis=1) <= r_radii).mean()
    return {
        "precision": float(precision),
        "recall": float(recall),
        "density": float(density),
        "coverage": float(coverage),
    }


def compute_generative_model_scores(
    feats_real: np.ndarray, feats_fake: np.ndarray
) -> Dict[str, float]:
    """(`metric.py:37-59`)"""
    feats_real = np.concatenate(feats_real) if isinstance(feats_real, list) \
        else np.asarray(feats_real)
    feats_fake = np.concatenate(feats_fake) if isinstance(feats_fake, list) \
        else np.asarray(feats_fake)
    out = compute_prdc(feats_real, feats_fake, nearest_k=5)
    out["fid"] = frechet_distance(
        feats_real.mean(0),
        np.cov(feats_real, rowvar=False),
        feats_fake.mean(0),
        np.cov(feats_fake, rowvar=False),
    )
    return out


# ---------------------------------------------------------------------------
# alignment / overlap — vectorized over the batch (`metric.py:98-203`)
# ---------------------------------------------------------------------------


def compute_alignment(bbox: np.ndarray, mask: np.ndarray) -> Dict[str, np.ndarray]:
    """Three published alignment variants on (B, S, 4)/(B, S) arrays."""
    bbox = np.asarray(bbox, np.float64)
    mask = np.asarray(mask, bool)
    B, S = mask.shape
    xl, yt, xr, yb = _ltrb(bbox)
    xc, yc = bbox[..., 0], bbox[..., 1]
    X = np.stack([xl, xc, xr, yt, yc, yb], axis=1)  # (B, 6, S)

    D = np.abs(X[:, :, :, None] - X[:, :, None, :])  # (B, 6, S, S)
    idx = np.arange(S)
    D[:, :, idx, idx] = 1.0
    D = D.transpose(0, 2, 1, 3)  # (B, S, 6, S)
    D[~mask] = 1.0
    closest = D.min(axis=(-1, -2))  # (B, S)
    closest[closest == 1.0] = 0.0
    ac_score = -np.log(1 - closest).sum(axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        norm = ac_score / mask.sum(-1)
    norm = np.nan_to_num(norm)

    Y = np.stack([xl, xc, xr], axis=1)  # (B, 3, S)
    Yd = Y[:, :, None, :] - Y[:, :, :, None]
    pair_mask = (~mask)[:, None, :] | (~mask)[:, :, None]
    pair_mask[:, idx, idx] = True
    Yd = np.where(pair_mask[:, None], 1.0, Yd)
    Ymin = np.abs(Yd).min(axis=(1, 3))  # (B, S)
    Ymin[Ymin == 1.0] = 0.0
    ndn = Ymin.sum(-1)

    return {
        "alignment-ACLayoutGAN": ac_score,
        "alignment-LayoutGAN++": norm,
        "alignment-NDN": ndn,
    }


def compute_overlap(bbox: np.ndarray, mask: np.ndarray) -> Dict[str, np.ndarray]:
    bbox = np.where(mask[..., None], np.asarray(bbox, np.float64), 0.0)
    B, S = mask.shape
    l, t, r, b = _ltrb(bbox)
    l1, t1, r1, b1 = (x[:, :, None] for x in (l, t, r, b))
    l2, t2, r2, b2 = (x[:, None, :] for x in (l, t, r, b))
    a1 = (r1 - l1) * (b1 - t1)  # (B, S, 1) areas of the row box

    l_max, r_min = np.maximum(l1, l2), np.minimum(r1, r2)
    t_max, b_min = np.maximum(t1, t2), np.minimum(b1, b2)
    cond = (l_max < r_min) & (t_max < b_min)
    ai = np.where(cond, (r_min - l_max) * (b_min - t_max), 0.0)

    idx = np.arange(S)
    pair_mask = (~mask)[:, None, :] | (~mask)[:, :, None]
    pair_mask[:, idx, idx] = True
    ai = np.where(pair_mask, 0.0, ai)

    with np.errstate(invalid="ignore", divide="ignore"):
        ar = np.nan_to_num(ai / a1)
    score = ar.sum(axis=(1, 2))
    with np.errstate(invalid="ignore", divide="ignore"):
        norm = score / mask.sum(-1)
    norm = np.nan_to_num(norm)

    ii, jj = np.meshgrid(idx, idx, indexing="ij")
    tri = np.where((ii >= jj)[None], 0.0, ai)
    overlap = tri.sum(axis=(1, 2))

    return {
        "overlap-ACLayoutGAN": score,
        "overlap-LayoutGAN++": norm,
        "overlap-LayoutGAN": overlap,
    }


# ---------------------------------------------------------------------------
# IoU family (`metric.py:206-431`)
# ---------------------------------------------------------------------------


def compute_iou(box_1: np.ndarray, box_2: np.ndarray,
                generalized: bool = False) -> np.ndarray:
    l1, t1, r1, b1 = _ltrb(box_1)
    l2, t2, r2, b2 = _ltrb(box_2)
    a1, a2 = (r1 - l1) * (b1 - t1), (r2 - l2) * (b2 - t2)
    l_max, r_min = np.maximum(l1, l2), np.minimum(r1, r2)
    t_max, b_min = np.maximum(t1, t2), np.minimum(b1, b2)
    cond = (l_max < r_min) & (t_max < b_min)
    ai = np.where(cond, (r_min - l_max) * (b_min - t_max), 0.0)
    au = a1 + a2 - ai
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = np.nan_to_num(ai / au)
    if not generalized:
        return iou
    ac = (np.maximum(r1, r2) - np.minimum(l1, l2)) * (
        np.maximum(b1, b2) - np.minimum(t1, t2)
    )
    return iou - (ac - au) / ac


def compute_perceptual_iou(box_1: np.ndarray, box_2: np.ndarray) -> np.ndarray:
    """BLT's rasterized-union IoU (`metric.py:250-297`): pairwise
    intersection normalized by the 32x32 rasterized union area of box_1's
    layout."""
    l1, t1, r1, b1 = _ltrb(box_1)
    l2, t2, r2, b2 = _ltrb(box_2)
    l_max, r_min = np.maximum(l1, l2), np.minimum(r1, r2)
    t_max, b_min = np.maximum(t1, t2), np.minimum(b1, b2)
    cond = (l_max < r_min) & (t_max < b_min)
    ai = np.where(cond, (r_min - l_max) * (b_min - t_max), 0.0)

    unique = np.unique(box_1, axis=0)
    N = 32
    lu, tu, ru, bu = [
        (x * N).round().astype(np.int32).clip(0, N) for x in _ltrb(unique)
    ]
    canvas = np.zeros((N, N))
    for li, ti, ri, bi in zip(lu, tu, ru, bu):
        canvas[ti:bi, li:ri] = 1
    union = canvas.sum() / (N**2)
    if union > 0.0:
        return ai / union
    return np.zeros((1,))


def _max_iou_two_layouts(layout_1: Layout, layout_2: Layout) -> float:
    """Hungarian matching within identical-label-multiset layouts
    (`metric.py:300-314`)."""
    (bi, li), (bj, lj) = layout_1, layout_2
    N = len(bi)
    score = 0.0
    for l in set(li.tolist()):
        _bi = bi[li == l]
        _bj = bj[lj == l]
        n = len(_bi)
        ii, jj = np.meshgrid(range(n), range(n))
        iou = compute_iou(_bi[ii.ravel()], _bj[jj.ravel()]).reshape(n, n)
        ri, rj = linear_sum_assignment(iou, maximize=True)
        score += iou[ri, rj].sum()
    return score / N


def compute_maximum_iou(
    layouts_1: List[Layout], layouts_2: List[Layout]
) -> float:
    """Double-Hungarian Maximum IoU [Kikuchi+ ACMMM'21]
    (`metric.py:343-371`): group by identical label multiset, then optimally
    match layout sets within each group."""

    def group(ls):
        out: Dict[str, List[Layout]] = {}
        for b, l in ls:
            out.setdefault(str(sorted(l.tolist())), []).append((b, l))
        return out

    g1, g2 = group(layouts_1), group(layouts_2)
    keys = set(g1) & set(g2)
    all_scores = []
    for k in keys:
        # the whole N x M pair-score matrix in C++ (per-label IoU Hungarian
        # inside; `_max_iou_two_layouts` is its plain twin)
        scores = native.max_iou_score_matrix(g1[k], g2[k])
        # reference matrix layout (scramble for N != M groups; see
        # _ref_pairscore_layout) so the matched set is identical
        scores = _ref_pairscore_layout(scores)
        ii, jj = native.linear_sum_assignment(scores, maximize=True)
        all_scores.append(scores[ii, jj])
    if not all_scores:
        return 0.0
    return float(np.concatenate(all_scores).mean())


def _average_iou_one(layout: Layout, perceptual: bool) -> float:
    bbox, _ = layout
    N = bbox.shape[0]
    if N in (0, 1):
        return 0.0
    ii, jj = np.meshgrid(range(N), range(N))
    nd = ii.ravel() != jj.ravel()
    ii, jj = ii.ravel()[nd], jj.ravel()[nd]
    if perceptual:
        iou = compute_perceptual_iou(bbox[ii], bbox[jj])
    else:
        iou = compute_iou(bbox[ii], bbox[jj])
    cond = iou > np.finfo(np.float32).eps
    return float(iou[cond].mean()) if cond.any() else 0.0


def compute_average_iou(layouts: List[Layout]) -> Dict[str, float]:
    """(`metric.py:399-431`) — lower is better."""
    return {
        "average_iou-BLT": float(
            np.mean([_average_iou_one(l, True) for l in layouts])
        ),
        "average_iou-VTN": float(
            np.mean([_average_iou_one(l, False) for l in layouts])
        ),
    }


# ---------------------------------------------------------------------------
# DocSim (`metric.py:434-507`)
# ---------------------------------------------------------------------------


def _bbox_sim(b1, c1, b2, c2, C_S=2.0, C=0.5) -> float:
    if c1 != c2:
        return 0.0
    delta_c = np.hypot(b1[0] - b2[0], b1[1] - b2[1])
    delta_s = abs(b1[2] - b2[2]) + abs(b1[3] - b2[3])
    area = min(b1[2] * b1[3], b2[2] * b2[3])
    alpha = max(area, 0.0) ** C
    return alpha * 2.0 ** (-delta_c - C_S * delta_s)


def _ref_pairscore_layout(scores: np.ndarray) -> np.ndarray:
    """Reproduce the reference's score-matrix construction
    (`metric.py:462-470`, also `:321-327`): xy-indexed `np.meshgrid(range(N),
    range(M))` flattened then `.reshape(N, M)`.  For N == M this is a plain
    transpose (assignment-value invariant); for N != M it SCRAMBLES the
    matrix — a reference quirk that changes the Hungarian matching, mirrored
    here so DocSim/max-IoU numbers are comparable with published ones.
    Given the sane (N, M) matrix, the reference's layout is
    ``scores.T.reshape(N, M)``."""
    N, M = scores.shape
    return scores.T.reshape(N, M)


def _docsim_pair(l1: Layout, l2: Layout, max_diff_thresh: int = 3) -> float:
    (b1, c1), (b2, c2) = l1, l2
    N, M = len(b1), len(b2)
    if N >= M + max_diff_thresh or N <= M - max_diff_thresh:
        return 0.0
    scores = np.asarray(
        [
            _bbox_sim(b1[i], c1[i], b2[j], c2[j])
            for i in range(N)
            for j in range(M)
        ]
    ).reshape(N, M)
    scores = _ref_pairscore_layout(scores)
    ii, jj = linear_sum_assignment(scores, maximize=True)
    return float(scores[ii, jj].mean()) if len(ii) else 0.0


def compute_docsim(
    layouts_gt: List[Layout], layouts_gen: List[Layout]
) -> float:
    # the native engine computes the sane (N, M) matching, which matches the
    # reference only for equal-size pairs (see _ref_pairscore_layout); route
    # ONLY the unequal-size pairs through the reference-faithful python
    # path and keep the C++ path for the rest
    pairs = list(zip(layouts_gt, layouts_gen))
    eq = [i for i, (a, b) in enumerate(pairs) if len(a[0]) == len(b[0])]
    scores = np.empty(len(pairs), np.float64)
    if eq:
        scores[eq] = native.docsim_pairs(
            [layouts_gt[i] for i in eq], [layouts_gen[i] for i in eq]
        )
    eq_set = set(eq)
    for i, (a, b) in enumerate(pairs):
        if i not in eq_set:
            scores[i] = _docsim_pair(a, b)
    return float(scores.mean())


# ---------------------------------------------------------------------------
# relation violation (`metric.py:62-95`)
# ---------------------------------------------------------------------------


def compute_violation(
    bbox: np.ndarray,  # (B, S, 4) generated boxes (canvas at index 0)
    label: np.ndarray,  # (B, S)
    edge_index: np.ndarray,  # (B, E, 2)
    edge_attr: np.ndarray,  # (B, E) bit flags
    edge_mask: np.ndarray,  # (B, E)
) -> np.ndarray:
    """Per-layout share of the imposed relations that the boxes break
    (`metric.py:62-95`), NaN for a layout with no active relation."""
    B = bbox.shape[0]
    out = np.full((B,), np.nan)
    for b in range(B):
        fail = valid = 0
        for e in range(edge_index.shape[1]):
            if not edge_mask[b, e]:
                continue
            i, j = edge_index[b, e]
            gt = int(edge_attr[b, e])
            b1, b2 = bbox[b, i], bbox[b, j]
            if ~gt & (1 << RelSize.UNKNOWN):
                pred = detect_size_relation(b1, b2)
                fail += int((gt & (1 << pred)) == 0)
                valid += 1
            if ~gt & (1 << RelLoc.UNKNOWN):
                pred = detect_loc_relation(b1, b2, label[b, i] == 0)
                fail += int((gt & (1 << pred)) == 0)
                valid += 1
        if valid:
            out[b] = fail / valid
    return out


# ---------------------------------------------------------------------------
# Wasserstein (`metric.py:510-556`)
# ---------------------------------------------------------------------------


def compute_wasserstein_distance(
    layouts_1: List[Layout], layouts_2: List[Layout], n_classes: int = 25
) -> Dict[str, float]:
    """Class-histogram L1 + per-coordinate bbox Wasserstein
    (`metric.py:510-556`).

    Returns NaNs when either side has zero elements overall (every layout
    empty) — reachable with tiny sample counts from a barely-trained model
    that predicts all-PAD; scipy's `wasserstein_distance` raises on an
    empty distribution and a smoke run should not die on a metric."""
    b1 = np.concatenate([l[0] for l in layouts_1])
    b2 = np.concatenate([l[0] for l in layouts_2])
    if len(b1) == 0 or len(b2) == 0:
        return {"wdist_class": float("nan"), "wdist_bbox": float("nan")}

    def class_hist(ls):
        cats = np.concatenate([l[1] for l in ls])
        counts = np.bincount(cats.astype(int), minlength=n_classes)[:n_classes]
        return counts / counts.sum()

    w_class = float(np.abs(class_hist(layouts_1) - class_hist(layouts_2)).sum())
    w_bbox = float(
        np.mean([wasserstein_distance(b1.T[i], b2.T[i]) for i in range(4)])
    )
    return {"wdist_class": w_class, "wdist_bbox": w_bbox}
