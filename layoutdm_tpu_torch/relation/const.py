"""Differentiable relational-constraint penalties (port of
``layoutdm_tpu/relation/const.py``; reference `models/clg/const.py:11-235`).

Edges are padded arrays (B, E): ``bbox_all`` is (B, S+1, 4) xywh with the
canvas box at index 0, ``edge_index`` holds (src, dst) into it,
``edge_attr`` the bit-encoded relations (`data.relations`), ``edge_mask``
the real edges and ``src_is_canvas`` the edges whose source is the canvas.
Every penalty is a masked tensor expression, so the stack differentiates
under autograd (relation guidance takes its gradient at every step).
Hinges use ``torch.maximum`` against zero, whose gradient at a tie is
split in half as ``jnp.maximum``'s is.
"""

from __future__ import annotations

import torch

from layoutdm_tpu_torch.data.relations import REL_SIZE_ALPHA, RelLoc, RelSize


def beautify_alignment(
    bbox: torch.Tensor, mask: torch.Tensor, threshold: float = 0.004
) -> torch.Tensor:
    """Alignment cost per layout (`const.py:11-27`): the LayoutGAN++
    -log(1-d) closest-edge distance, thresholded."""
    S = mask.shape[1]
    xl = bbox[..., 0] - bbox[..., 2] / 2
    xr = bbox[..., 0] + bbox[..., 2] / 2
    yt = bbox[..., 1] - bbox[..., 3] / 2
    yb = bbox[..., 1] + bbox[..., 3] / 2
    X = torch.stack([xl, bbox[..., 0], xr, yt, bbox[..., 1], yb], dim=1)  # (B, 6, S)
    D = (X[:, :, :, None] - X[:, :, None, :]).abs()
    one = torch.ones((), dtype=D.dtype, device=D.device)
    eye = torch.eye(S, dtype=torch.bool, device=D.device)
    D = torch.where(eye[None, None], one, D)
    D = torch.where(mask[:, None, :, None], D, one)
    closest = D.amin(dim=(1, 3))  # (B, S)
    closest = torch.where(closest >= 1.0, torch.zeros_like(closest), closest)
    cost = -torch.log1p(-closest.clamp(0.0, 0.9999)).sum(-1)
    return torch.where(cost <= threshold, torch.zeros_like(cost), cost)


def beautify_non_overlap(bbox: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Total pairwise overlap ratio per layout (`const.py:30-45`)."""
    bbox = torch.where(mask[..., None], bbox, torch.zeros_like(bbox))
    l = bbox[..., 0] - bbox[..., 2] / 2
    r = bbox[..., 0] + bbox[..., 2] / 2
    t = bbox[..., 1] - bbox[..., 3] / 2
    b = bbox[..., 1] + bbox[..., 3] / 2
    a1 = ((r - l) * (b - t))[:, :, None]
    lmax = torch.maximum(l[:, :, None], l[:, None, :])
    rmin = torch.minimum(r[:, :, None], r[:, None, :])
    tmax = torch.maximum(t[:, :, None], t[:, None, :])
    bmin = torch.minimum(b[:, :, None], b[:, None, :])
    inter = _relu(rmin - lmax) * _relu(bmin - tmax)
    S = mask.shape[1]
    eye = torch.eye(S, dtype=torch.bool, device=mask.device)
    pair_ok = mask[:, :, None] & mask[:, None, :] & ~eye
    ratio = torch.where(pair_ok & (a1 > 0), inter / a1.clamp(min=1e-8),
                        torch.zeros_like(inter))
    return ratio.sum(dim=(1, 2))


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros_like(x))


def _leq(a, b):
    """penalty for requiring a <= b (`const.py:51-52`)"""
    return _relu(a - b)


def _lt(a, b, eps=1e-8):
    return _relu(a - b + eps)


def relation_losses(
    bbox_all: torch.Tensor,  # (B, S1, 4) xywh, canvas at 0
    edge_index: torch.Tensor,  # (B, E, 2)
    edge_attr: torch.Tensor,  # (B, E) bit flags
    edge_mask: torch.Tensor,  # (B, E)
    src_is_canvas: torch.Tensor,  # (B, E)
) -> torch.Tensor:
    """All 14 penalties, summed per graph -> (B, 14), in the reference's
    order (`const.py:220-235`): size sm/eq/lg x {element, canvas},
    canvas-loc t/c/b, loc t/b/l/r/c."""
    edge_index = edge_index.long()

    def gather(idx):  # (B, E) indices -> (B, E, 4) boxes
        return torch.gather(bbox_all, 1, idx[..., None].expand(*idx.shape, 4))

    bi, bj = gather(edge_index[..., 0]), gather(edge_index[..., 1])
    ai = bi[..., 2] * bi[..., 3]
    aj = bj[..., 2] * bj[..., 3]

    def ltrb(b):
        return (b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
                b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2)

    li, ti, ri, bbi = ltrb(bi)
    lj, tj, rj, bbj = ltrb(bj)
    ycj = bj[..., 1]

    def has(rel):
        return (edge_attr & (1 << int(rel))) != 0

    terms = []
    # size, element-sourced and canvas-sourced
    a_sm, a_lg = (1 - REL_SIZE_ALPHA) * ai, (1 + REL_SIZE_ALPHA) * ai
    for canvas in (False, True):
        src_ok = src_is_canvas if canvas else ~src_is_canvas
        terms.append(_leq(aj, a_sm) * (has(RelSize.SMALLER) & src_ok))
        terms.append((_lt(a_sm, aj) + _lt(aj, a_lg)) * (has(RelSize.EQUAL) & src_ok))
        terms.append(_leq(a_lg, aj) * (has(RelSize.LARGER) & src_ok))
    # the reference's sm/sm_c/eq/eq_c/lg/lg_c sequence
    terms = [terms[0], terms[3], terms[1], terms[4], terms[2], terms[5]]

    # location against the canvas (`const.py:106-149`)
    cv = src_is_canvas
    terms.append(_leq(ycj, 1 / 3) * (has(RelLoc.TOP) & cv))
    terms.append((_lt(1 / 3, ycj) + _lt(ycj, 2 / 3)) * (has(RelLoc.CENTER) & cv))
    terms.append(_leq(2 / 3, ycj) * (has(RelLoc.BOTTOM) & cv))

    # location between elements (`const.py:152-217`)
    ncv = ~src_is_canvas
    overlap_band = _lt(ti, bbj) + _lt(tj, bbi)  # same horizontal band
    terms.append(_leq(bbj, ti) * (has(RelLoc.TOP) & ncv))
    terms.append(_leq(bbi, tj) * (has(RelLoc.BOTTOM) & ncv))
    terms.append((_leq(rj, li) + overlap_band) * (has(RelLoc.LEFT) & ncv))
    terms.append((_leq(ri, lj) + overlap_band) * (has(RelLoc.RIGHT) & ncv))
    terms.append((_lt(li, rj) + _lt(lj, ri) + overlap_band) * (has(RelLoc.CENTER) & ncv))

    stacked = torch.stack(terms, dim=-1)  # (B, E, 14)
    stacked = torch.where(edge_mask[..., None], stacked, torch.zeros_like(stacked))
    return stacked.sum(dim=1)
