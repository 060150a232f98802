"""The port's metric suite (``layoutdm_tpu_torch/eval/metrics.py``) against
the JAX package's on the same numpy layouts and features, made from a
seed.  Both run numpy, scipy and each package's own copy of the native
engine, so every metric agrees within 1e-9 and FID within 1e-6 relative."""

import numpy as np
import pytest

from layoutdm_tpu.eval import metrics as JM
from layoutdm_tpu_torch.eval import metrics as TM

TOL = 1e-9


def _layouts(rs, n, max_elems=4, num_labels=2, min_elems=0):
    """Layouts of few labels, so that label multisets repeat and max-IoU
    groups form, of unequal sizes on the two sides."""
    out = []
    for _ in range(n):
        k = rs.randint(min_elems, max_elems + 1)
        out.append((rs.rand(k, 4).astype(np.float32),
                    rs.randint(0, num_labels, k).astype(np.int32)))
    return out


def _dense(rs, B=12, S=9):
    bbox = rs.rand(B, S, 4).astype(np.float32)
    mask = np.arange(S)[None] < rs.randint(0, S + 1, (B, 1))
    return bbox, mask


@pytest.mark.parametrize("name", ["compute_alignment", "compute_overlap"])
def test_dense_geometry_metrics_match_jax(name):
    bbox, mask = _dense(np.random.RandomState(0))
    bbox[0, 1] = bbox[0, 0]  # an exactly aligned pair
    want = getattr(JM, name)(bbox, mask)
    got = getattr(TM, name)(bbox, mask)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("generalized", [False, True])
def test_iou_matches_jax(generalized):
    rs = np.random.RandomState(1)
    a, b = rs.rand(50, 4), rs.rand(50, 4)
    np.testing.assert_allclose(TM.compute_iou(a, b, generalized),
                               JM.compute_iou(a, b, generalized), atol=TOL)


def test_perceptual_iou_matches_jax():
    rs = np.random.RandomState(2)
    a, b = rs.rand(30, 4), rs.rand(30, 4)
    np.testing.assert_allclose(TM.compute_perceptual_iou(a, b),
                               JM.compute_perceptual_iou(a, b), atol=TOL)
    zero = np.zeros((3, 4))  # an empty rasterised union
    np.testing.assert_array_equal(TM.compute_perceptual_iou(zero, a[:3]),
                                  JM.compute_perceptual_iou(zero, a[:3]))


def test_maximum_iou_with_unequal_groups_matches_jax():
    rs = np.random.RandomState(3)
    l1, l2 = _layouts(rs, 40, min_elems=1), _layouts(rs, 31, min_elems=1)
    key = lambda l: str(sorted(l.tolist()))
    sizes = {}
    for side, ls in enumerate((l1, l2)):
        for _, lab in ls:
            sizes.setdefault(key(lab), [0, 0])[side] += 1
    # groups of N != M on both sides: the reference's scrambled matrix
    assert any(n != m and n and m for n, m in sizes.values())
    want = JM.compute_maximum_iou(l1, l2)
    assert abs(TM.compute_maximum_iou(l1, l2) - want) <= TOL
    assert TM.compute_maximum_iou(l1[:3], []) == JM.compute_maximum_iou(l1[:3], []) == 0.0


def test_average_iou_matches_jax():
    rs = np.random.RandomState(4)
    layouts = _layouts(rs, 25, max_elems=6, num_labels=3)
    want = JM.compute_average_iou(layouts)
    got = TM.compute_average_iou(layouts)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, k


def test_docsim_with_mixed_pair_sizes_matches_jax_and_python():
    rs = np.random.RandomState(5)
    gt, gen = [], []
    for n_gt, n_gen in [(3, 3), (3, 2), (2, 2), (4, 2), (1, 1), (5, 1), (2, 4), (0, 0)]:
        gt.append((rs.rand(n_gt, 4).astype(np.float32), rs.randint(0, 3, n_gt)))
        gen.append((rs.rand(n_gen, 4).astype(np.float32), rs.randint(0, 3, n_gen)))
    want = JM.compute_docsim(gt, gen)
    assert abs(TM.compute_docsim(gt, gen) - want) <= TOL
    plain = float(np.mean([TM._docsim_pair(a, b) for a, b in zip(gt, gen)]))
    assert abs(TM.compute_docsim(gt, gen) - plain) <= TOL


def test_docsim_pair_and_reference_layout_match_jax():
    rs = np.random.RandomState(6)
    scores = rs.rand(3, 5)
    np.testing.assert_array_equal(TM._ref_pairscore_layout(scores),
                                  JM._ref_pairscore_layout(scores))
    for n, m in [(2, 3), (4, 3), (3, 3)]:
        a = (rs.rand(n, 4).astype(np.float32), rs.randint(0, 2, n))
        b = (rs.rand(m, 4).astype(np.float32), rs.randint(0, 2, m))
        assert abs(TM._docsim_pair(a, b) - JM._docsim_pair(a, b)) <= TOL
        assert TM._bbox_sim(a[0][0], 1, b[0][0], 1) == JM._bbox_sim(a[0][0], 1, b[0][0], 1)


@pytest.mark.parametrize("empty_side", [None, 0, 1])
def test_wasserstein_matches_jax(empty_side):
    rs = np.random.RandomState(7)
    sides = [_layouts(rs, 20, num_labels=5), _layouts(rs, 15, num_labels=5)]
    if empty_side is not None:  # every layout of one side empty: NaN
        sides[empty_side] = [(np.zeros((0, 4), np.float32), np.zeros(0, np.int32))] * 3
    want = JM.compute_wasserstein_distance(*sides, n_classes=5)
    got = TM.compute_wasserstein_distance(*sides, n_classes=5)
    assert list(got) == list(want)
    for k in want:
        if empty_side is None:
            assert abs(got[k] - want[k]) <= TOL, k
        else:
            assert np.isnan(got[k]) and np.isnan(want[k]), k


@pytest.mark.parametrize("n,dims", [(512, 256), (64, 128)])
def test_generative_model_scores_match_jax(n, dims):
    """FID and PRDC; at n > dims the covariances are full rank, at n <
    dims FID takes its eps offset path in both packages."""
    rs = np.random.RandomState(8)
    real = rs.randn(n, dims).astype(np.float32)
    fake = (0.9 * rs.randn(n, dims) + 0.1).astype(np.float32)
    want = JM.compute_generative_model_scores(real, fake)
    got = TM.compute_generative_model_scores([real[: n // 2], real[n // 2:]], fake)
    assert list(got) == list(want)
    for k in ("precision", "recall", "density", "coverage"):
        assert got[k] == want[k], k
    assert abs(got["fid"] - want["fid"]) <= 1e-6 * abs(want["fid"])
    assert TM.frechet_distance(real.mean(0), np.cov(real, rowvar=False),
                               real.mean(0), np.cov(real, rowvar=False)) == pytest.approx(0, abs=1e-3)
