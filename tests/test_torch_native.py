"""The port's native metric engine (``layoutdm_tpu_torch/native``): the
Hungarian solver against scipy, the max-IoU score matrix and DocSim pairs
against the Python plain versions, and all three equal to the JAX
package's engine on the same inputs."""

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment as scipy_lsap

from layoutdm_tpu import native as jax_native
from layoutdm_tpu_torch import native
from layoutdm_tpu_torch.eval.metrics import _docsim_pair, _max_iou_two_layouts


def _group(rs, n, labels):
    """n layouts that share one label multiset."""
    return [(rs.rand(len(labels), 4).astype(np.float32), rs.permutation(labels))
            for _ in range(n)]


def test_engine_builds_into_the_ports_build_dir():
    path = native.library().path
    assert path.parent.name == "_build" and path.parent.parent.name == "layoutdm_tpu_torch"
    assert path.name.startswith("lsap") and path.exists()


@pytest.mark.parametrize("maximize", [False, True])
def test_lsap_matches_scipy(maximize):
    rs = np.random.RandomState(0)
    for _ in range(20):
        n, m = rs.randint(1, 12), rs.randint(1, 15)  # both orientations
        cost = rs.rand(n, m)
        ri, ci = native.linear_sum_assignment(cost, maximize=maximize)
        rs_, cs_ = scipy_lsap(cost, maximize=maximize)
        assert len(ri) == min(n, m)
        np.testing.assert_allclose(cost[ri, ci].sum(), cost[rs_, cs_].sum(), atol=1e-12)


def _groups():
    rs = np.random.RandomState(1)
    for labels in ([0, 1, 1], [2], [0, 0, 1, 2, 2]):
        labels = np.asarray(labels, np.int32)
        yield _group(rs, 5, labels), _group(rs, 3, labels)


def _pairs():
    rs = np.random.RandomState(2)
    gt, gen = [], []
    for n in (1, 2, 3, 5, 4):
        gt.append((rs.rand(n, 4).astype(np.float32), rs.randint(0, 3, n)))
        gen.append((rs.rand(n, 4).astype(np.float32), rs.randint(0, 3, n)))
    gen[0] = gt[0]  # an identical pair
    return gt, gen


def test_max_iou_matrix_matches_python():
    for g1, g2 in _groups():
        got = native.max_iou_score_matrix(g1, g2)
        want = np.asarray([[_max_iou_two_layouts(a, b) for b in g2] for a in g1])
        np.testing.assert_allclose(got, want, atol=1e-6)  # float32 boxes in C++


def test_docsim_pairs_match_python():
    gt, gen = _pairs()
    want = [_docsim_pair(a, b) for a, b in zip(gt, gen)]
    np.testing.assert_allclose(native.docsim_pairs(gt, gen), want, atol=1e-6)


@pytest.fixture
def jax_engine():
    # the JAX copy builds beside its source and returns None when that
    # fails (also when another process is rewriting it at the same moment)
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's native engine is unavailable")


def test_engine_equals_the_jax_engine(jax_engine):
    rs = np.random.RandomState(3)
    for maximize in (False, True):
        for _ in range(10):
            cost = rs.rand(rs.randint(1, 12), rs.randint(1, 15))
            for a, b in zip(native.linear_sum_assignment(cost, maximize),
                            jax_native.linear_sum_assignment(cost, maximize)):
                np.testing.assert_array_equal(a, b)
    for g1, g2 in _groups():
        np.testing.assert_array_equal(native.max_iou_score_matrix(g1, g2),
                                      jax_native.max_iou_score_matrix(g1, g2))
    gt, gen = _pairs()
    np.testing.assert_array_equal(native.docsim_pairs(gt, gen),
                                  jax_native.docsim_pairs(gt, gen))


def test_a_failed_build_raises(tmp_path):
    """No silent fallback: a source g++ cannot compile raises with its
    output (the JAX engine returns None there)."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="build failed"):
        native.compile_cached("lsap_broken", lambda: "g++", native.GXX_FLAGS, [bad])
