"""Traffic is a function of the seed: the seeds a run derives, the weights
made from them and the training pool."""

import numpy as np
import torch

from perfbench.lib import harness, registry
from perfbench.reference import denoiser
from perfbench.reference.tokens import Vocab


def test_run_seeds_are_deterministic_in_the_seed():
    def seeds(seed):
        return harness.Context(cell={}, cfg={}, seed=seed, seconds=1.0, trace=False,
                               device=None, started=0.0).seeds(4)

    big = 2**33 + 17  # a seed wider than 32 bits
    assert seeds(big) == seeds(big) and seeds(big) != seeds(7)
    assert len(set(seeds(big))) == 4 and all(0 <= s < 2**32 for s in seeds(big))


def test_weights_are_deterministic_in_the_seed():
    cfg = dict(registry.config("layoutdm-rico25"), d_model=64, nhead=2, dim_feedforward=64,
               num_layers=1)
    V = Vocab.of(cfg).size
    a, b, c = (denoiser.make_params(cfg, V, s, torch.device("cpu")) for s in (5, 5, 6))
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_pool_is_deterministic_in_the_seed():
    from perfbench.traffic.train import pool_layouts

    a = pool_layouts(np.random.default_rng(9), 64, 25, 25)
    b = pool_layouts(np.random.default_rng(9), 64, 25, 25)
    c = pool_layouts(np.random.default_rng(10), 64, 25, 25)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["bbox"], c["bbox"])
    # valid elements first, padding at the tail
    m = a["mask"]
    assert (m[:, :1]).all() and (np.diff(m.astype(int), axis=1) <= 0).all()
