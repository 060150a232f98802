"""The frozen yardsticks read what the port's bench and smoke read."""

import pytest

from perfbench.lib import registry
from perfbench.reference.denoiser import widths
from perfbench.yardstick import flops, roofline


@pytest.mark.parametrize("config,gflop", [("layoutdm-rico25", 272.0167),
                                          ("layoutdm-publaynet-e100", 1226.2028)])
def test_flops_per_layout(config, gflop):
    cfg = registry.config(config)
    assert round(flops.flops_per_layout(cfg) / 1e9, 4) == gflop
    assert flops.train_flops_per_sample(cfg) == 3 * flops.flops_per_layout(cfg, 1)


def test_k1_and_k2_bounds_at_the_flagship():
    d = widths(registry.config("layoutdm-rico25"))[0]
    assert d == 464
    assert round(roofline.bound_ms(*roofline.attention_fwd(1024, 125, d)), 3) == 0.142
    assert round(roofline.bound_ms(*roofline.attention_bwd(1024, 125, d)), 3) == 0.248
    # the same 128k tokens at S = 500: four times the operations, still
    # bound by the bytes (the smoke's 0.142 ms for K1 there too)
    nbytes, ops = roofline.attention_fwd(256, 500, d)
    assert ops == 4 * roofline.attention_fwd(1024, 125, d)[1]
    assert round(roofline.bound_ms(nbytes, ops), 3) == 0.142


def test_shares_are_never_zero_where_nothing_was_read():
    for name in registry.names("metrics"):
        m = registry.metric(name)
        assert m.read({"trace": None, "counters": {}, "cfg": registry.config("layoutdm-rico25"),
                       "cell": {}}) is None
