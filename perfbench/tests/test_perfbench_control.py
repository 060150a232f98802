"""On the card: the lower-precision control fails the comparison that the
program passes (the program's own int8 path for the sampling cells, the
reference in float8 in the program's place for training), at the cells'
widths and a batch a test run can hold.  The limits were set
between the readings of a dozen seeds of the program and three of the
control at the cells' own sizes (``perfbench/calibrate.py``; PERF.md)."""

import time

import pytest

from perfbench.lib import harness, registry

pytestmark = pytest.mark.cuda


def run(card, cell_name, seed, control=None, seconds=2.0):
    c = registry.cell(cell_name)
    ctx = harness.Context(cell=c, cfg=registry.config(c["config"]), seed=seed, seconds=seconds,
                          trace=False, device=card, started=time.perf_counter())
    traffic = registry.traffic(c["traffic"])
    out = traffic.run(ctx, control=traffic.CONTROLS[control] if control else None)
    return {n: ok for n, _, _, ok in harness.judge(out.compared, ctx.limits)}


@pytest.mark.parametrize("cell,seconds", [("rico25-uncond-b1024", 2.0),
                                          ("publaynet-e100-uncond-b256", 2.0)])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sampling_control_fails(card, cell, seconds, seed):
    assert all(run(card, cell, seed, seconds=seconds).values())
    assert not run(card, cell, seed, "int8", seconds=seconds)["token_gap_mean"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_training_control_fails(card, seed):
    assert all(run(card, "rico25-train-b1024", seed).values())
    verdict = run(card, "rico25-train-b1024", seed, "fp8")
    assert not (verdict["loss_rel_gap"] and verdict["grad_leaf_gap"])
