"""Each cell, driven whole on the CPU at toy size with the chip check
skipped, comes out correct as it is and not correct with its timed path
broken underneath: a step that returns its state unchanged; half of the
batch left out, the mean taken over the rest (training); a token or an
answer altered where it is produced.  (The exchange between chips is not
a fault these one-chip cells can have.)"""

import pytest

import layoutdm_tpu_torch.models.diffusion.sampler as sampler
from perfbench.lib import harness, registry

from perfbench_toy import SAMPLE, TRAIN, context, toy_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(str(tmp_path_factory.mktemp("toy")))


def correct(ctx, out) -> bool:
    verdicts = harness.judge(out.compared, ctx.limits)
    return all(ok for *_, ok in verdicts) and out.failed < out.attempted


@pytest.mark.parametrize("fault", [None, "frozen", "token"])
def test_batch_sampling(root, fault, monkeypatch):
    monkeypatch.setattr(sampler, "sample_tokens", sampler.sample_tokens)
    traffic = registry.traffic("batch_sample", root)
    ctx = context(root, "rico25-uncond-b1024", **SAMPLE)
    out = traffic.run(ctx, fault=traffic.FAULTS[fault] if fault else None)
    assert correct(ctx, out) == (fault is None), out.compared


@pytest.mark.parametrize("fault", [None, "frozen_step", "half_batch"])
def test_training(root, fault):
    traffic = registry.traffic("train", root)
    ctx = context(root, "rico25-train-b1024", trace=fault is None, **TRAIN)
    out = traffic.run(ctx, fault=traffic.FAULTS[fault] if fault else None)
    assert correct(ctx, out) == (fault is None), out.compared
    if fault == "frozen_step":
        assert out.compared["change_leaf_gap"] == pytest.approx(1.0)


def test_result_line_of_a_traced_run(root):
    """The per-layer metrics a traced run can read on the CPU, the
    breakdown, and the compared numbers last."""
    ctx = context(root, "rico25-uncond-b1024", trace=True, **SAMPLE)
    out = registry.traffic("batch_sample", root).run(ctx)
    line = harness.result_line(ctx, out, {"platform": "cpu", "kind": "cpu", "count": 1})
    assert line["correct"] is True and list(line)[-1] == "compared"
    assert set(line["metrics"]) == {"mfu.sample"}  # no device time on the CPU
    assert line["device"]["window_s"] > 0 and "breakdown" in line
    assert len(line["breakdown"]["idle_gaps"]) <= 10


def test_chain_tap_reports_what_it_missed():
    """A chain whose calls the taps no longer see (one captured in a CUDA
    graph, say) is named, and counted against ``correct`` by the cell."""
    from types import SimpleNamespace

    from perfbench.lib.tap import ChainTap

    model = SimpleNamespace(_predict_start=None, sample_ids=None, device="cpu")
    tap = ChainTap(model)
    assert tap.faults(0, 100) == []
    tap.records = [{"steps": [0] * 100}, {"steps": [0]}]
    assert len(tap.faults(2, 100)) == 1 and "saw 1" in tap.faults(2, 100)[0]
    assert "3 chains ran" in tap.faults(3, 100)[0]
