"""The encoder-decoder cell (``traffic/encdec_sample.py``), driven whole on
the CPU at toy size: correct as it is, not correct with its decode
broken underneath (a cache position off by one, another row's cross keys
and values, a forced token not forced, the noise drawn not the noise
replayed); its caches rounded to float8, and the reference in float8 in
its place (the controls), move the logits, and on the card fail; the spans its traced stretch counts; the builder holding
the program to the configuration file; the reference loading nothing of
the program; and the analytic work of a step."""

import json
import os
import shutil
import time

import pytest
import torch

from perfbench.lib import encdec as program
from perfbench.lib import harness, registry
from perfbench.reference import encdec
from perfbench.yardstick import encdec as yencdec

from test_perfbench_imports import FORBIDDEN, loaded_by

CELL = "bart-rico25-c-b4096"
# 2 + 2 layers, 64 -> 42 wide (2 heads of 21), FFN 64 -> 42, 5 elements (26 positions)
TOY = {"d_model": 64, "nhead": 2, "dim_feedforward": 64, "num_layers": 2, "max_elements": 5}
KEYS = {"d_model": "backbone.d_model", "nhead": "backbone.nhead",
        "dim_feedforward": "backbone.dim_feedforward", "num_layers": "backbone.num_layers",
        "max_elements": "dataset.max_seq_length"}
TOY_CELL = {"batch": 8, "check_rows": 8, "conditions": 2}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The benchmark copied beside the program with a ``toy-bart``
    configuration in float32."""
    tmp = str(tmp_path_factory.mktemp("toy"))
    pb = os.path.join(tmp, "perfbench")
    shutil.copytree(registry.ROOT, pb, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(registry.REPO, "BENCHMARK.json"), tmp)
    cfg = registry.config("bart-rico25", pb)
    cfg.update(TOY, name="toy-bart", dtype="float32")
    cfg["program_overrides"] = ["data.bbox_quantization=linear", "model.dtype=float32"] + [
        f"{KEYS[k]}={v}" for k, v in TOY.items()]
    with open(os.path.join(pb, "configs", "toy-bart.json"), "w") as f:
        json.dump(cfg, f)
    return pb


def context(pb, trace=False, seed=2**31 + 23):
    c = dict(registry.cell(CELL, pb), config="toy-bart", **TOY_CELL)
    return harness.Context(cell=c, cfg=registry.config("toy-bart", pb), seed=seed,
                           seconds=0.3, trace=trace, device=torch.device("cpu"),
                           started=time.perf_counter(), root=pb)


def verdicts(ctx, out):
    return {n: ok for n, _, _, ok in harness.judge(out.compared, ctx.limits)}


@pytest.mark.parametrize("fault", [None, "cache_position", "cross_row", "unforced", "noise"])
def test_faults_in_the_decode_come_out_not_correct(root, fault):
    traffic = registry.traffic("encdec_sample", root)
    ctx = context(root)
    out = traffic.run(ctx, fault=traffic.FAULTS[fault] if fault else None)
    ok = verdicts(ctx, out)
    assert all(ok.values()) == (fault is None), out.compared
    if fault == "unforced":
        assert not ok["forced_mismatch"]
    elif fault == "noise":
        assert not ok["token_gap_mean"] and ok["logit_gap_max"]
    elif fault:
        assert not ok["logit_gap_max"]
    assert out.compared["chains_unchecked"] == 0 and out.compared["steps_missing"] == 0


@pytest.mark.parametrize("control", ["fp8_cache", "fp8"])
def test_fp8_controls_move_the_logits(root, control):
    """At toy size in float32 either control moves the logits ten
    thousand times as far as the program's own rounding; whether that
    fails the cell's limits is a question of its size, answered on the
    card (`test_fp8_controls_fail_on_the_card`)."""
    traffic = registry.traffic("encdec_sample", root)
    program_gap = traffic.run(context(root)).compared["logit_gap_max"]
    out = traffic.run(context(root), control=traffic.CONTROLS[control])
    assert out.compared["logit_gap_max"] > 1e4 * program_gap, out.compared


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_controls_fail_on_the_card(card, seed):
    """At the cell's size the program passes, its caches rounded to float8
    fail ``logit_gap_max``, and the reference in float8 in its place fails
    both ``logit_gap_max`` and ``token_gap_mean`` (the limits were set
    between the program's readings and the controls', 10 s runs;
    PERF.md)."""
    c = registry.cell(CELL)
    traffic = registry.traffic(c["traffic"])
    failing = {None: set(), "fp8_cache": {"logit_gap_max"},
               "fp8": {"logit_gap_max", "token_gap_mean"}}
    for control, want in failing.items():
        ctx = harness.Context(cell=c, cfg=registry.config(c["config"]), seed=seed, seconds=3.0,
                              trace=False, device=card, started=time.perf_counter())
        out = traffic.run(ctx, control=traffic.CONTROLS[control] if control else None)
        ok = verdicts(ctx, out)
        assert {n for n, v in ok.items() if not v} == want, (control, out.compared)


def test_traced_run_counts_the_decode_spans(root):
    """A traced run's per-phase stretch holds the encoder pass once, a
    decode step a generated token, and each decoder sublayer once a layer
    and step; on the CPU there is no device time, so the device metrics
    read nothing and the host-clock share reads."""
    ctx = context(root, trace=True)
    out = registry.traffic("encdec_sample", root).run(ctx)
    counts = {n: v["count"] for n, v in out.trace["phases"]["spans"].items()}
    G, L = 5 * TOY["max_elements"], TOY["num_layers"]
    assert counts == {"layoutdm.encode": 1, "layoutdm.decode_step": G,
                      "layoutdm.dec_self_attention": G * L, "layoutdm.cross_attention": G * L,
                      "layoutdm.dec_ffn": G * L, "layoutdm.attention": L,
                      "layoutdm.ffn": L}
    assert out.trace["phases"]["decode_steps"] == G
    line = harness.result_line(ctx, out, {"platform": "cpu", "kind": "cpu", "count": 1})
    assert line["correct"] is True and set(line["metrics"]) == {"mfu.bart"}


def test_builder_refuses_a_program_that_departs_from_the_file(root, monkeypatch):
    cfg = registry.config("toy-bart", root)
    params = encdec.make_params(cfg, encdec.Vocab.of(cfg).size, 0, torch.device("cpu"))
    model = program.build(cfg, params, torch.device("cpu"))
    assert type(model).__name__ == "BART" and model.seq_len == 26
    with pytest.raises(ValueError, match="pos_emb"):
        program.build(dict(cfg, pos_emb="elem_attr"), params, torch.device("cpu"))
    with pytest.raises(ValueError, match="var_order"):
        program.train_config(dict(cfg, var_order="c-x-y-w-h"))
    monkeypatch.setenv("LAYOUTDM_TPU_FUSED_FFN", "1")  # the default path, whatever is set
    assert not program.build(cfg, params, torch.device("cpu")).net.dec0.fused_ffn


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded_by("import perfbench.reference.encdec, perfbench.yardstick.encdec")
    assert not mods & (FORBIDDEN | {"layoutdm_tpu_torch"}), sorted(mods)


def test_a_step_s_work_at_the_cell_s_size():
    """At B=4096, in bf16: the cross keys and values 2.77 GB a step, the
    self cache 1.41 GB on average (63 positions read, one written), the
    decoder's weights 12.7 MB, the float32 logits 1 MB; a layout about
    3.39 GFLOP."""
    cfg = registry.config("bart-rico25")
    nbytes, flops = yencdec.decode_step_work(cfg, 4096)
    B, d, ff, M, L, V = 4096, 336, 1344, 126, 4, 61
    cross, self_kv = B * L * 2 * M * d * 2, B * L * 2 * d * 64 * 2
    weights = (L * (6 * d * d + 2 * d * ff) + d * V) * 2
    assert cross == pytest.approx(2.775e9, rel=1e-3)
    assert nbytes == cross + self_kv + weights + B * V * 4
    assert flops == B * (L * (2 * (6 * d * d + 2 * d * ff) + 4 * (63 + M) * d) + 2 * d * V)
    assert yencdec.flops_per_layout(cfg) == pytest.approx(3.39e9, rel=1e-2)
