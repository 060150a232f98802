"""The port's profiling hooks (`layoutdm_tpu_torch.utils.profiling`): a CPU
`sample_cli` run with ``trace_dir`` writes a Chrome trace that holds the
program's spans, and the same layouts, byte for byte, as a run without it
(a relation-guided chain included: the trace leaves its grad mode as it
was); the spans of the reverse chain, of BART's decode and of the train
step nest as the module's table says, change no number, and enter nothing
while no profiler records."""

import json
import os
import pickle

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from layoutdm_tpu_torch.configs import build_train_config
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.sample_cli import main as sample_main
from layoutdm_tpu_torch.train.step import (
    init_train_state,
    make_optimizer,
    make_train_step,
    train_step,
)
from layoutdm_tpu_torch.utils import profiling as tprof
from layoutdm_tpu_torch.utils.params import save_job

T = 12  # relation guidance runs at t >= 10
LAYERS = 2
B = 4


def tiny_config(root, layers):
    return build_train_config("layoutdm", "synthetic", [
        f"job_dir={root}/job", f"dataset.dir={root}/datasets", "dataset.max_seq_length=5",
        "data.bbox_quantization=linear", "backbone.d_model=64", "backbone.nhead=2",
        "backbone.dim_feedforward=32", f"backbone.num_layers={layers}",
        f"model.num_timesteps={T}", f"backbone.diffusion_step={T}",
    ])


def tiny_model(cfg):
    return build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A tiny untrained LayoutDM job on the synthetic dataset."""
    cfg = tiny_config(tmp_path_factory.mktemp("trace"), layers=1)
    save_job(cfg, tiny_model(cfg).net.state_dict(), cfg.job_dir)
    return cfg.job_dir


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    return tiny_config(tmp_path_factory.mktemp("spans"), layers=LAYERS)


@pytest.fixture(scope="module")
def tokens(cfg):
    """Training ids: a chain of the tiny model."""
    return tiny_model(cfg).sample_ids(torch.Generator().manual_seed(5), B)


def spans_of(events):
    """The program's spans of a Chrome trace: [(name, start, end)] by start."""
    return sorted((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith("layoutdm."))


def traced(fn, path):
    """``fn()`` under a CPU profiler: its result and the program's spans."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return out, spans_of(json.load(f)["traceEvents"])


def inside(spans, name, outer):
    """The spans called ``name`` that lie within the span ``outer``."""
    return [s for s in spans if s[0] == name and outer[1] <= s[1] and s[2] <= outer[2]]


@pytest.mark.parametrize("cond", ["partial", "relation"])
def test_trace_dir_writes_a_trace_and_the_same_layouts(job, tmp_path, cond):
    def run(name, *extra):
        args = [f"job_dir={job}", f"result_dir={tmp_path / name}", f"cond={cond}",
                "device=cpu", "debug_num_samples=4", "max_batch_size=4",
                f"num_timesteps={T}", *extra]
        (path,) = sample_main(args)
        with open(path, "rb") as f:
            return pickle.load(f)

    plain = run("plain")
    traced_run = run("traced", f"trace_dir={tmp_path / 'trace'}")
    (trace,) = list((tmp_path / "trace").iterdir())
    assert trace.name == f"trace_{os.getpid()}.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    # every reverse step of the chains (the warm-up's too), each with its
    # denoiser call and the job's one layer
    names = [s[0] for s in spans_of(events)]
    steps = names.count("layoutdm.step")
    assert steps and steps % T == 0
    assert [names.count(f"layoutdm.{n}") for n in ("denoise", "attention", "ffn")] == [steps] * 3
    # the layouts and inputs byte for byte; the config but for trace_dir
    for key in ("results", "inputs", "train_cfg"):
        assert pickle.dumps(traced_run[key]) == pickle.dumps(plain[key]), key
    assert traced_run["test_cfg"]["trace_dir"] == str(tmp_path / "trace")
    assert {**traced_run["test_cfg"], "trace_dir": None, "result_dir": None} == \
        {**plain["test_cfg"], "result_dir": None}
    assert ("violation_rate" in traced_run) == (cond == "relation")
    if cond == "relation":
        assert traced_run["violation_rate"] == plain["violation_rate"]


def test_trace_keeps_the_grad_mode(tmp_path):
    with torch.no_grad(), tprof.maybe_trace(str(tmp_path)):
        assert not torch.is_grad_enabled() and not torch.is_inference_mode_enabled()
    with torch.inference_mode(), tprof.maybe_trace(str(tmp_path / "b")):
        assert torch.is_inference_mode_enabled()
    with tprof.maybe_trace(None):
        assert torch.is_grad_enabled()
    assert len(list(tmp_path.glob("*.json"))) == 1


def chain(cfg, regime):
    """A tiny model's reverse chain of T steps: whole-batch noise from one
    generator, or per-row seeds."""
    model = tiny_model(cfg)
    rng = (torch.Generator().manual_seed(3) if regime == "generator"
           else torch.arange(B, dtype=torch.int64) + 11)
    return model.sample_ids(rng, B)


def one_train_step(cfg, how, tokens):
    """One AdamW step of a fresh tiny model on ``tokens``; the parameters
    after it."""
    model = tiny_model(cfg)
    opt = make_optimizer(model.net)
    state = init_train_state(model, opt)
    step = train_step if how == "train_step" else make_train_step(model, opt)
    step(state, tokens, torch.Generator().manual_seed(7))
    return {n: p.detach().clone() for n, p in model.net.named_parameters()}


@pytest.mark.parametrize("what", ["chain", "train_step"])
def test_spans_enter_nothing_without_a_profiler(cfg, tokens, tmp_path, monkeypatch, what):
    entered = []

    class Counted(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    run = (lambda: chain(cfg, "generator")) if what == "chain" else \
        (lambda: one_train_step(cfg, "train_step", tokens))
    run()
    assert entered == []
    traced(run, tmp_path / "t.json")  # the count sees them where a profiler records
    assert entered and all(n.startswith("layoutdm.") for n in entered)


@pytest.mark.parametrize("regime", ["generator", "row_seeds"])
def test_chain_spans_nest_and_change_no_id(cfg, tmp_path, regime):
    plain = chain(cfg, regime)
    ids, spans = traced(lambda: chain(cfg, regime), tmp_path / "t.json")
    assert torch.equal(ids, plain)
    steps = [s for s in spans if s[0] == "layoutdm.step"]
    assert len(steps) == T
    for step in steps:
        (denoise,) = inside(spans, "layoutdm.denoise", step)
        assert len(inside(spans, "layoutdm.attention", denoise)) == LAYERS
        assert len(inside(spans, "layoutdm.ffn", denoise)) == LAYERS
    # every span of the chain lies in one of its steps
    assert all(any(st[1] <= s[1] and s[2] <= st[2] for st in steps) for s in spans)


@pytest.mark.parametrize("how", ["train_step", "make_train_step"])
def test_train_step_spans_nest_and_change_no_parameter(cfg, tokens, tmp_path, how):
    plain = one_train_step(cfg, how, tokens)
    after, spans = traced(lambda: one_train_step(cfg, how, tokens), tmp_path / "t.json")
    assert plain.keys() == after.keys()
    assert all(torch.equal(after[n], plain[n]) for n in plain)
    (whole,) = [s for s in spans if s[0] == "layoutdm.train_step"]
    phases = [inside(spans, n, whole) for n in
              ("layoutdm.forward", "layoutdm.backward", "layoutdm.optimizer")]
    assert [len(p) for p in phases] == [1, 1, 1]
    (forward,), (backward,), (update,) = phases
    assert forward[2] <= backward[1] and backward[2] <= update[1]
    # the forward holds the denoiser call and its layers
    (denoise,) = inside(spans, "layoutdm.denoise", forward)
    assert len(inside(spans, "layoutdm.attention", denoise)) == LAYERS
    assert len(inside(spans, "layoutdm.ffn", denoise)) == LAYERS


@pytest.mark.parametrize("use_cache", [True, False])
def test_bart_decode_spans_nest_and_change_no_token(tmp_path, use_cache):
    """BART's ``c`` decode: the encoder pass once, a decode step a
    generated token holding each decoder layer's three sublayers, every
    span inside one of them; the cached steps counted by ``DECODE_STEPS``."""
    from layoutdm_tpu_torch.models import bart as bart_mod
    from layoutdm_tpu_torch.tasks import get_cond, to_sampler_cond

    cfg = build_train_config("bart", "synthetic", [
        "dataset.max_seq_length=4", "data.bbox_quantization=linear", "backbone.d_model=64",
        "backbone.nhead=2", "backbone.dim_feedforward=64", f"backbone.num_layers={LAYERS}"])
    model = tiny_model(cfg)
    batch = {"label": torch.tensor([[1, 2, 0, 0], [3, 0, 0, 0]]), "bbox": torch.rand(2, 4, 4),
             "mask": torch.tensor([[True, True, False, False], [True, False, False, False]])}
    sc = to_sampler_cond(get_cond(batch, model.tokenizer, "c", model_type="bart"),
                         model.tokenizer, cfg.sampling)

    def decode():
        return model.sample_ids(torch.Generator().manual_seed(2), 2, cond=sc,
                                use_cache=use_cache)

    plain = decode()
    before = bart_mod.DECODE_STEPS
    ids, spans = traced(decode, tmp_path / "t.json")
    assert torch.equal(ids, plain)
    G = model.gen_len
    assert bart_mod.DECODE_STEPS - before == (G if use_cache else 0)
    assert len([s for s in spans if s[0] == "layoutdm.encode"]) == 1
    steps = [s for s in spans if s[0] == "layoutdm.decode_step"]
    assert len(steps) == G
    for step in steps:
        for name in ("dec_self_attention", "cross_attention", "dec_ffn"):
            assert len(inside(spans, f"layoutdm.{name}", step)) == LAYERS
    outer = steps + [s for s in spans if s[0] == "layoutdm.encode"]
    assert all(any(o[1] <= s[1] and s[2] <= o[2] for o in outer) for s in spans)
