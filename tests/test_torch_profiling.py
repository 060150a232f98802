"""The port's profiling hooks (`layoutdm_tpu_torch.utils.profiling`): a CPU
`sample_cli` run with ``trace_dir`` writes a Chrome trace and the same
layouts, byte for byte, as a run without it (a relation-guided chain
included: the trace leaves its grad mode as it was), and `Throughput`
gives the JAX package's numbers on the same clock."""

import json
import os
import pickle
import time

import pytest
import torch

from layoutdm_tpu.utils import profiling as jprof
from layoutdm_tpu_torch.configs import build_train_config
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.sample_cli import main as sample_main
from layoutdm_tpu_torch.utils import profiling as tprof
from layoutdm_tpu_torch.utils.params import save_job

T = 12  # relation guidance runs at t >= 10


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A tiny untrained LayoutDM job on the synthetic dataset."""
    root = tmp_path_factory.mktemp("trace")
    cfg = build_train_config("layoutdm", "synthetic", [
        f"job_dir={root}/job", f"dataset.dir={root}/datasets", "dataset.max_seq_length=5",
        "data.bbox_quantization=linear", "backbone.d_model=64", "backbone.nhead=2",
        "backbone.dim_feedforward=32", "backbone.num_layers=1",
        f"model.num_timesteps={T}", f"backbone.diffusion_step={T}",
    ])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    save_job(cfg, model.net.state_dict(), cfg.job_dir)
    return cfg.job_dir


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
    traced = run("traced", f"trace_dir={tmp_path / 'trace'}")
    (trace,) = list((tmp_path / "trace").iterdir())
    assert trace.name == f"trace_{os.getpid()}.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    # the layouts and inputs byte for byte; the config but for trace_dir
    for key in ("results", "inputs", "train_cfg"):
        assert pickle.dumps(traced[key]) == pickle.dumps(plain[key]), key
    assert traced["test_cfg"]["trace_dir"] == str(tmp_path / "trace")
    assert {**traced["test_cfg"], "trace_dir": None, "result_dir": None} == \
        {**plain["test_cfg"], "result_dir": None}
    assert ("violation_rate" in traced) == (cond == "relation")
    if cond == "relation":
        assert traced["violation_rate"] == plain["violation_rate"]


def test_trace_keeps_the_grad_mode(tmp_path):
    with torch.no_grad(), tprof.maybe_trace(str(tmp_path)):
        assert not torch.is_grad_enabled() and not torch.is_inference_mode_enabled()
    with torch.inference_mode(), tprof.maybe_trace(str(tmp_path / "b")):
        assert torch.is_inference_mode_enabled()
    with tprof.maybe_trace(None):
        assert torch.is_grad_enabled()
    assert len(list(tmp_path.glob("*.json"))) == 1


def test_throughput_matches_jax(monkeypatch):
    """The same measure calls on the same (stepped) clock."""
    def counters(mod):
        ticks = iter(0.125 * i * i for i in range(100))
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        tp = mod.Throughput()
        empty = (tp.items_per_sec, tp.ms_per_item)
        for n in (3, 8, 1):
            with tp.measure(n):
                pass
        return empty, tp.items, tp.seconds, tp.items_per_sec, tp.ms_per_item

    got, want = counters(tprof), counters(jprof)
    assert got == want
    assert got[0] == (0.0, 0.0) and got[1] == 12
