"""The per-phase metrics: a Chrome trace reduced to device time by program
span (`yardstick/spans.py`), on a hand-made trace; the reduction the other
metrics read, unchanged by the spans; each per-phase metric on a stretch
with and without spans; and the stretch itself driven on the CPU at toy
size, where it counts the spans and finds no device time."""

import copy

import pytest
import torch

from perfbench.lib import phases, registry
from perfbench.yardstick import spans as yspans
from perfbench.yardstick import trace as ytrace

from perfbench_toy import SAMPLE, TRAIN, toy_root

PER_PHASE = ["denoise_ms.sample", "attention_ms.sample", "ffn_ms.sample", "step_tail_ms.sample",
             "forward_ms.train", "backward_ms.train", "optimizer_ms.train"]


def host(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def device(cat, name, ts, dur, correlation):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": correlation}}


# a train step on the main thread (tid 1), its backward's kernel launched
# from autograd's thread (tid 2), a copy, a fill, and a kernel launched
# after the step; the device's own copy of a span and the window mark
EVENTS = [
    host("user_annotation", "perfbench.window", 0, 400),
    host("user_annotation", "layoutdm.train_step", 0, 100),
    host("user_annotation", "layoutdm.forward", 0, 40),
    host("user_annotation", "layoutdm.denoise", 5, 30),
    host("user_annotation", "layoutdm.backward", 40, 40),
    host("user_annotation", "layoutdm.optimizer", 80, 20),
    host("cpu_op", "aten::mm", 9, 3),
    host("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
    host("cuda_runtime", "cudaMemcpyAsync", 38, 1, correlation=2),
    host("cuda_runtime", "cudaLaunchKernel", 50, 2, tid=2, correlation=3),
    host("cuda_driver", "cuMemsetD32Async", 90, 1, correlation=4),
    host("cuda_runtime", "cudaLaunchKernel", 150, 2, correlation=5),
    device("kernel", "gemm", 20, 1000, 1),
    device("gpu_memcpy", "Memcpy HtoD", 1030, 500, 2),
    device("kernel", "gemm_backward", 1600, 2000, 3),
    device("gpu_memset", "Memset", 3700, 200, 4),
    device("kernel", "late", 3950, 300, 5),
    device("gpu_user_annotation", "layoutdm.forward", 20, 1600, 0),
]


def test_device_time_goes_to_every_span_that_launched_it():
    r = yspans.reduce(EVENTS)
    assert {n: (v["device_s"] * 1e6, v["count"]) for n, v in r["spans"].items()} == {
        "layoutdm.train_step": (pytest.approx(3700), 1),
        "layoutdm.forward": (pytest.approx(1500), 1),
        "layoutdm.denoise": (pytest.approx(1000), 1),
        "layoutdm.backward": (pytest.approx(2000), 1),  # launched on autograd's thread
        "layoutdm.optimizer": (pytest.approx(200), 1),
    }
    assert r["outside_s"] == pytest.approx(300e-6)
    assert r["device_s"] == pytest.approx(4000e-6)


def test_spans_repeat_and_overlap_across_threads():
    """Two steps count twice; a span open on two threads at once counts
    a launch inside both once."""
    second = [dict(e, ts=e["ts"] + 10_000) for e in EVENTS]
    for e in second:
        if "correlation" in e["args"]:
            e["args"] = {"correlation": e["args"]["correlation"] + 100}
    twin = host("user_annotation", "layoutdm.forward", 2, 30, tid=3)
    r = yspans.reduce(EVENTS + second + [twin])
    assert r["spans"]["layoutdm.train_step"]["count"] == 2
    assert r["spans"]["layoutdm.forward"]["count"] == 3
    assert r["spans"]["layoutdm.forward"]["device_s"] == pytest.approx(3000e-6)
    assert r["outside_s"] == pytest.approx(600e-6)


def test_the_spans_leave_the_other_metrics_reduction_as_it_was():
    """``reduce``'s keys read the same with the program's spans in the
    trace and without them (but the idle gaps, which may now be named by
    the span the host was in)."""
    plain = [e for e in EVENTS if not e["name"].startswith("layoutdm.")
             or e["cat"] != "user_annotation"]
    a, b = ytrace.reduce(EVENTS, (0, 4400)), ytrace.reduce(plain, (0, 4400))
    for key in ("busy_s", "window_s", "device_ops", "kernel_s", "kernel_count", "launches"):
        assert a[key] == b[key], key


def read(name, phases_of):
    return registry.metric(name).read({"trace": {"busy_s": 1.0, "phases": phases_of},
                                       "counters": {}, "cfg": {}, "cell": {}})


def test_each_per_phase_metric_reads_none_without_spans():
    plain = [e for e in EVENTS if not e["name"].startswith("layoutdm.")]
    for name in PER_PHASE:
        assert read(name, yspans.reduce(plain)) is None, name
        assert registry.metric(name).read({"trace": None, "counters": {}, "cfg": {},
                                           "cell": {}}) is None
        # a run without device time (the CPU) measures no stretch
        assert registry.metric(name).read({"trace": {"busy_s": 0.0}, "counters": {},
                                           "cfg": {}, "cell": {}}) is None


def test_each_per_phase_metric_reads_milliseconds_a_step():
    def of(**device_s_count):
        return {"spans": {f"layoutdm.{n}": {"device_s": s, "count": c}
                          for n, (s, c) in device_s_count.items()},
                "outside_s": 0.0, "device_s": 0.0}

    chain = of(step=(2.0, 100), denoise=(1.5, 100), attention=(0.4, 400), ffn=(0.6, 400))
    train = of(train_step=(0.55, 10), forward=(0.15, 10), backward=(0.35, 10),
               optimizer=(0.04, 10), denoise=(0.1, 10))
    got = {n: read(n, chain if n.endswith(".sample") else train) for n in PER_PHASE}
    assert got == pytest.approx({"denoise_ms.sample": 15.0, "attention_ms.sample": 4.0,
                                 "ffn_ms.sample": 6.0, "step_tail_ms.sample": 5.0,
                                 "forward_ms.train": 15.0, "backward_ms.train": 35.0,
                                 "optimizer_ms.train": 4.0})


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    pb = toy_root(str(tmp_path_factory.mktemp("toy")))
    return registry.config("toy", pb), pb


@pytest.mark.parametrize("cell_name,params", [("rico25-uncond-b1024", SAMPLE),
                                              ("rico25-train-b1024", TRAIN)])
def test_the_stretch_counts_the_program_s_spans(toy, cell_name, params):
    cfg, pb = toy
    cell = dict(copy.deepcopy(registry.cell(cell_name, pb)), **params)
    r = phases.measure(cfg, cell, torch.device("cpu"))
    counts = {n: v["count"] for n, v in r["spans"].items()}
    layers = cfg["num_layers"]
    if cell["traffic"] == "train":
        n = phases.STEPS
        assert counts == {"layoutdm.train_step": n, "layoutdm.forward": n,
                          "layoutdm.backward": n, "layoutdm.optimizer": n,
                          "layoutdm.denoise": n, "layoutdm.attention": n * layers,
                          "layoutdm.ffn": n * layers}
    else:
        T = cfg["num_timesteps"]
        assert counts == {"layoutdm.step": T, "layoutdm.denoise": T,
                          "layoutdm.attention": T * layers, "layoutdm.ffn": T * layers}
    assert r["device_s"] == 0.0  # no device time on the CPU
