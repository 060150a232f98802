"""The port's bench entry points (`layoutdm_tpu_torch.bench`) on the CPU:
their FLOP counts equal the JAX bench's, every entry point refuses to run
without a card unless asked for the CPU, each gives rows with the JAX
bench's keys and no device rate, the serve bench counts coalesced runs,
and the trace summary parses a trace; with the S=500 chain held
token-identical to the JAX package's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu.configs import BackboneConfig, ModelConfig, SamplingConfig
from layoutdm_tpu.models.layoutdm import LayoutDM as JaxLayoutDM
from layoutdm_tpu.tokenizer.bbox import BboxTokenizer as JaxBbox
from layoutdm_tpu.tokenizer.sequence import LayoutSequenceTokenizer as JaxTok
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.bench import (
    common,
    e2e_bigshape,
    headline,
    int8,
    profile_trace,
    serve,
    train,
    zoo,
)
from layoutdm_tpu_torch.bench.flops import flops_per_layout, train_flops_per_sample
from layoutdm_tpu_torch.models.diffusion import sampler as tsampler
from layoutdm_tpu_torch.models.layoutdm import LayoutDM
from layoutdm_tpu_torch.tokenizer.bbox import BboxTokenizer
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer
from layoutdm_tpu_torch.utils.params import params_from_flax

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP_FLOPS = 272_016_700_000  # the JAX bench's count at T=100
PUBLAYNET_FLOPS = 1_226_202_800_000  # 5 categories, 100 elements: S=500, V=135
TINY = ["backbone.d_model=64", "backbone.nhead=2", "backbone.dim_feedforward=32",
        "backbone.num_layers=1", "model.num_timesteps=10", "backbone.diffusion_step=10"]
# the JAX bench's row keys (`bench.py:233-243`, `:290-298`, `:331-341`,
# `bin/bench_serve.py:80-89`), less the rates a CPU row does not carry
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "batch", "est_gflops_per_layout"}
TRAIN_KEYS = {"metric", "value", "unit", "batch", "ms_per_step"}
PUBLAYNET_KEYS = HEADLINE_KEYS | {"seq_tokens"}
SERVE_KEYS = {"t_eval", "threads", "batch_size", "requests", "req_per_s", "layouts_per_s",
              "p50_ms", "p95_ms", "program_runs"}
E2E_KEYS = {"max_elements", "seq_tokens", "epochs", "train_s", "best_val_loss", "tasks",
            "eval_s", "metrics", "artifacts"}
ROW_KEYS = {"device", "card", "power_limit_w", "runs", "spread"}


def check_cpu_row(r, keys):
    assert keys | ROW_KEYS <= set(r), sorted(keys | ROW_KEYS - set(r))
    assert (r["device"], r["card"], r["power_limit_w"]) == ("cpu", "cpu", None)
    assert not set(common.DEVICE_ONLY_KEYS) & set(r), r
    assert r["runs"] and r["spread"]["min"] <= r["spread"]["median"] <= r["spread"]["max"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these toy shapes: under the parallel test
    workers, several processes' thread pools on the same cores wait on
    each other at every small operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_counts():
    """`bench.flops_per_layout` of `bench.build_flagship` at both shapes, in
    a child interpreter (bench.py sets a compile cache when imported)."""
    code = ("import bench\n"
            "print(bench.flops_per_layout(bench.build_flagship()))\n"
            "print(bench.flops_per_layout(bench.build_flagship(num_categories=5, "
            "max_elements=100)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return [int(x) for x in out.stdout.split()]


def test_flops_per_layout_equals_the_jax_bench(jax_counts):
    flag = headline.build_flagship(headline.flagship_config(), "cpu")
    pub = headline.build_flagship(headline.flagship_config("publaynet", 100), "cpu")
    assert (flag.backbone_cfg.d_model, flag.backbone_cfg.dim_feedforward) == (464, 1856)
    assert (pub.seq_len, pub.num_classes) == (500, 135)
    assert [flops_per_layout(flag), flops_per_layout(pub)] == jax_counts
    assert jax_counts == [FLAGSHIP_FLOPS, PUBLAYNET_FLOPS]
    assert train_flops_per_sample(flag) == 3 * flops_per_layout(flag, num_timesteps=1)
    assert 100 * train_flops_per_sample(flag) == 3 * FLAGSHIP_FLOPS


@pytest.mark.parametrize("entry,argv", [
    (headline.main, []),
    (train.main, []),
    (serve.main, ["--url", "http://127.0.0.1:9"]),
    (zoo.main, []),
    (e2e_bigshape.main, []),
    (profile_trace.main, ["--steps", "1"]),
    (int8.main, []),
])
def test_entry_points_refuse_to_run_without_a_card(entry, argv, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(argv + ["--out" if entry is not profile_trace.main else "--trace_dir",
                      str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_headline_train_and_publaynet_rows_on_the_cpu(tmp_path):
    rows = headline.run("cpu", batch=3, runs=2, train_batch=4, train_steps=2,
                        publaynet_batch=2, overrides=TINY, out=str(tmp_path))
    assert [r["metric"] for r in rows] == [
        "rico25_uncond_layouts_per_sec_chip_T10",
        "rico25_uncond_layouts_per_sec_chip_T10_per_row_seed",
        "rico25_train_samples_per_sec_chip",
        "publaynet_scale_uncond_layouts_per_sec_chip_T10",
    ]
    for r, keys in zip(rows, (HEADLINE_KEYS, HEADLINE_KEYS, TRAIN_KEYS, PUBLAYNET_KEYS)):
        check_cpu_row(r, keys)
        assert r["value"] == pytest.approx(np.median(r["runs"]))
    assert (rows[0]["regime"], rows[1]["regime"]) == ("generator", "per_row_seed")
    assert rows[3]["seq_tokens"] == 500 and np.isfinite(rows[2]["final_loss"])
    with open(tmp_path / "headline.jsonl") as f:
        assert [json.loads(line)["metric"] for line in f] == [r["metric"] for r in rows]


def test_train_sweep_rows_on_the_cpu(tmp_path):
    rows = train.run("cpu", batches=(2, 4), steps=1, runs=1, overrides=TINY, out=str(tmp_path))
    assert [r["batch"] for r in rows[:2]] == [2, 4]
    for r in rows:
        check_cpu_row(r, TRAIN_KEYS)
    assert rows[-1]["metric"] == "rico25_train_samples_per_sec_chip"
    assert rows[-1]["value"] == max(r["value"] for r in rows[:2])


def test_serve_rows_and_coalescing_against_a_cpu_service(tmp_path, monkeypatch):
    """A child service on the CPU (T=4) with a ladder of one rung: a
    sequential and a concurrent scenario a rung, and 4 concurrent batch-1
    clients share runs."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the child's thread pool
    cfg = headline.flagship_config(overrides=TINY[:4] + [
        "model.num_timesteps=4", "backbone.diffusion_step=4"], dtype="float32")
    job = serve.write_random_job(str(tmp_path / "job"), cfg)
    rows = serve.run(job_dir=job, ladder=(2,), max_batch_size=8, device="cpu",
                     threads=(4,), n_sequential=2, out=str(tmp_path / "out"))
    assert [(r["t_eval"], r["threads"], r["batch_size"]) for r in rows] == [
        (2, 1, 8), (2, 4, 1), (None, 1, 8), (None, 4, 1)]
    for r in rows:
        check_cpu_row(r, SERVE_KEYS)
        assert r["requests"] == len(r["runs"]) and r["p50_ms"] <= r["p95_ms"]
        assert 1 <= r["program_runs"] <= r["requests"]
    assert [r["requests"] for r in rows[:2]] == [2, 16]
    log = (tmp_path / "out" / "serve_cli.log").read_text()
    assert "listening on" in log and "device=cpu" in log


def test_zoo_rows_on_the_cpu(tmp_path):
    rows = zoo.run("cpu", batch=3, iters=1, runs=1, experiments=("layoutdm", "ruite"),
                   ladder=(5,), overrides=TINY, out=str(tmp_path))
    assert [(r["experiment"], r.get("t_eval")) for r in rows] == [
        ("layoutdm", None), ("ruite", None), ("layoutdm", 5),
        ("layoutdm+relation_guidance", None)]
    for r in rows:
        check_cpu_row(r, {"ms_per_batch", "layouts_per_sec", "batch"})


def test_e2e_bigshape_summary_at_ten_elements(tmp_path):
    overrides = TINY[:4] + ["model.num_timesteps=20", "backbone.diffusion_step=20",
                            "training.sample_plot_epoch_interval=0"]
    s = e2e_bigshape.run(str(tmp_path), epochs=1, num_samples=4, max_elements=10,
                         device="cpu", overrides=overrides)
    check_cpu_row(s, E2E_KEYS)
    assert (s["max_elements"], s["seq_tokens"], s["artifacts"]["pickles"]) == (10, 50, 6)
    assert set(s["tasks"]) == set(e2e_bigshape.TASKS)
    assert np.isfinite(s["best_val_loss"]) and "violation" in s["metrics"]
    assert json.loads((tmp_path / "summary.json").read_text())["epochs"] == 1


def test_int8_rows_on_the_cpu(tmp_path):
    rows = int8.run("cpu", rows=32, runs=1, calls=2, out=str(tmp_path))
    assert [r["metric"] for r in rows] == [f"int8_bench_{n}" for n in (
        "bf16_pair", "int8_pair", "int8_pair_dynamic", "int_mm", "quantize", "dequantize",
        "int8_dense")]
    for r in rows:
        check_cpu_row(r, {"value", "unit"})


def test_profile_trace_summarizes_a_cpu_trace(tmp_path):
    trace_dir = str(tmp_path / "trace")
    captured = profile_trace.main(["--device", "cpu", "--batch", "2", "--steps", "2",
                                   "--trace_dir", trace_dir, *TINY[:4]])
    parsed = profile_trace.main(["--summarize", trace_dir])
    for r in (captured, parsed):
        check_cpu_row(r, {"trace", "kernel_ms", "kernels", "top", "steps"})
        assert r["events"] > 0 and r["kernels"] == 0 and r["steps"] == 2


def test_profile_trace_joins_kernels_to_their_launching_op(tmp_path):
    """Device time summed by kernel name; a kernel's op is the innermost
    CPU op around its launch, ``-`` where no op was open."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "pid": 1, "tid": 1, "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "pid": 1, "tid": 1, "ts": 10,
         "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 20, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 200, "dur": 5, "args": {"correlation": 8}},
    ] + [{"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
          "args": {"correlation": c}}
         for name, ts, dur, c in (("gemm", 30, 2000, 7), ("attention_fwd", 210, 500, 8),
                                  ("gemm", 3000, 1000, 7))]
    (tmp_path / "trace_1.json").write_text(json.dumps(
        {"traceEvents": ev, "deviceProperties": [{"name": "NVIDIA H100 80GB HBM3"}]}))
    r = profile_trace.summarize(str(tmp_path))
    assert (r["kernel_ms"], r["kernels"], r["card"], r["device"]) == (
        3.5, 3, "NVIDIA H100 80GB HBM3", "cuda")
    assert r["top"] == [
        {"kernel": "gemm", "ms": 3.0, "count": 2, "aten_op": "aten::addmm"},
        {"kernel": "attention_fwd", "ms": 0.5, "count": 1, "aten_op": "-"}]


def test_publaynet_scale_chain_token_identical_to_jax(monkeypatch):
    """The S=500 tokenizer (5 categories, 100 elements, V=135), a narrow
    denoiser (2 layers, d 32 -> 29, one head), three T_eval steps of the
    random sampler with the JAX chain's own Gumbel draws injected."""
    bb = dict(d_model=32, nhead=1, dim_feedforward=32, num_layers=2, dropout=0.0,
              timestep_type="adalayernorm", diffusion_step=10)
    tok = dict(num_categories=5, max_elements=100, special_tokens=("pad", "mask"),
               pad_until_max=True)
    jt = JaxTok(bbox_tokenizer=JaxBbox(num_bins=32, shared_vocab="x-y-w-h",
                                       quantization="linear"), **tok)
    tt = LayoutSequenceTokenizer(bbox_tokenizer=BboxTokenizer(
        num_bins=32, shared_vocab="x-y-w-h", quantization="linear"), **tok)
    jm = JaxLayoutDM(BackboneConfig(**bb), jt, ModelConfig(num_timesteps=10))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = LayoutDM(tconfigs.BackboneConfig(**bb), tt, tconfigs.ModelConfig(num_timesteps=10),
                  device="cpu")
    tm.net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    assert (tm.seq_len, tm.num_classes, jm.seq_len, jm.num_classes) == (500, 135, 500, 135)

    B, T_eval, key = 2, 3, jax.random.PRNGKey(4)
    want = np.asarray(jm.sample_ids(params, key, B, sampling=SamplingConfig(name="random"),
                                    num_timesteps_eval=T_eval))
    # the JAX chain splits its key once a step and draws the categorical's
    # Gumbel noise from the second half (`sampler.py` step, `ops/samplers.py`)
    draws, rng = [], key
    for _ in range(T_eval):
        rng, r_samp = jax.random.split(rng)
        draws.append(torch.as_tensor(np.array(
            jax.random.gumbel(r_samp, (B, 500, 135), jnp.float32)))[None])
    noise = iter(draws)
    monkeypatch.setattr(tsampler, "gumbel_noise", lambda rng, shape, device=None: next(noise))
    got = tm.sample_ids(torch.Generator().manual_seed(0), B,
                        sampling=tconfigs.SamplingConfig(name="random"), num_timesteps_eval=T_eval)
    assert next(noise, None) is None
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 10  # the noise moved the chain off a constant
