"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths (``layoutdm_tpu_torch``) at
the flagship LayoutDM width (Rico25: vocab 155, 125 tokens, d_model 464,
8 heads of 58, FFN 1856, 4 layers; random weights from a seed) and checks
them:

1. device       card name, power limit, nvcc version, both kernels built
                in parallel and their build times;
2. kernel       the CUDA attention kernel (K1) against its plain PyTorch
                version at the serving shapes, errors and times;
3. train_kernel the CUDA attention backward (K2) against its plain version
                at the training shapes, errors and times;
4. denoiser     flagship-width logits and posteriors with the kernel against
                the same weights with the plain attention, float32;
5. train        (a) one float32 step's parameter gradients through K1 and
                K2 against the plain versions, same weights and noise;
                (b) bfloat16 train steps at B=1024: samples/s, peak memory,
                K1/K2 launches = layers x steps, and the same steps with the
                plain attention; (c) 20 steps on one batch lower its loss;
6. train_cli    the trainer (`train.loop.train`) on the synthetic dataset
                at flagship width into a job directory, which the service
                then loads and answers a request from;
7. serve        the HTTP service answering unconditional / c / cwh / partial /
                refinement requests, seed determinism, request coalescing,
                the kernel's launch count over the service's runs, and
                batch-1 latency at T=25 and T=100;
8. throughput   unconditional sampling at B=1024, T=100, bfloat16.

Each phase prints one JSON line; then a ``{"kernels": [...]}`` line, the
card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0) and
no result line is printed.  Without CUDA it exits with code 2.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

F32_TOL = 1e-4  # kernel vs plain, float32 (summation order only)
BF16_TOL = 2e-2  # kernel vs plain, bfloat16 (p rounded at other points)
DENOISER_TOL = 1e-3  # 4 layers of float32 GEMMs around the kernel
# K2 against its plain version, relative to the largest gradient: float32
# differs by summation order; bfloat16 by p and ds rounded to bf16 from f32
# values that differ in their last bits, and the bf16 output (2**-8)
BWD_F32_TOL = 1e-5
BWD_BF16_TOL = 1e-2
# float32 parameter gradients of one train step, kernels against plain
# versions, relative to the largest gradient: attention differs by
# summation order (~1e-6), carried through 4 layers of backward GEMMs and
# the loss's logs (seen: 1.2e-5)
GRAD_TOL = 1e-4
KERNELS = {
    "attention_qkv": ("layoutdm_tpu_torch/csrc/attention_qkv.cu",
                      "layoutdm_tpu/ops/attention.py:216"),
    "attention_qkv_bwd": ("layoutdm_tpu_torch/csrc/attention_qkv_bwd.cu",
                          "layoutdm_tpu/ops/attention.py:465"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 25, warmup: int = 5) -> float:
    """Median device time of ``fn()`` in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def flagship_config(dtype: str):
    from layoutdm_tpu.configs import build_train_config

    # the JAX package's config dataclasses (they import no jax); linear
    # quantization: the repo carries no Rico25 clustering weights
    return build_train_config(
        "layoutdm", "rico25",
        ["data.bbox_quantization=linear", f"model.dtype={dtype}"],
    )


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device() -> dict:
    from layoutdm_tpu_torch.ops import attention
    from layoutdm_tpu_torch.ops.cuda_build import find_nvcc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [find_nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    # one nvcc per kernel source, started together
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(attention.kernel_library),
                  pool.submit(attention.bwd_kernel_library)]
        fwd, bwd = (b.result() for b in builds)
    for built in (fwd, bwd):
        print(built.log, file=sys.stderr)  # ptxas registers / smem / spills
    out = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc,
        "kernel_build_s": {"attention_qkv": fwd.build_seconds,
                           "attention_qkv_bwd": bwd.build_seconds},
    }
    emit(out)
    return out


def phase_kernel(device="cuda") -> dict:
    from layoutdm_tpu_torch.ops.attention import (
        attention_qkv_reference,
        fused_attention_qkv,
    )

    g = torch.Generator().manual_seed(0)

    def slab(B, S, H, hd, dtype):
        x = torch.randn((B, S, 3 * H * hd), generator=g)
        return x.to(device=device, dtype=dtype)

    cases = [
        ("s125_f32", 64, 125, 8, 58, torch.float32, 0.0, F32_TOL),
        ("s125_bf16", 64, 125, 8, 58, torch.bfloat16, 0.0, BF16_TOL),
        ("s500_bf16", 8, 500, 8, 58, torch.bfloat16, 0.0, BF16_TOL),
        ("s500_f32", 8, 500, 8, 58, torch.float32, 0.0, F32_TOL),
        ("hd64_scale58_f32", 16, 125, 8, 64, torch.float32, 58 ** -0.5, F32_TOL),
    ]
    errs = {}
    for name, B, S, H, hd, dtype, scale, tol in cases:
        qkv = slab(B, S, H, hd, dtype)
        got = fused_attention_qkv(qkv, H, scale=scale)
        torch.cuda.synchronize()
        want = attention_qkv_reference(qkv, H, scale=scale)
        err = (got.float() - want.float()).abs().max().item()
        if not (got.shape == want.shape and np.isfinite(err) and err <= tol):
            raise AssertionError(f"kernel case {name}: max abs err {err} > {tol}")
        errs[name] = err

    times = {}
    for name, B, S in (("b1024_s125_bf16", 1024, 125), ("b256_s500_bf16", 256, 500)):
        qkv = slab(B, S, 8, 58, torch.bfloat16)
        times[name] = {
            "kernel_ms": cuda_ms(lambda: fused_attention_qkv(qkv, 8)),
            "plain_ms": cuda_ms(lambda: attention_qkv_reference(qkv, 8)),
        }
    out = {"phase": "kernel", "max_abs_err": errs, "times": times}
    emit(out)
    return out


def phase_denoiser(device="cuda", batch=8, cfg=None) -> dict:
    """Same weights, kernel attention vs plain attention, float32."""
    from layoutdm_tpu_torch.factory import build_model, build_tokenizer

    cfg = cfg or flagship_config("float32")
    tok = build_tokenizer(cfg)
    gen = torch.Generator().manual_seed(1)
    model = build_model(cfg, tok, device, generator=gen)
    plain = build_model(cfg, tok, device)
    plain.net.load_state_dict(model.net.state_dict())

    rs = np.random.RandomState(2)
    ids = torch.as_tensor(
        rs.randint(0, model.num_classes, (batch, model.seq_len)), device=device
    )
    with torch.inference_mode():
        T = model.q.num_timesteps
        t = torch.full((batch,), T // 2, device=device)
        got = model.net(ids, t)
        want = plain_attention(plain.net, ids, t)
        logit_err = (got - want).abs().max().item()
        if not (torch.isfinite(got).all() and logit_err <= DENOISER_TOL):
            raise AssertionError(f"denoiser logits max abs err {logit_err}")
        post_err = {}
        for step in (T - 1, 3 * T // 4, T // 2, T // 4, 0):  # 99 75 50 25 0
            t = torch.full((batch,), step, device=device)
            pg = model.q.q_posterior_ids(model._predict_start(ids, t), ids, t)
            pw = plain.q.q_posterior_ids(
                plain_attention(plain._predict_start, ids, t), ids, t
            )
            post_err[step] = (pg - pw).abs().max().item()
            if not (torch.isfinite(pg).all() and post_err[step] <= DENOISER_TOL):
                raise AssertionError(f"posterior t={step} max abs err {post_err[step]}")
    out = {
        "phase": "denoiser",
        "d_model": model.backbone_cfg.d_model,
        "num_layers": model.backbone_cfg.num_layers,
        "logits_max_abs_err": logit_err,
        "posterior_max_abs_err": post_err,
    }
    emit(out)
    return out


def phase_train_kernel(device="cuda") -> dict:
    from layoutdm_tpu_torch.ops.attention import (
        attention_qkv_bwd_reference,
        fused_attention_qkv_bwd,
    )

    g = torch.Generator().manual_seed(5)

    def inputs(B, S, H, hd, dtype):
        qkv = torch.randn((B, S, 3 * H * hd), generator=g)
        do = torch.randn((B, S, H * hd), generator=g)
        return qkv.to(device=device, dtype=dtype), do.to(device=device, dtype=dtype)

    cases = [
        ("s125_f32", 64, 125, 8, 58, torch.float32, 0.0, BWD_F32_TOL),
        ("s125_bf16", 64, 125, 8, 58, torch.bfloat16, 0.0, BWD_BF16_TOL),
        ("s500_bf16", 8, 500, 8, 58, torch.bfloat16, 0.0, BWD_BF16_TOL),
        ("s500_f32", 8, 500, 8, 58, torch.float32, 0.0, BWD_F32_TOL),
        ("hd64_scale58_f32", 16, 125, 8, 64, torch.float32, 58 ** -0.5, BWD_F32_TOL),
    ]
    errs, rel = {}, {}
    for name, B, S, H, hd, dtype, scale, tol in cases:
        qkv, do = inputs(B, S, H, hd, dtype)
        got = fused_attention_qkv_bwd(qkv, do, H, scale=scale)
        torch.cuda.synchronize()
        want = attention_qkv_bwd_reference(qkv, do, H, scale=scale).float()
        err = (got.float() - want).abs().max().item()
        rel[name] = err / want.abs().max().item()
        if not (got.shape == want.shape and np.isfinite(err) and rel[name] <= tol):
            raise AssertionError(
                f"K2 case {name}: max abs err {err} ({rel[name]} of the largest "
                f"gradient) > {tol}"
            )
        errs[name] = err

    times = {}
    for name, B, S in (("b1024_s125_bf16", 1024, 125), ("b256_s500_bf16", 256, 500)):
        qkv, do = inputs(B, S, 8, 58, torch.bfloat16)
        times[name] = {
            "kernel_ms": cuda_ms(lambda: fused_attention_qkv_bwd(qkv, do, 8)),
            "plain_ms": cuda_ms(lambda: attention_qkv_bwd_reference(qkv, do, 8)),
        }
        del qkv, do
        torch.cuda.empty_cache()
    out = {"phase": "train_kernel", "max_abs_err": errs, "rel_err": rel, "times": times}
    emit(out)
    return out


class _PlainAttention(torch.autograd.Function):
    """The differentiable attention through the plain versions of K1 and K2."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        from layoutdm_tpu_torch.ops.attention import attention_qkv_reference

        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return attention_qkv_reference(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        from layoutdm_tpu_torch.ops.attention import attention_qkv_bwd_reference

        (qkv,) = ctx.saved_tensors
        dqkv = attention_qkv_bwd_reference(qkv, do.to(qkv.dtype), ctx.num_heads, ctx.scale)
        return dqkv, None, None


def plain_attention(fn, *args):
    """``fn(*args)`` with the denoiser's attention on the plain versions."""
    import layoutdm_tpu_torch.models.nn as nn_mod
    from layoutdm_tpu_torch.ops.attention import attention_qkv_reference

    saved = nn_mod.fused_attention_qkv, nn_mod.fused_attention_qkv_diff
    nn_mod.fused_attention_qkv = attention_qkv_reference
    nn_mod.fused_attention_qkv_diff = (
        lambda qkv, num_heads, scale=0.0: _PlainAttention.apply(qkv, num_heads, scale)
    )
    try:
        return fn(*args)
    finally:
        nn_mod.fused_attention_qkv, nn_mod.fused_attention_qkv_diff = saved


def random_layouts(rs: np.random.RandomState, B: int, cfg) -> dict:
    """Dense layout batch of the config's shape, 1..max elements per row."""
    S, C = cfg.dataset.max_seq_length, cfg.dataset.num_categories
    n = rs.randint(1, S + 1, (B, 1))
    return {
        "label": rs.randint(0, C, (B, S)).astype(np.int32),
        "bbox": rs.rand(B, S, 4).astype(np.float32),
        "mask": np.arange(S)[None] < n,
    }


def profile_steps(run, n: int) -> dict:
    """Device time per step by kernel over ``run(n)`` under torch.profiler
    (its wall time includes the profiler's host cost; the idle share is
    taken against the unprofiled step time by the caller)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(n)
    per_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            per_name[e.name][1] += 1
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "kernel_ms_per_step": sum(v[0] for v in per_name.values()) / n,
        "kernels_per_step": sum(v[1] for v in per_name.values()) / n,
        "top_kernels_ms_per_step": [[k[:80], ms / n] for k, (ms, _) in top],
    }


def phase_train(device="cuda", cfg32=None, cfg16=None, batch=1024, steps=10,
                warmup=2, plain_steps=5, overfit_batch=256, overfit_steps=20,
                profile_steps_n=2, smi="") -> dict:
    from layoutdm_tpu_torch.factory import build_model, build_tokenizer
    from layoutdm_tpu_torch.ops import attention
    from layoutdm_tpu_torch.train.step import (
        eval_loss,
        init_train_state,
        make_optimizer,
        train_step,
    )

    def cuda_gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def optimizer(model, cfg):
        return make_optimizer(model.net, cfg.optimizer.lr, cfg.training.weight_decay,
                              tuple(cfg.optimizer.betas))

    rs = np.random.RandomState(6)
    # (a) float32 gradients of one step: kernels against plain versions
    cfg32 = cfg32 or flagship_config("float32")
    tok = build_tokenizer(cfg32)
    model = build_model(cfg32, tok, device, generator=torch.Generator().manual_seed(7))
    tokens = model.preprocess(random_layouts(rs, 8, cfg32))

    def grads():
        model.net.zero_grad(set_to_none=True)
        losses, _ = model.loss(tokens, model.init_state(), cuda_gen(8))
        sum(losses.values()).backward()
        return {n: p.grad.clone() for n, p in model.net.named_parameters()}

    got = grads()
    want = plain_attention(grads)
    scale = max(g.abs().max().item() for g in want.values())
    grad_err = max((got[n] - want[n]).abs().max().item() for n in want)
    if not (np.isfinite(grad_err) and grad_err <= GRAD_TOL * scale):
        raise AssertionError(
            f"float32 gradients: max abs err {grad_err} > {GRAD_TOL} x {scale}"
        )
    del model, got, want

    # (b) bfloat16 steps at B=batch, kernels, then the plain versions
    cfg16 = cfg16 or flagship_config("bfloat16")
    model = build_model(cfg16, tok, device, generator=torch.Generator().manual_seed(9))
    state = init_train_state(model, optimizer(model, cfg16), cfg16.training.grad_norm_clip)
    gen = cuda_gen(10)
    batches = [model.preprocess(random_layouts(rs, batch, cfg16)) for _ in range(4)]

    def run(n):
        metrics = [train_step(state, batches[i % len(batches)], gen) for i in range(n)]
        torch.cuda.synchronize()
        return metrics

    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = attention.LAUNCHES_BWD = 0
    run(warmup)
    t0 = time.perf_counter()
    metrics = run(steps)
    sec = time.perf_counter() - t0
    launches, launches_bwd = attention.LAUNCHES, attention.LAUNCHES_BWD
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    layers = model.backbone_cfg.num_layers
    if launches_bwd != layers * (warmup + steps) or launches != launches_bwd:
        raise AssertionError(
            f"train launches K1 {launches} / K2 {launches_bwd} != "
            f"num_layers x steps = {layers * (warmup + steps)}"
        )
    losses = [m["loss"].item() for m in metrics]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train losses {losses}")
    profile = profile_steps(run, profile_steps_n)
    plain_attention(run, 1)
    t0 = time.perf_counter()
    plain_attention(run, plain_steps)
    plain_sec = time.perf_counter() - t0

    # (c) the loss of one fixed batch falls when the model trains on it
    fixed = model.preprocess(random_layouts(rs, overfit_batch, cfg16))
    probe = lambda: eval_loss(model, model.init_state(), fixed, cuda_gen(11)).item()
    before = probe()
    fit = [train_step(state, fixed, gen)["loss"].item() for _ in range(overfit_steps)]
    after = probe()
    if not (np.isfinite(after) and after < before):
        raise AssertionError(f"fixed-batch loss did not fall: {before} -> {after}")

    out = {
        "phase": "train",
        "grad_f32_b8": {"max_abs_err": grad_err, "largest_grad": scale,
                        "rel_err": grad_err / scale, "tol": GRAD_TOL},
        "batch": batch,
        "dtype": "bfloat16",
        "steps_timed": steps,
        "samples_per_s": batch * steps / sec,
        "ms_per_step": 1e3 * sec / steps,
        "plain_samples_per_s": batch * plain_steps / plain_sec,
        "plain_ms_per_step": 1e3 * plain_sec / plain_steps,
        "peak_mem_gib": peak_gib,
        "profile": profile,
        "idle_share": 1.0 - profile["kernel_ms_per_step"] / (1e3 * sec / steps),
        "launches": launches,
        "launches_bwd": launches_bwd,
        "backward_steps": warmup + steps,
        "train_losses": losses,
        "overfit": {"batch": overfit_batch, "steps": overfit_steps,
                    "eval_loss_before": before, "eval_loss_after": after,
                    "train_loss_first": fit[0], "train_loss_last": fit[-1]},
        "nvidia_smi": smi,
    }
    emit(out)
    return out


def phase_train_cli(device="cuda", overrides=()) -> dict:
    from layoutdm_tpu.configs import build_train_config
    from layoutdm_tpu_torch.ops import attention
    from layoutdm_tpu_torch.serve_cli import LayoutService
    from layoutdm_tpu_torch.train.loop import train

    with tempfile.TemporaryDirectory() as d:
        cfg = build_train_config("layoutdm", "synthetic", [
            "debug=true", "training.sample_plot_epoch_interval=0",
            f"job_dir={d}/job", f"dataset.dir={d}/datasets", *overrides,
        ])
        attention.LAUNCHES = attention.LAUNCHES_BWD = 0
        t0 = time.perf_counter()
        result = train(cfg, device=device)
        sec = time.perf_counter() - t0
        launches_bwd = attention.LAUNCHES_BWD
        if not (np.isfinite(result["best_val_loss"]) and launches_bwd > 0):
            raise AssertionError(f"trainer result {result}, K2 launches {launches_bwd}")
        with open(os.path.join(cfg.job_dir, "metrics.jsonl")) as f:
            epochs = [json.loads(line) for line in f]
        service = LayoutService(cfg.job_dir, max_batch_size=8, warm_tasks=(),
                                device=device)
        try:
            resp = service.generate("unconditional", 2, 3, None)
        finally:
            service.close()
    _check_layouts(resp, 2, cfg.dataset.num_categories)
    out = {
        "phase": "train_cli",
        "d_model": cfg.backbone.shrunk(29 / 32).d_model,  # as LayoutDM builds it
        "quantization": cfg.data.bbox_quantization,
        "epochs": len(epochs),
        "val_loss": [e["val_loss"] for e in epochs],
        "train_seconds": sec,
        "launches_bwd": launches_bwd,
        "served_layouts": len(resp["layouts"]),
    }
    emit(out)
    return out


def _post(url, payload):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _check_layouts(resp, n, num_labels, labels=None):
    lays = resp["layouts"]
    if len(lays) != n:
        raise AssertionError(f"expected {n} layouts, got {len(lays)}")
    for lay in lays:
        if len(lay["label"]) != len(lay["bbox"]):
            raise AssertionError("label/bbox length mismatch")
        if not all(0 <= c < num_labels for c in lay["label"]):
            raise AssertionError(f"label out of range: {lay['label']}")
        for b in lay["bbox"]:
            if len(b) != 4 or not all(0.0 <= v <= 1.0 for v in b):
                raise AssertionError(f"bbox out of [0, 1]: {b}")
        if labels is not None and sorted(lay["label"]) != sorted(labels):
            raise AssertionError(f"c task changed labels {labels} -> {lay['label']}")


def phase_serve(device="cuda", cfg=None, ladder=(25, 100), max_batch=64,
                n_latency=10, smi="") -> dict:
    from layoutdm_tpu_torch.factory import build_model, build_tokenizer
    from layoutdm_tpu_torch.ops import attention
    from layoutdm_tpu_torch.serve_cli import (
        LayoutHTTPServer,
        LayoutService,
        make_handler,
    )
    from layoutdm_tpu_torch.utils.params import save_job

    cfg = cfg or flagship_config("bfloat16")
    t_short, t_long = min(ladder), max(ladder)
    num_labels = cfg.dataset.num_categories
    layout = {
        "label": [0, 2, 3],
        "bbox": [[0.5, 0.1, 0.9, 0.1], [0.3, 0.5, 0.4, 0.3], [0.7, 0.8, 0.3, 0.1]],
    }
    with tempfile.TemporaryDirectory() as job_dir:
        model = build_model(
            cfg, build_tokenizer(cfg), "cpu", generator=torch.Generator().manual_seed(3)
        )
        save_job(cfg, model.net.state_dict(), job_dir)
        del model
        service = LayoutService(
            job_dir, max_batch_size=max_batch, timestep_ladder=ladder, device=device
        )
    httpd = LayoutHTTPServer(("127.0.0.1", 0), make_handler(service))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        attention.LAUNCHES = 0
        steps0, runs0 = service.steps, service.runs

        r = _post(url, {"task": "unconditional", "batch_size": 1, "seed": 1,
                        "num_timesteps": t_long})
        _check_layouts(r, 1, num_labels)
        a = _post(url, {"task": "unconditional", "batch_size": 8, "seed": 7})
        b = _post(url, {"task": "unconditional", "batch_size": 8, "seed": 7})
        _check_layouts(a, 8, num_labels)
        if a["layouts"] != b["layouts"]:
            raise AssertionError("same seed gave different layouts")
        for task in ("c", "cwh", "partial", "refinement"):
            r = _post(url, {"task": task, "batch_size": 2, "seed": 5,
                            "layout": layout})
            _check_layouts(r, 2, num_labels,
                           layout["label"] if task == "c" else None)
        r = _post(url, {"task": "unconditional", "batch_size": 1, "seed": 2,
                        "num_timesteps": t_short})
        _check_layouts(r, 1, num_labels)

        # coalescing: 16 concurrent batch-1 requests, queued behind a long
        # run, must equal their serial results and share chain runs
        req = lambda s: {"task": "unconditional", "batch_size": 1, "seed": s,
                         "num_timesteps": t_short}
        serial = {s: _post(url, req(s))["layouts"] for s in range(100, 116)}
        results = {}
        blocker = threading.Thread(target=_post, args=(url, req(99) | {
            "num_timesteps": t_long}))
        blocker.start()
        time.sleep(0.05)
        runs_before = service.runs
        clients = [
            threading.Thread(
                target=lambda s=s: results.__setitem__(s, _post(url, req(s))["layouts"])
            )
            for s in serial
        ]
        for c in clients:
            c.start()
        for c in clients + [blocker]:
            c.join(timeout=600)
        burst_runs = service.runs - runs_before
        if results != serial:
            raise AssertionError("coalesced results differ from serial ones")
        if burst_runs >= 16:
            raise AssertionError(f"16 concurrent requests took {burst_runs} runs")

        # batch-1 latency per ladder rung (host clock; the service
        # synchronises when it copies the result back)
        latency = {}
        for T in (t_short, t_long):
            ms = []
            for i in range(n_latency):
                t0 = time.perf_counter()
                _post(url, {"task": "unconditional", "batch_size": 1,
                            "seed": 1000 + i, "num_timesteps": T})
                ms.append((time.perf_counter() - t0) * 1e3)
            latency[f"T{T}_p50_ms"] = statistics.median(ms)

        launches = attention.LAUNCHES
        steps = service.steps - steps0
        expected = cfg.backbone.num_layers * steps
        if launches != expected or launches == 0:
            raise AssertionError(
                f"kernel launches {launches} != num_layers x steps = {expected}"
            )
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    out = {
        "phase": "serve",
        "requests_ok": True,
        "chain_runs": service.runs - runs0,
        "coalesced_burst_runs": burst_runs,
        "chain_steps": steps,
        "kernel_launches": launches,
        "batch1_latency": latency,
        "max_batch_size": max_batch,
        "nvidia_smi": smi,
    }
    emit(out)
    return out


def phase_throughput(device="cuda", batch=1024, cfg=None, smi="") -> dict:
    from layoutdm_tpu_torch.factory import build_model

    cfg = cfg or flagship_config("bfloat16")
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(4))
    seeds = torch.arange(batch, dtype=torch.int64)
    model.sample(seeds, batch, num_timesteps_eval=5)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.sample(seeds, batch)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if not (out["bbox"].shape == (batch, cfg.dataset.max_seq_length, 4)
            and torch.isfinite(out["bbox"]).all()):
        raise AssertionError("throughput run produced malformed layouts")
    res = {
        "phase": "throughput",
        "batch": batch,
        "num_timesteps": model.q.num_timesteps,
        "seconds": sec,
        "layouts_per_s": batch / sec,
        "nvidia_smi": smi,
    }
    emit(res)
    return res


def main() -> int:
    if not torch.cuda.is_available() or torch.version.cuda is None:
        print("chip_smoke: no CUDA device (needs an NVIDIA GPU)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = phase_device()
    smi = dev["nvidia_smi"]
    kern = phase_kernel()
    bwd = phase_train_kernel()
    phase_denoiser()
    tr = phase_train(smi=smi)
    phase_train_cli()
    serve = phase_serve(smi=smi)
    phase_throughput(smi=smi)

    rows = []
    for name, phase, launches in (("attention_qkv", kern, serve["kernel_launches"]),
                                  ("attention_qkv_bwd", bwd, tr["launches_bwd"])):
        t = phase["times"]["b1024_s125_bf16"]
        source, replaces = KERNELS[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(phase["max_abs_err"].values()),
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
        })
    emit({"kernels": rows})
    print(dev["nvidia_smi"])
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
