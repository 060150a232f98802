"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Times every hand-written kernel in one table, and drives what no test runs
on the card: the port's serving and training paths (``layoutdm_tpu_torch``),
the training and sampling of every other model family (MaskGIT, BLT, RUITE,
the autoregressive LayoutTransformer, VQDiffusion, BART, DiffusionLM,
BitDiffusion, the aggregated LayoutDM), its four denoiser paths (default:
K1; fused: K4 + K3; attn_v2: K5; smajor: K6), relation-guided requests and
the batch sampling CLI at the flagship LayoutDM width (Rico25: vocab 155, 125
tokens, d_model 464, 8 heads of 58, FFN 1856, 4 layers; random weights from
a seed), then the evaluation path on what it sampled (FIDNetV3 at its full
width, d_model 256, trained here: no extractor weights are in the repo).
Each kernel at its edge cases and each denoiser path is held to its plain
version by ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``;
here each kernel is held to it (by ``kernel_checks.py``) at the shapes it
is timed at, and the phases below check launches, outputs and end-to-end
results:

1. device       card name, power limit, nvcc version, the eight kernels
                and the GEMM epilogues' shim built in parallel, their
                build times and ptxas reports;
1a. k1_name     one K1 call at each timed shape is one launch of one
                attention_fwd::attention_bf16_kernel as torch.profiler
                names it.  It runs before every other phase that launches
                a kernel: after other launches of ctypes-launched kernels
                in the process torch.profiler has read no launch of K1 on
                the card (torch 2.11, CUDA 12.8);
2. kernels      `KERNEL_TABLE`: each kernel (K1-K6, the LayerNorm kernel in
                its adaLN mode and its affine mode, bf16 and float32 out)
                at the sampling cells' shapes (B=1024, S=125 and B=256,
                S=500, bf16), K1, K3 and K4 also at BART's and the
                aggregated LayoutDM's widths and K3 at MaskGIT's (with
                MaskGIT's float32 weights, cast by the wrapper on every
                call), each beside its plain version, the library call
                (SDPA, or the unfused path where no single call computes
                it) and its bound, by CUDA events; each kernel's output
                within its tolerance of its plain version's, its max abs
                difference reported; and the FFN's GEMM pair through the
                cuBLASLt epilogues' shim beside the eager chain it replaces
                (B=1024, S=125); the cached decode's attention at BART's
                cell (B=4,096, 8 heads of 42: self-attention at 64
                positions, cross-attention over 126) beside SDPA;
5. train        (a) bfloat16 train steps at B=1024, timed by the bench's
                `headline.train_rates` (a warm-up run and 3 timed runs of
                10 steps): samples/s (median and spread), peak memory,
                K1/K2 launches = layers x steps, and the same steps with the
                plain attention; (b) 20 steps on one batch lower its loss;
5a. zoo         every other family (`phase_zoo`): MaskGIT, BLT, RUITE and
                the autoregressive LayoutTransformer at d_model 512, 8
                heads, FFN 2048, 4 layers, VQDiffusion, DiffusionLM and
                BitDiffusion at 464 / 8 / 1856, BART at 336 / 8 / 1344, the
                aggregated LayoutDM at 432 / 8 / 1728, Rico25, bf16: train
                steps at B=256 (samples/s), sampling at B=256 (layouts/s;
                the diffusion families T=100 with K1 launched layers x
                steps, BART's encoder layers x 1, masked attention
                launching no kernel), MaskGIT under fused_ffn with K3
                launched layers x steps, the weights through a reference
                state dict and back, in float32 the autoregressive and BART
                cached decodes against the recompute decodes, and the four
                new families on the fused, V2 and S-major paths against the
                default;
5b. fidnet_train the FIDNet trainer (`eval.fidnet_train`): FIDNetV3 on the
                synthetic dataset at S = 25, batch 64, 500 steps; the
                validation loss falls, the checkpoint exists, steps/s;
6. train_cli    the trainer (`train.loop.train`) on the synthetic dataset
                at flagship width into a job directory, which the service
                then loads and answers a request from; its FID probe on
                the fidnet_train extractor writes a finite `fid_val` every
                epoch of 10 (seconds per probe), the last from layouts
                that hold elements;
7. serve        the HTTP service answering unconditional / c / cwh / partial /
                refinement requests, seed determinism, request coalescing,
                the kernel's launch count over the service's runs, and
                batch-1 latency at T=25 and T=100;
8. throughput   per-row-seed unconditional sampling at B=1024, T=100,
                bfloat16, timed by the bench's `headline.chain_rows_per_s`
                (a warm-up chain and 3 timed chains: median and spread);
9. fused_serve, fused_throughput, attn_v2_serve, attn_v2_throughput,
                smajor_serve, smajor_throughput: phases 7 and 8 on each
                path, its kernels' launches = layers x chain steps and no
                other attention or FFN kernel launched; attn_v2 and smajor
                also answer relation
                requests (valid layouts, a violation rate, seed determinism);
                every serve phase counts the LayerNorm kernel's launches
                (adaLN: layers x forwards; affine: (layers + 1) x forwards,
                layers x forwards fewer on the fused path, where K3 takes
                norm2);
10. sample_cli  `python -m layoutdm_tpu_torch.sample_cli` (in process) on
                the train_cli job on the attn_v2 path, all six tasks:
                pickles with the JAX CLI's keys, a violation rate for
                relation, K5 launched layers x chain steps;
11. fidnet      the extractor's features of 512 layouts on the card
                against the CPU, and its time at B = 512 and 4096;
12. eval_cli    `python -m layoutdm_tpu_torch.eval_cli` (in process) over
                the six pickles and with `--compute_real`, then over six
                pickles of 4,096 layouts against 4,096-layout splits (not
                model samples: the scorer at a size its users score):
                finite scores (the Wasserstein pair of a pickle with no
                element is NaN, as in the JAX package), seconds split
                between feature extraction, each metric and the rest;
13. render_cli  `python -m layoutdm_tpu_torch.render_cli` on the task-c
                pickle: a non-blank grid and one CSV row per layout;
14. bench       the port's bench entry points (`layoutdm_tpu_torch.bench`)
                at full width: the headline on the default path (T=100,
                B=1024, generator and per-row-seed regimes, FLOPs, MFU
                against the bf16 peak and the measured GEMM ceiling) with
                its train (B=1024) and S=500 (B=256) rows, K1 and K2
                launched exactly layers x steps over their chains and
                train steps; the serve bench against a child ``serve_cli`` on
                a random-weight flagship job at T=25 and T=100 (16
                concurrent batch-1 clients take fewer runs than requests);
                the zoo at 2 calls a run (no relation row); the S=500
                pipeline for one epoch
                (six pickles, scored); the int8 and bf16 GEMM chains; a
                10-step traced chain summarised by kernel (K1 named).
                Every row names the card and its power limit and is finite.

Five more (run in this order: parallel after train, dryrun after
parallel, demo after train_cli, int8 after the throughput phases, trace
after sample_cli):
5c. parallel    a world-1 process group (NCCL, no torchrun): the
                data-parallel and shard_map train steps at B=1024, bf16,
                each against `train_step` on the same batches and noise,
                K1 / K2 launched layers x steps, their samples/s; the
                trainer with `training.num_devices=1` into a job the
                service answers from;
9a. int8        the int8 serving engine (`models.int8_serving`): the
                float32 mirror against the denoiser forward, the bf16
                mirror within the JAX bound, the served int8
                predict_start (its own calibration and head) against the
                bf16 mirror's log-softmax (softmax L1, argmax agreement,
                the JAX bounds); an unconditional T=100 chain at B=1024
                on that predict_start
                (K1 launched layers x steps, valid layouts) beside the
                default path, layouts/s, and ms a step at B=1 and 64;
10a. trace      `sample_cli` with `trace_dir`: a Chrome trace that names
                K1's CUDA symbol;
5d. dryrun      the entry points of `graft_entry`, flagship
                width, float32: `entry`'s forward (K1 once a layer), and
                `dryrun_multichip(1)` on one spawned NCCL rank: the
                data-parallel loss equal to `train_step`'s, the gathered
                chain token-identical to one process's, the gathered
                FIDNetV3 features within 1e-4, K1 / K2 launched layers x
                forwards and layers x train steps;
6a. demo        `python -m layoutdm_tpu_torch.demo` (in process) on the
                train_cli job and with random weights: the seven files of
                each, a GIF frame a step, K1 launched layers x chain steps.

Each phase prints one JSON line and its seconds; then a ``{"kernels": [...]}``
line (each kernel's time at B=1024, S=125 beside its bound, and the share
of the bound it reaches, ``bound_share`` = bound_ms / ms; its launches on
its main path, from the serve and train phases), the
card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failure raises (exit code != 0) and
no result line is printed.  Without CUDA it exits with code 2.
"""

from __future__ import annotations

import json
import os
import re
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
import torch.nn.functional as F

import kernel_checks as checks
from kernel_checks import DENOISER_PATHS, DENOISER_TOL, path_switches
from layoutdm_tpu_torch.bench.common import bound, cuda_ms

# the flagship widths, and the shapes every kernel is timed at in bfloat16:
# (name, batch, sequence, heads, head width, FFN width); the kernels line
# reports the first
FLAG_H, FLAG_HD, FLAG_F = 8, 58, 1856
TIMED_SHAPES = (("b1024_s125_bf16", 1024, 125, FLAG_H, FLAG_HD, FLAG_F),
                ("b256_s500_bf16", 256, 500, FLAG_H, FLAG_HD, FLAG_F))
# the zoo's kernels at its batch: BART (d_model 336) and the aggregated
# LayoutDM (432), and MaskGIT's FFN (512, 2048) with the float32 weights
# MaskGIT passes
ZOO_SHAPES = (("bart_b256_s126_d336", 256, 126, 8, 42, 1344),
              ("aggregated_b256_s25_d432", 256, 25, 8, 54, 1728))
MASKGIT_FFN_SHAPE = ("maskgit_b256_s125_d512_f32_weights", 256, 125, 8, 64, 2048, torch.float32)
# the cached decode's attention at BART's cell (B = 4,096, 8 heads of 42):
# (name, batch, positions, heads, head width, call), self-attention at a
# chain's mean position (64 of its caches' 126) and cross-attention over
# the encoder's 126 positions; and LayoutTransformer's self-attention (8
# heads of 64, 128 bytes: the kernel's rotated start offsets) at the same
# batch and position
DECODE_SHAPES = (("bart_self_b4096_n64", 4096, 64, 8, 42, "self"),
                 ("bart_cross_b4096_m126", 4096, 126, 8, 42, "cross"),
                 ("layouttransformer_self_b4096_n64", 4096, 64, 8, 64, "self"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sdpa_views(qkv: torch.Tensor, num_heads: int):
    """q, k, v of a packed (B, S, 3D) slab as (B, H, S, hd) views, the
    layout ``F.scaled_dot_product_attention`` takes."""
    B, S, D3 = qkv.shape
    hd = D3 // 3 // num_heads
    return qkv.view(B, S, 3, num_heads, hd).permute(2, 0, 3, 1, 4).unbind(0)


def device_kernels(fn, launches=False) -> list:
    """Names of the CUDA kernels one call of ``fn`` launches (which backend
    a library call picked); with ``launches``, a name a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return names if launches else sorted({name[:100] for name in names})


def flagship_config(dtype: str):
    from layoutdm_tpu_torch.bench.headline import flagship_config

    # linear quantization: the repo carries no Rico25 clustering weights
    return flagship_config(dtype=dtype)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device() -> dict:
    from layoutdm_tpu_torch import native
    from layoutdm_tpu_torch.ops import (
        adaln,
        attention,
        attention_blockdiag,
        decode_attention,
        ffn,
        gemm_epilogue,
    )
    from layoutdm_tpu_torch.ops.cuda_build import find_nvcc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [find_nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    # one nvcc per kernel source, started together
    libs = {"attention_qkv": attention.kernel_library,
            "attention_qkv_bwd": attention.bwd_kernel_library,
            "ln_ffn_residual": ffn.kernel_library,
            "attention_block": attention.block_kernel_library,
            "attention_blockdiag": attention_blockdiag.kernel_library,
            "attention_qkv_smajor": attention.smajor_kernel_library,
            "ada_layer_norm": adaln.kernel_library,
            "decode_attention": decode_attention.kernel_library,
            "gemm_epilogue": gemm_epilogue.kernel_library}
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        futures = {name: pool.submit(build) for name, build in libs.items()}
        engine = pool.submit(native.library)  # g++: the metrics' host engine
        built = {name: f.result() for name, f in futures.items()}
        engine = engine.result()
    for name, lib in built.items():
        # ptxas registers / shared memory / spills
        print(f"== {name}\n{lib.log}", file=sys.stderr)
    out = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc,
        "kernel_build_s": {name: lib.build_seconds for name, lib in built.items()},
        "native_build_s": engine.build_seconds,
        "native_flags": list(native.GXX_FLAGS),
    }
    emit(out)
    return out


def phase_k1_name() -> dict:
    """One K1 call at each timed shape is one launch of one kernel named
    attention_fwd::attention_bf16_kernel (`K1_SYMBOL`) by torch.profiler.
    Run it before any other kernel: see the module's note on it."""
    from layoutdm_tpu_torch.ops.attention import fused_attention_qkv

    g = torch.Generator().manual_seed(6)
    calls = {}
    for name, B, S, H, hd, _ in TIMED_SHAPES:
        qkv = torch.randn((B, S, 3 * H * hd), generator=g).to("cuda", torch.bfloat16)
        names = device_kernels(lambda: fused_attention_qkv(qkv, H), launches=True)
        if not (len(names) == 1 and "attention_fwd::attention_bf16_kernel" in names[0]
                and re.search(K1_SYMBOL, names[0])):
            raise AssertionError(f"K1 at {name}: launches {names}, one K1 kernel wanted")
        calls[name] = names[0]
        del qkv
        torch.cuda.empty_cache()
    out = {"phase": "k1_name", "kernels": calls}
    emit(out)
    return out


def _randn(g, shape, scale=1.0, offset=0.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g) * scale + offset).to("cuda", dtype)


def padded_slab(g, B, S, H, hd, hp, dtype) -> torch.Tensor:
    """A random (B, S, 3·H·hp) slab on the card whose heads are zero past
    hd, as the weight scatter makes them."""
    x = torch.zeros((B, S, 3, H, hp))
    x[..., :hd] = torch.randn((B, S, 3, H, hd), generator=g)
    return x.reshape(B, S, 3 * H * hp).to("cuda", dtype)


# Each kernel's calls at a shape (B, S, heads, head width, FFN width), in
# bfloat16: the kernel, its plain version, the library call (None where
# none computes the function), the check of the kernel's output against
# the plain version's (`kernel_checks`) and the bound
# (`bench.common.bound`): bytes counted once read and once written, and the
# products' operations.


def k1_calls(g, B, S, H, hd, Fd) -> dict:
    """K1 beside SDPA's forward: read the (B, S, 3D) slab, write (B, S,
    D); q·kᵀ and p·v."""
    from layoutdm_tpu_torch.ops.attention import attention_qkv_reference, fused_attention_qkv

    qkv, D = _randn(g, (B, S, 3 * H * hd)), H * hd
    q, k, v = sdpa_views(qkv, H)
    return {"kernel": lambda: fused_attention_qkv(qkv, H),
            "plain": lambda: attention_qkv_reference(qkv, H),
            "library": lambda: F.scaled_dot_product_attention(q, k, v),
            "check": checks.attention_errors, **bound(B * S * 4 * D * 2, 4 * B * S * S * D)}


def k2_calls(g, B, S, H, hd, Fd) -> dict:
    """K2 beside SDPA's backward, taken again and again from one forward
    graph: read the slab and dO, write d(qkv); s again, dv, dp, dq, dk."""
    from layoutdm_tpu_torch.ops.attention import (
        attention_qkv_bwd_reference,
        fused_attention_qkv_bwd,
    )

    D = H * hd
    qkv, do = _randn(g, (B, S, 3 * D)), _randn(g, (B, S, D))
    leaf = qkv.clone().requires_grad_()
    o = F.scaled_dot_product_attention(*sdpa_views(leaf, H))
    cot = do.view(B, S, H, hd).transpose(1, 2)
    return {"kernel": lambda: fused_attention_qkv_bwd(qkv, do, H),
            "plain": lambda: attention_qkv_bwd_reference(qkv, do, H),
            "library": lambda: torch.autograd.grad(o, leaf, cot, retain_graph=True)[0],
            "check": checks.bwd_errors, **bound(B * S * 7 * D * 2, 10 * B * S * S * D)}


def k3_calls(g, B, S, H, hd, Fd, weights=torch.bfloat16) -> dict:
    """K3 beside the port's unfused FFN (F.layer_norm, two F.linear, the
    ReLU and the residual add), the closest library path: read x and both
    weights once, write out; two products.  Weights in float32 are cast to
    bf16 by the call (the wrapper, the unfused path) every time."""
    from layoutdm_tpu_torch.ops.ffn import fused_ln_ffn_residual, ln_ffn_residual_reference

    D = H * hd
    p = {"ln_scale": _randn(g, (D,), 0.1, 1.0, torch.float32),
         "ln_bias": _randn(g, (D,), 0.1, dtype=torch.float32),
         "w1": _randn(g, (Fd, D), D ** -0.5, dtype=weights),
         "b1": _randn(g, (Fd,), 0.1, dtype=weights),
         "w2": _randn(g, (D, Fd), Fd ** -0.5, dtype=weights),
         "b2": _randn(g, (D,), 0.1, dtype=weights)}
    x = _randn(g, (B, S, D), 0.5)

    def unfused():
        h = F.layer_norm(x.float(), (D,), p["ln_scale"], p["ln_bias"], 1e-6)
        h = F.relu(F.linear(h.to(x.dtype), p["w1"].to(x.dtype), p["b1"].to(x.dtype)))
        return x + F.linear(h, p["w2"].to(x.dtype), p["b2"].to(x.dtype))

    M, wb = B * S, weights.itemsize
    return {"kernel": lambda: fused_ln_ffn_residual(x, **p, activation="relu"),
            "plain": lambda: ln_ffn_residual_reference(x, **p, activation="relu"),
            "library": unfused, "check": checks.fused_errors,
            **bound(2 * M * D * 2 + 2 * D * Fd * wb + (Fd + D) * wb + 2 * D * 4, 4 * M * D * Fd)}


def k4_calls(g, B, S, H, hd, Fd) -> dict:
    """K4 beside the port's unfused attention (F.linear, K1, F.linear, the
    residual add): read x and both weights once, write out; the
    projections, q·kᵀ and p·v.  Also the times each row's K and V are
    projected, as the launch routes it, and the clusters of the bf16 body
    the card holds at once."""
    from layoutdm_tpu_torch.ops.attention import (
        attention_block_reference,
        block_kernel_library,
        fused_attention_block,
        fused_attention_qkv,
    )

    D = H * hd
    p = {"w_qkv": _randn(g, (3 * D, D), D ** -0.5), "b_qkv": _randn(g, (3 * D,), 0.1),
         "w_out": _randn(g, (D, D), D ** -0.5), "b_out": _randn(g, (D,), 0.1)}
    x = _randn(g, (B, S, D), 0.5)

    def unfused():
        o = fused_attention_qkv(F.linear(x, p["w_qkv"], p["b_qkv"]), H)
        return x + F.linear(o, p["w_out"], p["b_out"])

    lib = block_kernel_library().lib
    return {"kernel": lambda: fused_attention_block(x, **p, num_heads=H),
            "plain": lambda: attention_block_reference(x, **p, num_heads=H),
            "library": unfused, "check": checks.block_errors,
            **bound(2 * B * S * D * 2 + 4 * D * D * 2 + 4 * D * 2,
                    B * (8 * S * D * D + 4 * S * S * D)),
            "kv_projection_passes": lib.attention_block_kv_passes(S, H, hd),
            "resident_clusters": lib.attention_block_max_clusters(H)}


def k5_calls(g, B, S, H, hd, Fd) -> dict:
    """K5 on heads padded to 64 beside SDPA's forward on the padded heads:
    read the padded (B, S, 3·H·hp) slab, write (B, S, H·hp); q·kᵀ and p·v
    over the hp-wide heads."""
    from layoutdm_tpu_torch.ops.attention_blockdiag import (
        blockdiag_attention,
        blockdiag_attention_reference,
        padded_head_dim,
    )

    hp, scale = padded_head_dim(hd), hd ** -0.5
    qkv = padded_slab(g, B, S, H, hd, hp, torch.bfloat16)
    q, k, v = sdpa_views(qkv, H)
    return {"kernel": lambda: blockdiag_attention(qkv, H, hp, scale),
            "plain": lambda: blockdiag_attention_reference(qkv, H, hp, scale),
            "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            "check": checks.attention_errors,
            **bound(B * S * 4 * H * hp * 2, 4 * B * S * S * H * hp)}


def k6_calls(g, B, S, H, hd, Fd) -> dict:
    """K6 on a sequence-major slab plus a bias beside the bias add, the
    transpose to batch-major and SDPA's forward (no single call): read the
    (S, B, 3D) slab and the bias, write (B, S, D)."""
    from layoutdm_tpu_torch.ops.attention import (
        attention_qkv_smajor_reference,
        fused_attention_qkv_smajor,
    )

    D = H * hd
    qkv, bias = _randn(g, (S, B, 3 * D)), _randn(g, (3 * D,), 0.5)

    def library():
        x = (qkv + bias).transpose(0, 1).contiguous()
        return F.scaled_dot_product_attention(*sdpa_views(x, H))

    return {"kernel": lambda: fused_attention_qkv_smajor(qkv, bias, H),
            "plain": lambda: attention_qkv_smajor_reference(qkv, bias, H),
            "library": library, "check": checks.attention_errors,
            **bound(B * S * 4 * D * 2 + 3 * D * 2, 4 * B * S * S * D)}


def adaln_calls(g, B, S, H, hd, Fd) -> dict:
    """The adaLN mode (norm1), no PyTorch call computes it: read x and the
    float32 cond once, write out."""
    from layoutdm_tpu_torch.ops import adaln

    D = H * hd
    x, cond = _randn(g, (B, S, D), 2.0, 0.3), _randn(g, (B, 2 * D), 0.5, dtype=torch.float32)
    return {"kernel": lambda: adaln.ada_layer_norm(x, cond),
            "plain": lambda: adaln.ada_layer_norm_reference(x, cond),
            "library": None, "check": lambda got, _: checks.adaln_errors(got, x, cond),
            **bound(2 * B * S * D * 2 + B * 2 * D * 4, 0)}


def ln_calls(out_dtype):
    """The affine mode, bf16 in and ``out_dtype`` out (bf16: each Block's
    norm2; float32: the heads' norms), none timed beside it: read x, w and
    b once, write out."""
    def calls(g, B, S, H, hd, Fd) -> dict:
        from layoutdm_tpu_torch.ops import adaln

        D = H * hd
        x = _randn(g, (B * S, D), 2.0, 0.3)
        w, b = _randn(g, (D,), 0.3, 1.0, torch.float32), _randn(g, (D,), 0.5, dtype=torch.float32)
        return {"kernel": lambda: adaln.layer_norm(x, w, b, out_dtype),
                "plain": lambda: adaln.layer_norm_reference(x, w, b, out_dtype),
                "library": None,
                "check": lambda got, _: checks.ln_errors(got, x, w, b, out_dtype),
                **bound(B * S * D * (2 + out_dtype.itemsize) + 2 * D * 4, 0)}

    return calls


def epilogue_calls(g, B, S, H, hd, Fd) -> dict:
    """The FFN's GEMM pair with its tail in the cuBLASLt epilogues (linear1
    with bias and ReLU, linear2 with bias and the residual) beside the eager
    chain it replaces (F.linear, the ReLU, F.linear, the residual add): read
    the normalised input, the residual and both weights once, write out;
    two products.  Held to the float32 sum of linear2 over the eager
    chain's hidden, which linear1's epilogue matches bit for bit where
    cuBLASLt runs the same algorithm for both (`tests/test_torch_cuda.py`
    holds each epilogue alone)."""
    from layoutdm_tpu_torch.ops.gemm_epilogue import linear_relu, linear_residual

    D = H * hd
    h0, x = _randn(g, (B, S, D)), _randn(g, (B, S, D), 0.5)
    w1, b1 = _randn(g, (Fd, D), D ** -0.5), _randn(g, (Fd,), 0.1)
    w2, b2 = _randn(g, (D, Fd), Fd ** -0.5), _randn(g, (D,), 0.1)

    def plain():
        h = F.relu(F.linear(h0, w1, b1))
        return F.linear(h.float(), w2.float(), b2.float()) + x.float()

    M = B * S
    return {"kernel": lambda: linear_residual(linear_relu(h0, w1, b1), w2, b2, x),
            "plain": plain,
            "library": lambda: x + F.linear(F.relu(F.linear(h0, w1, b1)), w2, b2),
            "check": checks.residual_epilogue_errors,
            **bound(3 * M * D * 2 + 2 * D * Fd * 2 + (Fd + D) * 2, 4 * M * D * Fd)}


def decode_attention_calls(g, B, n, H, hd, call) -> dict:
    """The cached decode's attention beside SDPA on the same views (timed
    only, it writes no cache): read q and the keys and values of n
    positions (the self call: n - 1 cached, this step's rows from the
    projection, written into the caches; the cross call: in place in the
    packed projection), write the output; q·kᵀ and p·v."""
    from layoutdm_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_reference,
    )

    D = H * hd
    q, k, v = _randn(g, (B, 1, 3, H, hd)).unbind(2)
    if call == "self":
        keys, values = (_randn(g, (B, 126, H, hd)) for _ in range(2))
        new, rows = (k, v), 2 * B * (n - 1) + 4 * B  # cached rows; new rows read, written
    else:
        keys, values = _randn(g, (B, n, 2, H, hd)).unbind(2)
        new, rows = None, 2 * B * n
    qs, ks, vs = (t.transpose(1, 2) for t in (q, keys[:, :n], values[:, :n]))
    return {"kernel": lambda: decode_attention(q, keys, values, n, new),
            "plain": lambda: decode_attention_reference(q, keys, values, n, new),
            "library": lambda: F.scaled_dot_product_attention(qs, ks, vs),
            "check": checks.attention_errors,
            **bound((rows + 2 * B) * D * 2, 4 * B * n * D)}


# every hand-written kernel: its name (the kernels line's), its source, the
# JAX function it replaces, its calls and the shapes it is timed at; then
# the FFN's GEMM pair through the cuBLASLt epilogues' shim
KERNEL_TABLE = (
    ("attention_qkv", "layoutdm_tpu_torch/csrc/attention_qkv.cu",
     "layoutdm_tpu/ops/attention.py:216", k1_calls, TIMED_SHAPES + ZOO_SHAPES),
    ("attention_qkv_bwd", "layoutdm_tpu_torch/csrc/attention_qkv_bwd.cu",
     "layoutdm_tpu/ops/attention.py:465", k2_calls, TIMED_SHAPES),
    ("ln_ffn_residual", "layoutdm_tpu_torch/csrc/ffn.cu", "layoutdm_tpu/ops/ffn.py:81",
     k3_calls, TIMED_SHAPES + ZOO_SHAPES + (MASKGIT_FFN_SHAPE,)),
    ("attention_block", "layoutdm_tpu_torch/csrc/attention_block.cu",
     "layoutdm_tpu/ops/attention.py:142", k4_calls, TIMED_SHAPES + ZOO_SHAPES),
    ("attention_blockdiag", "layoutdm_tpu_torch/csrc/attention_blockdiag.cu",
     "layoutdm_tpu/ops/attention_blockdiag.py:128", k5_calls, TIMED_SHAPES),
    ("attention_qkv_smajor", "layoutdm_tpu_torch/csrc/attention_smajor.cu",
     "layoutdm_tpu/ops/attention.py:333", k6_calls, TIMED_SHAPES),
    # no pallas_call: XLA fused the JAX AdaLayerNorm's ops on the TPU
    ("ada_layer_norm", "layoutdm_tpu_torch/csrc/adaln.cu",
     "none (layoutdm_tpu/models/nn.py:124 AdaLayerNorm, fused by XLA)", adaln_calls,
     TIMED_SHAPES),
    ("layer_norm", "layoutdm_tpu_torch/csrc/adaln.cu",
     "none (flax nn.LayerNorm in layoutdm_tpu/models/nn.py, fused by XLA)",
     ln_calls(torch.bfloat16), TIMED_SHAPES),
    ("layer_norm_f32_out", "layoutdm_tpu_torch/csrc/adaln.cu",
     "none (flax nn.LayerNorm in layoutdm_tpu/models/nn.py, fused by XLA)",
     ln_calls(torch.float32), TIMED_SHAPES),
    # no pallas_call: XLA fused the Block's ReLU and residual add into its Dense layers
    ("ffn_gemm_epilogues", "layoutdm_tpu_torch/csrc/gemm_epilogue.cu",
     "none (layoutdm_tpu/models/nn.py Block's FFN, fused by XLA)", epilogue_calls,
     TIMED_SHAPES[:1]),
    # no pallas_call: XLA compiled the JAX cached decode's einsums
    ("decode_attention", "layoutdm_tpu_torch/csrc/decode_attention.cu",
     "none (layoutdm_tpu/models/nn.py SelfAttention._decode_step, CrossAttention; XLA)",
     decode_attention_calls, DECODE_SHAPES),
)


def phase_kernels() -> dict:
    """Every entry of `KERNEL_TABLE` at each of its shapes: the kernel's
    output held to its plain version's by its check (it raises outside the
    tolerance), then the kernel, its plain version and the library call
    timed by CUDA events (`cuda_ms`: the median of 25 calls, the wrapper's
    host time included), the kernel's max abs difference from its plain
    version, the bound and the share of it the kernel reaches.  One line a
    kernel."""
    g = torch.Generator().manual_seed(12)
    times = {}
    for name, source, _, calls, shapes in KERNEL_TABLE:
        times[name] = {}
        for shape, *dims in shapes:
            c = calls(g, *dims)
            kernel, plain, library = c.pop("kernel"), c.pop("plain"), c.pop("library")
            err, *_, ok = c.pop("check")(kernel(), plain())
            if not ok:
                raise AssertionError(f"{name} at {shape}: max abs err {err}, outside tolerance")
            t = times[name][shape] = {
                "kernel_ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                "library_ms": cuda_ms(library) if library else None,
                "library_kernels": device_kernels(library) if library else None,
                "max_abs_err": err, **c}
            t["bound_share"] = t["bound_ms"] / t["kernel_ms"]
            del c, kernel, plain, library
            torch.cuda.empty_cache()
        emit({"phase": "kernels", "name": name, "source": source, "times": times[name]})
    return {"phase": "kernels", "times": times}


def launch_counts() -> dict:
    """The kernel wrappers' launch counters (``LN``: the LayerNorm kernel's
    affine mode; ``decode``: the cached decode's attention)."""
    from layoutdm_tpu_torch.ops import adaln, attention, attention_blockdiag, decode_attention, ffn

    return {"K1": attention.LAUNCHES, "K2": attention.LAUNCHES_BWD,
            "K3": ffn.LAUNCHES_FFN, "K4": attention.LAUNCHES_BLOCK,
            "K5": attention_blockdiag.LAUNCHES_BLOCKDIAG, "K6": attention.LAUNCHES_SMAJOR,
            "adaLN": adaln.LAUNCHES_ADALN, "LN": adaln.LAUNCHES_LN,
            "decode": decode_attention.LAUNCHES_DECODE_ATTN}


def reset_launches() -> None:
    from layoutdm_tpu_torch.ops import adaln, attention, attention_blockdiag, decode_attention, ffn

    attention.LAUNCHES = attention.LAUNCHES_BWD = attention.LAUNCHES_BLOCK = 0
    attention.LAUNCHES_LONG = 0
    attention.LAUNCHES_SMAJOR = ffn.LAUNCHES_FFN = attention_blockdiag.LAUNCHES_BLOCKDIAG = 0
    adaln.LAUNCHES_ADALN = adaln.LAUNCHES_LN = 0
    decode_attention.LAUNCHES_DECODE_ATTN = 0


def decode_launches(model) -> int:
    """Decode attention kernel launches of one cached chain of ``model``
    (the autoregressive LayoutTransformer or BART): a layer's
    self-attention, and BART's cross-attention, once a generated token, on
    a CUDA device where the kernel takes the decoder's heads, length and
    dtype, else 0."""
    from layoutdm_tpu_torch.ops.decode_attention import can_use_decode_attention

    net = model.net
    enc_dec = hasattr(net, "decoder")
    attn = net.dec0.self_attn if enc_dec else net.backbone.layers[0].attn
    if model.device.type != "cuda" or not can_use_decode_attention(
            attn.nhead, attn.head_dim, net.max_token_length, net.dtype):
        return 0
    return (1 + enc_dec) * model.backbone_cfg.num_layers * model.gen_len


def adaln_blocks(model) -> int:
    """Blocks of ``model``'s denoiser whose norm1 launches the adaLN kernel
    once a forward without autograd: an `AdaLayerNorm` at a width and
    dtype the kernel takes."""
    from layoutdm_tpu_torch.models.nn import AdaLayerNorm, Block
    from layoutdm_tpu_torch.ops.adaln import can_use_fused_adaln

    return sum(isinstance(m, Block) and isinstance(m.norm1, AdaLayerNorm)
               and can_use_fused_adaln(m.linear1.in_features, m.dtype)
               for m in model.net.modules())


def ln_norms(model) -> int:
    """Affine LayerNorm kernel launches of one forward without autograd of
    ``model``'s single-stack denoiser: each Block's plain norm1 and its
    norm2 (but where K3 takes it), and the head's norm, at widths and
    dtypes the kernel takes."""
    from layoutdm_tpu_torch.models.nn import Block, CategoricalAggregatedTransformer
    from layoutdm_tpu_torch.ops.adaln import can_use_fused_ln

    net, n = model.net, 0
    for m in net.modules():
        if isinstance(m, Block) and can_use_fused_ln(m.linear1.in_features, m.dtype, m.dtype):
            n += isinstance(m.norm1, torch.nn.LayerNorm) + (not m.fused_ffn)
    head = net.head_norm if hasattr(net, "head_norm") else net.norm
    # the aggregated model's head reads the float32 expansion of the elements
    head_in = torch.float32 if isinstance(net, CategoricalAggregatedTransformer) else net.dtype
    return n + can_use_fused_ln(head.normalized_shape[0], head_in, torch.float32)


def ln_launches(path: str, layers: int, forwards: int) -> int:
    """Affine LayerNorm kernel launches of ``forwards`` LayoutDM denoiser
    forwards on ``path``: each layer's norm2 (K3 takes it on the fused
    path) and the head's norm."""
    return ((path != "fused") * layers + 1) * forwards


def check_path_launches(what: str, path: str, per_kernel: int, adaln=None, *, ln,
                        decode: int = 0) -> dict:
    """Inference launches since the last reset: ``per_kernel`` for each
    kernel of ``path``, ``adaln`` adaLN launches (by default
    ``per_kernel``: a LayoutDM denoiser, whose every layer's norm1 takes
    the kernel), ``ln`` affine LayerNorm launches (None: not held, for a
    model whose forwards `ln_norms` does not count), ``decode`` launches of
    the cached decode's attention (`decode_launches`), none of the other
    forward kernels."""
    got = {k: v for k, v in launch_counts().items() if k != "K2"}
    want = {k: per_kernel if k in DENOISER_PATHS[path][1] else 0 for k in got}
    want["adaLN"] = per_kernel if adaln is None else adaln
    want["LN"] = got["LN"] if ln is None else ln
    want["decode"] = decode
    if got != want or per_kernel == 0:
        raise AssertionError(f"{what}: launches {got} != {want}")
    return got


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
    from layoutdm_tpu_torch.bench.common import random_layouts

    return random_layouts(rs, B, cfg.dataset.max_seq_length, cfg.dataset.num_categories)


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


def phase_train(device="cuda", cfg16=None, batch=1024, steps=10,
                runs=3, plain_steps=5, overfit_batch=256, overfit_steps=20,
                profile_steps_n=2, smi="") -> dict:
    from layoutdm_tpu_torch.bench.common import spread
    from layoutdm_tpu_torch.bench.headline import train_rates
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
    # (a) bfloat16 steps at B=batch, kernels, then the plain versions
    cfg16 = cfg16 or flagship_config("bfloat16")
    tok = build_tokenizer(cfg16)
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
    timed = train_rates(state, batches, gen, batch, steps, runs, device)  # losses finite
    launches, launches_bwd = attention.LAUNCHES, attention.LAUNCHES_BWD
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    layers = model.backbone_cfg.num_layers
    backward_steps = steps * (runs + 1)  # the warm-up run too
    if launches_bwd != layers * backward_steps or launches != launches_bwd:
        raise AssertionError(
            f"train launches K1 {launches} / K2 {launches_bwd} != "
            f"num_layers x steps = {layers * backward_steps}"
        )
    ms_per_step = 1e3 * batch / timed["value"]
    profile = profile_steps(run, profile_steps_n)
    plain_attention(run, 1)
    t0 = time.perf_counter()
    plain_attention(run, plain_steps)
    plain_sec = time.perf_counter() - t0

    # (b) the loss of one fixed batch falls when the model trains on it
    fixed = model.preprocess(random_layouts(rs, overfit_batch, cfg16))
    probe = lambda: eval_loss(model, model.init_state(), fixed, cuda_gen(11)).item()
    before = probe()
    fit = [train_step(state, fixed, gen)["loss"].item() for _ in range(overfit_steps)]
    after = probe()
    if not (np.isfinite(after) and after < before):
        raise AssertionError(f"fixed-batch loss did not fall: {before} -> {after}")

    out = {
        "phase": "train",
        "batch": batch,
        "dtype": "bfloat16",
        "steps_a_run": steps,
        "samples_per_s": timed["value"],
        "runs": timed["runs"],
        "spread": spread(timed["runs"]),
        "ms_per_step": ms_per_step,
        "plain_samples_per_s": batch * plain_steps / plain_sec,
        "plain_ms_per_step": 1e3 * plain_sec / plain_steps,
        "peak_mem_gib": peak_gib,
        "profile": profile,
        "idle_share": 1.0 - profile["kernel_ms_per_step"] / ms_per_step,
        "launches": launches,
        "launches_bwd": launches_bwd,
        "backward_steps": backward_steps,
        "train_losses": timed["losses"],
        "overfit": {"batch": overfit_batch, "steps": overfit_steps,
                    "eval_loss_before": before, "eval_loss_after": after,
                    "train_loss_first": fit[0], "train_loss_last": fit[-1]},
        "nvidia_smi": smi,
    }
    emit(out)
    return out


# the baseline zoo of the zoo phase: its experiments, and the decode steps of
# the iterative ones (BLT decodes in three attribute groups: 9, not 10);
# VQDiffusion runs its trained T
ZOO_FAMILIES = ("maskgit", "blt", "ruite", "autoreg", "vqdiffusion", "bart", "diffusionlm",
                "bitdiffusion", "aggregated")
ZOO_STEPS = {"maskgit": 10, "blt": 9}
# families whose reverse chain runs the mask-free denoiser once a step (K1
# launched layers x steps); BART's encoder runs once a decode (layers x 1)
CHAIN_FAMILIES = ("vqdiffusion", "diffusionlm", "bitdiffusion", "aggregated")
CONTINUOUS = ("diffusionlm", "bitdiffusion")
# K1 launches a layer and train step where training runs the kernels
# (dropout 0.0, no mask): one forward, and BitDiffusion's self-condition
# pass; K2 one a layer and step
TRAIN_K1 = {"vqdiffusion": 1, "aggregated": 1, "diffusionlm": 1, "bitdiffusion": 2}
# logits of a model against the same weights through a reference state dict
# written and imported: the same weights on the same kernels
ZOO_IMPORT_TOL = 1e-6


def zoo_config(experiment: str, dtype: str):
    """A zoo experiment on Rico25 (25 elements) at the widths of its
    overlay: the zoo at the `BackboneConfig` defaults (d_model 512, 8 heads,
    FFN 2048, 4 layers, dropout 0.1; BART shrinks them to 336 / 8 / 1344),
    VQDiffusion, DiffusionLM and BitDiffusion at the flagship's shrunk
    464 / 8 / 1856, and ``aggregated`` (LayoutDM with
    ``transformer_type=aggregated``) at 432 / 8 / 1728; linear box
    quantization, as `flagship_config`."""
    from layoutdm_tpu_torch.configs import build_train_config

    over = ["data.bbox_quantization=linear", f"model.dtype={dtype}"]
    if experiment == "aggregated":
        experiment = "layoutdm"
        over.append("model.transformer_type=aggregated")
    return build_train_config(experiment, "rico25", over)


def zoo_layouts(rs: np.random.RandomState, B: int, cfg) -> dict:
    """`random_layouts` through the experiment's loader transforms (RUITE's
    box noise among them)."""
    from layoutdm_tpu_torch.data.transforms import compose_transform

    return compose_transform(list(cfg.data.transforms))(rs, random_layouts(rs, B, cfg))


def check_decoded(what: str, out: dict, B: int, cfg) -> int:
    """Decoded layouts of the config's shape: finite boxes in [0, 1] and
    labels in range wherever an element is, and at least one element;
    returns the element count."""
    S, C = cfg.dataset.max_seq_length, cfg.dataset.num_categories
    bbox, label, mask = out["bbox"], out["label"], out["mask"]
    if not (bbox.shape == (B, S, 4) and label.shape == (B, S) and mask.shape == (B, S)):
        raise AssertionError(f"{what}: shapes {bbox.shape} {label.shape} {mask.shape}")
    b, lab = bbox[mask], label[mask]
    if not (torch.isfinite(b).all() and (b >= 0).all() and (b <= 1).all()):
        raise AssertionError(f"{what}: boxes outside [0, 1]")
    if not ((lab >= 0).all() and (lab < C).all()):
        raise AssertionError(f"{what}: labels outside [0, {C})")
    n = int(mask.sum())
    if n == 0:
        raise AssertionError(f"{what}: no element in {B} layouts")
    return n


def _no_launches(what: str, ln: bool = True, decode: int = 0) -> dict:
    """Masked attention never reaches a kernel: every count is 0 (the
    LayerNorms' affine mode too, but where ``ln`` is False: a masked
    forward without autograd takes it), but ``decode`` launches of the
    cached decode's attention (`decode_launches`)."""
    got = launch_counts()
    if got["decode"] != decode or any(v for k, v in got.items()
                                      if k != "decode" and (ln or k != "LN")):
        raise AssertionError(f"{what}: kernels launched on masked calls: {got}, "
                             f"decode {decode} wanted")
    return got


def family_forward(family: str, model, rs: np.random.RandomState, n: int = 8):
    """``f(net)`` -> the family's denoiser outputs on fixed random inputs:
    BART's encoder memory, then its logits; a continuous model's x0
    prediction at random log-SNRs; a token model's logits (at t = 7 for
    the diffusion models).  The first output's forward runs the encoder's
    kernels once a layer."""
    dev = model.device
    if family in CONTINUOUS:
        x = torch.as_tensor(rs.randn(n, model.seq_len, model.num_channel).astype(np.float32),
                            device=dev)
        t = torch.as_tensor(rs.uniform(-5, 5, n).astype(np.float32), device=dev)
        return lambda net: (net(x, t),)
    ids = torch.as_tensor(rs.randint(0, model.num_classes, (n, model.seq_len)), device=dev)
    if family == "bart":
        return lambda net: (net(ids, None), net(ids, ids[:, :-1]))
    t = (torch.full((n,), min(7, model.q.num_timesteps - 1), device=dev)
         if family in CHAIN_FAMILIES else None)
    return lambda net: (net(ids, t),)


def family_reference_roundtrip(family: str, model, state, work_dir: str) -> dict:
    """The model's weights written with ``torch.save`` under the reference's
    key names and read back through the port's converter; returns the
    imported state dict."""
    from layoutdm_tpu_torch.utils.torch_port import (
        continuous_to_reference_state_dict,
        convert_categorical_encdec_transformer,
        convert_categorical_transformer,
        convert_continuous_transformer,
        encdec_to_reference_state_dict,
        import_layoutdm_checkpoint,
        load_torch_state_dict,
        to_reference_state_dict,
    )

    bb = model.backbone_cfg
    layers, tt, sd = bb.num_layers, bb.timestep_type, model.net.state_dict()
    path = os.path.join(work_dir, f"{family}_best_model.pt")
    if family == "bart":
        torch.save(encdec_to_reference_state_dict(sd, layers, bb.d_model, "model.module."), path)
        return convert_categorical_encdec_transformer(load_torch_state_dict(path), layers,
                                                      bb.d_model, "model.module.")
    if family in CONTINUOUS:
        prefix = "model.module.transformer."
        torch.save(continuous_to_reference_state_dict(sd, layers, tt, prefix), path)
        return convert_continuous_transformer(load_torch_state_dict(path), layers, tt, prefix)
    if family == "vqdiffusion":
        ref = to_reference_state_dict(sd, layers, tt, "model.module.transformer.")
        ref["model.module.Lt_history"] = state.lt_state.history.cpu()
        ref["model.module.Lt_count"] = state.lt_state.count.cpu()
        torch.save({"state_dict": ref}, path)
        imported, lt = import_layoutdm_checkpoint(path, layers, tt)
        if not torch.equal(lt.count, state.lt_state.count.cpu()):
            raise AssertionError("vqdiffusion: imported Lt counts differ")
        return imported
    torch.save(to_reference_state_dict(sd, layers, tt, "model.module."), path)
    return convert_categorical_transformer(load_torch_state_dict(path), layers, tt,
                                           "model.module.")


def phase_zoo(work_dir: str, device="cuda", batch=256, warmup=2, steps=5, rows=4,
              cfgs=None, smi="") -> dict:
    """Every family besides the flagship on the card: MaskGIT, BLT, RUITE
    and the autoregressive LayoutTransformer at the `BackboneConfig`
    defaults, VQDiffusion, DiffusionLM and BitDiffusion at 464 / 8 / 1856,
    BART at 336 / 8 / 1344 and the aggregated LayoutDM at 432 / 8 / 1728,
    Rico25 shapes, bfloat16, random weights from a seed.  For each family:
    ``warmup`` + ``steps`` train steps at ``batch`` (finite losses;
    samples/s; K1 and K2 launched layers x steps where training is
    mask-free at dropout 0), sampling at ``batch`` (MaskGIT T=10, BLT T=9,
    RUITE one refinement pass, the autoregressive model and BART with the
    KV cache, the diffusion families T=100 on the default path with K1
    launched layers x steps, BART's encoder layers x 1; valid layouts;
    layouts/s; DiffusionLM and BitDiffusion inpaint the partial task and
    must give back its held tokens), and its weights written under the
    reference's key names with ``torch.save`` and imported through its
    converter (all but the aggregated LayoutDM, which has none; every
    parameter assigned, no key left over; logits within ZOO_IMPORT_TOL).
    Masked attention (the zoo, BART's teacher-forced decoder) launches no
    kernel; the cached steps of the autoregressive model and BART launch
    the decode attention kernel (`decode_launches`).  Then,
    in float32, the cached decodes of the autoregressive model and BART
    against their recompute decodes on ``rows`` rows; MaskGIT sampled under
    ``fused_ffn`` (K3 launched layers x steps); BART, DiffusionLM,
    BitDiffusion and the aggregated LayoutDM on the fused, V2 and S-major
    paths against the default path (`zoo_paths`).  ``cfgs`` maps a family
    to a config (small ones on the CPU; ``autoreg32`` / ``bart32`` for the
    float32 decodes)."""
    from layoutdm_tpu_torch.configs import SamplingConfig
    from layoutdm_tpu_torch.factory import build_model, build_tokenizer
    from layoutdm_tpu_torch.tasks import get_cond, to_sampler_cond
    from layoutdm_tpu_torch.train.step import init_train_state, make_optimizer, train_step

    cfgs = cfgs or {}
    rs = np.random.RandomState(30)
    out = {"phase": "zoo", "batch": batch, "nvidia_smi": smi, "families": {}}

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    for i, family in enumerate(ZOO_FAMILIES):
        cfg = cfgs.get(family) or zoo_config(family, "bfloat16")
        tok = build_tokenizer(cfg)
        model = build_model(cfg, tok, device, generator=torch.Generator().manual_seed(40 + i),
                            **path_switches("default"))
        bb, layers = model.backbone_cfg, model.backbone_cfg.num_layers
        res = {"dtype": cfg.model.dtype, "d_model": bb.d_model, "nhead": bb.nhead,
               "dim_feedforward": bb.dim_feedforward, "num_layers": layers,
               "dropout": bb.dropout, "tokens": model.seq_len, "vocab": model.num_classes}
        gen = torch.Generator(device=device).manual_seed(50 + i)

        # 1. training
        state = init_train_state(
            model, make_optimizer(model.net, cfg.optimizer.lr, cfg.training.weight_decay,
                                  tuple(cfg.optimizer.betas)), cfg.training.grad_norm_clip)
        batches = [model.preprocess(zoo_layouts(rs, batch, cfg), gen) for _ in range(2)]
        reset_launches()
        for k in range(warmup):
            train_step(state, batches[k % 2], gen)
        sync()
        t0 = time.perf_counter()
        metrics = [train_step(state, batches[k % 2], gen) for k in range(steps)]
        sync()
        sec = time.perf_counter() - t0
        losses = [m["loss"].item() for m in metrics]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{family}: non-finite train losses {losses}")
        if family in TRAIN_K1:  # dropout 0.0, no mask: K1 forward, K2 backward
            got = launch_counts()
            n = layers * (warmup + steps)
            if not (got["K1"] == TRAIN_K1[family] * n and got["K2"] == n):
                raise AssertionError(f"{family} train launches {got}, K1 = "
                                     f"{TRAIN_K1[family] * n}, K2 = {n} wanted")
            train_launches = got
        else:
            train_launches = _no_launches(f"{family} train")
        res["train"] = {"samples_per_s": batch * steps / sec, "ms_per_step": 1e3 * sec / steps,
                        "losses": losses, "launches": train_launches}

        # 2. sampling
        T = ZOO_STEPS.get(family)
        sampling = SamplingConfig(name="random", num_timesteps=T)
        if family in ("vqdiffusion", "aggregated"):
            run = lambda: model.sample(torch.arange(batch, dtype=torch.int64), batch)  # noqa: E731
        elif family in CONTINUOUS:
            # inpainting (the partial task): whole elements held, so the
            # decode must give back their tokens, rounded through the codec
            lay = zoo_layouts(rs, batch, cfg)
            cond = to_sampler_cond(
                get_cond(lay, tok, "partial", model_type=family,
                         generator=torch.Generator().manual_seed(0)), tok, sampling).to(device)
            run = lambda: model.sample_ids(gen, batch, cond=cond)  # noqa: E731
        elif family == "ruite":
            lay = zoo_layouts(rs, batch, cfg)
            lay["bbox"] = lay.get("bbox_orig", lay["bbox"])
            cond = to_sampler_cond(
                get_cond(lay, tok, "refinement", model_type=family,
                         generator=torch.Generator().manual_seed(0)), tok, sampling)
            run = lambda: model.sample(gen, batch, cond=cond, sampling=sampling)  # noqa: E731
        else:
            run = lambda: model.sample(gen, batch, sampling=sampling,  # noqa: E731
                                       state=state.lt_state)
        model.net.eval()
        run()  # warm-up (and the kernels' first launches)
        sync()
        reset_launches()
        t0 = time.perf_counter()
        layouts = run()
        sync()
        sec = time.perf_counter() - t0
        if family in CHAIN_FAMILIES:
            T = model.q.num_timesteps if hasattr(model, "q") else model.num_timesteps
            sample_launches = check_path_launches(f"{family} chain", "default", layers * T,
                                                  adaln=adaln_blocks(model) * T,
                                                  ln=ln_norms(model) * T)
        elif family == "bart":  # the encoder once; each cached step the decode kernel
            sample_launches = check_path_launches("bart chain", "default", layers, adaln=0,
                                                  ln=None, decode=decode_launches(model))
        else:  # the autoregressive model's cached steps take the decode kernel
            sample_launches = _no_launches(
                f"{family} sampling", ln=False,
                decode=decode_launches(model) if family == "autoreg" else 0)
        if family in CONTINUOUS:
            ids, layouts = layouts, model.tokenizer.decode(layouts)
            held = cond.strong_mask
            kept = model.con2dis(model.dis2con(cond.seq.long())[0])
            if not torch.equal(ids[held], kept[held]):
                raise AssertionError(f"{family} inpainting: {int((ids != kept)[held].sum())} "
                                     f"of {int(held.sum())} held tokens not given back")
        elements = check_decoded(f"{family} sampling", layouts, batch, cfg)
        res["sample"] = {"steps": T or (model.gen_len if family in ("autoreg", "bart") else 1),
                         "seconds": sec, "layouts_per_s": batch / sec, "elements": elements,
                         "launches": sample_launches}
        if family in CONTINUOUS:
            res["sample"]["task"] = "partial"

        # 3. MaskGIT again under fused_ffn: K3 on the FFN of every step
        if family == "maskgit":
            fused = build_model(cfg, tok, device, **dict(path_switches("default"), fused_ffn=True))
            fused.net.load_state_dict(model.net.state_dict())
            reset_launches()
            t0 = time.perf_counter()
            layouts = fused.sample(gen, batch, sampling=sampling, state=state.lt_state)
            sync()
            sec = time.perf_counter() - t0
            k3_launches = launch_counts()
            want = {k: layers * T if k == "K3" else 0 for k in k3_launches}
            want["LN"] = ln_norms(fused) * T  # norm1 and the head: K3 takes norm2
            if k3_launches != want:
                raise AssertionError(f"maskgit fused_ffn launches {k3_launches} != {want}")
            res["fused_ffn"] = {
                "sample_seconds": sec, "layouts_per_s": batch / sec,
                "elements": check_decoded("maskgit fused_ffn", layouts, batch, cfg),
                "launches": k3_launches,
            }
            del fused

        # 4. the weights under the reference's key names, written and
        # imported (no reference converter covers the aggregated denoiser,
        # in the JAX package either)
        if family != "aggregated":
            sd = family_reference_roundtrip(family, model, state, work_dir)
            other = build_model(cfg, tok, device, **path_switches("default"))
            other.net.load_state_dict(sd)  # strict: every parameter, no key left over
            forward = family_forward(family, model, rs)
            with torch.inference_mode():
                got, want = forward(other.net), forward(model.net)
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            if not (err <= ZOO_IMPORT_TOL and all(torch.isfinite(g).all() for g in got)):
                raise AssertionError(f"{family}: imported reference weights, logits err {err}")
            res["reference_import_max_abs_err"] = err
            del other
        out["families"][family] = res
        del model, state, batches, layouts
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    # 2b. float32: the cached decodes against the recompute decodes
    for family in ("autoreg", "bart"):
        cfg = cfgs.get(f"{family}32") or zoo_config(family, "float32")
        model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(70),
                            **path_switches("default"))
        sampling = SamplingConfig(name="random")
        a = model.sample_ids(torch.Generator(device=device).manual_seed(71), rows,
                             sampling=sampling)
        b = model.sample_ids(torch.Generator(device=device).manual_seed(71), rows,
                             sampling=sampling, use_cache=False)
        if not torch.equal(a, b):
            raise AssertionError(f"{family}: cached decode differs from recompute on "
                                 f"{int((a != b).any(dim=1).sum())} of {rows} rows")
        out[f"{family}_cached_equals_recompute_rows"] = rows
        del model
    out["paths"] = zoo_paths(device, cfgs)
    emit(out)
    return out


def zoo_paths(device="cuda", cfgs=None, batch=8) -> dict:
    """BART, DiffusionLM, BitDiffusion and the aggregated LayoutDM on the
    fused (K4 + K3), V2 (K5) and S-major (K6) paths against the default
    path (K1), float32, same weights: outputs within DENOISER_TOL, the
    path's kernels launched once a layer on the encoder's forward, no other
    forward kernel."""
    from layoutdm_tpu_torch.factory import build_model

    cfgs = cfgs or {}
    res = {}
    for k, family in enumerate(("bart", "diffusionlm", "bitdiffusion", "aggregated")):
        cfg = cfgs.get(f"{family}32") or zoo_config(family, "float32")
        default = build_model(cfg, device=device, generator=torch.Generator().manual_seed(80 + k),
                              **path_switches("default"))
        forward = family_forward(family, default, np.random.RandomState(81 + k), batch)
        layers = default.backbone_cfg.num_layers
        with torch.inference_mode():
            want = forward(default.net)
            res[family] = {}
            for path in ("fused", "attn_v2", "smajor"):
                model = build_model(cfg, device=device, **path_switches(path))
                model.net.load_state_dict(default.net.state_dict())
                reset_launches()
                got = forward(model.net)
                if family == "bart":
                    # the encoder runs twice (the memory, then the logits);
                    # under fused_ffn the decoder's full-sequence FFN takes K3
                    # (its LayerNorms' launches are not held: `ln_norms`
                    # counts single-stack denoisers)
                    launches = {k: v for k, v in launch_counts().items() if k not in ("K2", "LN")}
                    want_l = {k: 2 * layers if k in DENOISER_PATHS[path][1] else 0 for k in launches}
                    if path == "fused":
                        want_l["K3"] = 3 * layers
                    if launches != want_l:
                        raise AssertionError(f"bart {path}: launches {launches} != {want_l}")
                else:
                    launches = check_path_launches(f"{family} {path}", path, layers,
                                                   adaln=adaln_blocks(model),
                                                   ln=ln_norms(model))
                err = max((g - w).abs().max().item() for g, w in zip(got, want))
                if not (err <= DENOISER_TOL and all(torch.isfinite(g).all() for g in got)):
                    raise AssertionError(f"{family} {path}: max abs err {err} against default")
                res[family][path] = {"path": model.denoiser_path, "max_abs_err": err,
                                     "launches": launches}
                del model
        del default
    return res


def phase_train_cli(work_dir: str, device="cuda", epochs=10, overrides=()) -> dict:
    """The trainer on the synthetic dataset (2,048 layouts, 32 steps an
    epoch) into ``work_dir``/job, which the service then loads and answers
    a request from (and the sample_cli phase samples from), with its FID
    probe on the extractor the fidnet_train phase wrote under
    ``work_dir``/fid_weights: a finite ``fid_val`` every epoch, the last
    from layouts that hold at least one element each on average, and not
    all of them equal."""
    from layoutdm_tpu_torch.configs import build_train_config
    from layoutdm_tpu_torch.serve_cli import LayoutService
    from layoutdm_tpu_torch.train import loop

    cfg = build_train_config("layoutdm", "synthetic", [
        f"training.epochs={epochs}", "training.sample_plot_epoch_interval=0",
        f"job_dir={work_dir}/job", f"dataset.dir={work_dir}/datasets",
        f"fid_weight_dir={work_dir}/fid_weights", *overrides,
    ])
    probe_s, probe_elements = [], []
    probe = loop._compute_training_fid

    def timed_probe(cfg, model, *args, **kw):
        """The probe, timed, with the mean elements per layout it sampled."""
        def counted_sample(*a, **k):
            out = type(model).sample(model, *a, **k)
            probe_elements.append(out["mask"].sum(1).float().mean().item())
            return out

        model.sample = counted_sample
        t = time.perf_counter()
        try:
            return probe(cfg, model, *args, **kw)
        finally:
            probe_s.append(time.perf_counter() - t)
            del model.sample

    reset_launches()
    loop._compute_training_fid = timed_probe
    try:
        t0 = time.perf_counter()
        result = loop.train(cfg, device=device)
        sec = time.perf_counter() - t0
    finally:
        loop._compute_training_fid = probe
    launches_bwd = launch_counts()["K2"]
    if not (np.isfinite(result["best_val_loss"]) and launches_bwd > 0):
        raise AssertionError(f"trainer result {result}, K2 launches {launches_bwd}")
    with open(os.path.join(cfg.job_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    epoch_rows = [r for r in rows if "val_loss" in r]
    # the probe logs and swallows its own failures (as the JAX trainer's
    # does), so its rows are the proof that it ran
    fids = [r["fid_val"] for r in rows if "fid_val" in r]
    if not (len(fids) == len(epoch_rows) and np.isfinite(fids).all()):
        raise AssertionError(f"FID probe wrote {fids} over {len(epoch_rows)} epochs")
    # a probe of empty layouts scores one repeated feature, whatever it
    # does: the first epochs' samples may be empty, the last must not be
    if not (len(probe_elements) == len(fids) and probe_elements[-1] >= 1
            and len(set(fids)) > 1):
        raise AssertionError(f"FID probe: {probe_elements} elements per layout, "
                             f"FIDs {fids}")
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
        "epochs": len(epoch_rows),
        "val_loss": [e["val_loss"] for e in epoch_rows],
        "train_seconds": sec,
        "fid_val": fids,
        "fid_probe_seconds": probe_s,
        "fid_probe_elements_per_layout": probe_elements,
        "fid_note": "256 samples against the 256 val layouts in 256-d features: "
                    "rank-deficient covariances, FID finite but ill-conditioned",
        "launches_bwd": launches_bwd,
        "served_layouts": len(resp["layouts"]),
    }
    emit(out)
    return out


SAMPLE_TASKS = ("unconditional", "c", "cwh", "partial", "refinement", "relation")


def phase_sample_cli(work_dir: str, device="cuda", num_samples=16, num_timesteps=20,
                     path="attn_v2") -> dict:
    """The batch sampling CLI (`sample_cli.main`, as ``python -m`` runs it)
    over all six tasks on the job the train_cli phase wrote, with the
    denoiser path's switch in the environment: six pickles with the JAX
    CLI's keys, a violation rate for relation, and the path's kernel
    launched layers x chain steps (a warm-up and a timed chain per task)."""
    import pickle

    from layoutdm_tpu_torch.sample_cli import main as sample_main

    env = {"LAYOUTDM_TPU_ATTN_V2": "0", "LAYOUTDM_TPU_SMAJOR": "0",
           "LAYOUTDM_TPU_FUSED_BLOCK": "0", "LAYOUTDM_TPU_FUSED_FFN": "0"}
    env.update({f"LAYOUTDM_TPU_{k.upper()}": "1"
                for k, on in path_switches(path).items() if on})
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    results, rates = {}, {}
    reset_launches()
    try:
        t0 = time.perf_counter()
        for task in SAMPLE_TASKS:
            (pkl,) = sample_main([
                f"job_dir={work_dir}/job", f"result_dir={work_dir}/results", f"cond={task}",
                f"device={device}", f"debug_num_samples={num_samples}",
                f"num_uncond_samples={num_samples}", f"max_batch_size={num_samples}",
                f"num_timesteps={num_timesteps}",
            ])
            with open(pkl, "rb") as f:
                res = pickle.load(f)
            keys = {"results", "inputs", "train_cfg", "test_cfg", "ms_per_sample"}
            if task == "relation":
                keys.add("violation_rate")
                rates[task] = res["violation_rate"]
                if not 0.0 <= res["violation_rate"] <= 1.0:
                    raise AssertionError(f"violation rate {res['violation_rate']}")
            if set(res) != keys or len(res["results"]) != num_samples:
                raise AssertionError(f"{task} pickle: keys {sorted(res)}, "
                                     f"{len(res['results'])} layouts")
            for bbox, label in res["results"]:
                if not (bbox.shape == (len(label), 4) and np.isfinite(bbox).all()):
                    raise AssertionError(f"{task}: malformed layout {bbox.shape}")
            results[task] = res["ms_per_sample"]
        sec = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with open(f"{work_dir}/job/config.json") as f:
        layers = json.load(f)["backbone"]["num_layers"]
    forwards = len(SAMPLE_TASKS) * 2 * num_timesteps
    launches = check_path_launches("sample_cli", path, layers * forwards,
                                   ln=ln_launches(path, layers, forwards))
    out = {"phase": "sample_cli", "path": path, "tasks": list(SAMPLE_TASKS),
           "ms_per_sample": results, "violation_rate": rates["relation"],
           "num_samples": num_samples, "num_timesteps": num_timesteps,
           "launches": launches, "seconds": sec}
    emit(out)
    return out


FID_S = 25  # the synthetic dataset's max_seq_length in the train_cli job
FIDNET_TOL = 1e-4  # float32 features, card against CPU (no TF32)


def phase_fidnet_train(work_dir: str, device="cuda", iterations=500, batch=64,
                       log_every=100) -> dict:
    """The FIDNet trainer (`eval.fidnet_train.train_fidnet`): FIDNetV3 at
    full width (d_model 256, 4 heads, 4 + 4 layers) on the synthetic
    dataset at S = 25, into ``work_dir``/fid_weights, which the train_cli
    probe and the eval_cli phase score with.  The validation loss falls and
    the checkpoint exists; steps/s over the whole run (validation sweeps
    every ``log_every`` steps included)."""
    from layoutdm_tpu_torch.eval.fidnet_train import train_fidnet

    t0 = time.perf_counter()
    model, history = train_fidnet(
        "synthetic", f"{work_dir}/datasets", f"{work_dir}/fid_weights", max_seq_length=FID_S,
        batch_size=batch, iterations=iterations, log_every=log_every, device=device)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ckpt = os.path.join(work_dir, "fid_weights", f"synthetic-max{FID_S}", "model_best.pth.tar")
    losses = [v for _, v in history]
    if not (os.path.exists(ckpt) and len(losses) >= 2 and losses[-1] < losses[0]):
        raise AssertionError(f"FIDNet training: val losses {losses}, checkpoint "
                             f"{os.path.exists(ckpt)}")
    out = {"phase": "fidnet_train", "d_model": model.d_model, "max_bbox": FID_S,
           "batch": batch, "iterations": iterations, "val_loss": losses,
           "seconds": sec, "steps_per_s": iterations / sec}
    emit(out)
    return out


def phase_fidnet(work_dir: str, device="cuda", batches=(512, 4096)) -> dict:
    """FIDNetV3 features (the fidnet_train checkpoint) of the same 512
    synthetic layouts on the card and on the CPU, within FIDNET_TOL, then the
    extraction timed at each batch size on inputs already on the card:
    CUDA events, layouts/s, peak memory allocated (weights included)."""
    from layoutdm_tpu_torch.data.datasets import load_dataset
    from layoutdm_tpu_torch.eval.fidnet import load_fidnet_v3, make_feature_extractor

    data = load_dataset("synthetic", f"{work_dir}/datasets", "train", FID_S)
    weights = f"{work_dir}/fid_weights"
    n_labels = len(data.labels)
    card = make_feature_extractor(load_fidnet_v3("synthetic", n_labels, weights, FID_S,
                                                 device=device))
    host = make_feature_extractor(load_fidnet_v3("synthetic", n_labels, weights, FID_S,
                                                 device="cpu"))
    got = card(data.bbox[:512], data.label[:512], data.mask[:512]).cpu()
    want = host(data.bbox[:512], data.label[:512], data.mask[:512])
    err = (got - want).abs().max().item()
    if not (got.shape == (512, 256) and torch.isfinite(got).all() and err <= FIDNET_TOL):
        raise AssertionError(f"FIDNet features on the card: shape {tuple(got.shape)}, "
                             f"max error {err} against the CPU")
    times = {}
    for B in batches:
        reps = -(-B // len(data))
        inputs = [torch.as_tensor(np.concatenate([a] * reps)[:B], device=device)
                  for a in (data.bbox, data.label, data.mask)]
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: card(*inputs), iters=10, warmup=3)
        times[f"b{B}"] = {"ms": ms, "layouts_per_s": B / ms * 1e3,
                          "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    out = {"phase": "fidnet", "max_abs_err_vs_cpu": err, "tolerance": FIDNET_TOL,
           "times": times}
    emit(out)
    return out


EVAL_N = 4096  # layouts a pickle at size: of the order of a Rico25 test split
EVAL_DATASET = "synthetic_at_size"
TIMED_METRICS = ("compute_alignment", "compute_overlap", "compute_average_iou",
                 "compute_generative_model_scores", "compute_maximum_iou",
                 "compute_docsim", "compute_wasserstein_distance")


def timed_eval_cli(args) -> tuple:
    """``eval_cli.main(args)`` with its output captured: its scores, and its
    seconds split into feature extraction, each metric (each timed around
    its own calls) and the rest (loading, the extractor's set-up, printing)."""
    import contextlib
    import io

    from layoutdm_tpu_torch import eval_cli
    from layoutdm_tpu_torch.eval import metrics

    seconds = {}

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return call

    saved = [(eval_cli, "extract_in_batches", eval_cli.extract_in_batches)]
    saved += [(metrics, name, getattr(metrics, name)) for name in TIMED_METRICS]
    printed = io.StringIO()
    try:
        for module, name, fn in saved:
            setattr(module, name, timed(name, fn))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            scores = eval_cli.main(args)
        sec = time.perf_counter() - t0
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    extract = seconds.pop("extract_in_batches", 0.0)
    metric_s = sum(seconds.values())
    return scores, {"seconds": sec, "feature_seconds": extract,
                    "metric_seconds": metric_s, "other_seconds": sec - extract - metric_s,
                    "metric_seconds_by_call": seconds,
                    "csv": printed.getvalue().splitlines()[:2]}


def check_scores(what: str, scores: dict, empty=()) -> None:
    """Every score finite, but the Wasserstein pair of the pickles (by
    index) in ``empty``, which have no element: the JAX package leaves it
    NaN there too."""
    bad = {k: v for k, v in scores.items()
           if not all(np.isfinite(x) or (k.startswith("wdist_") and i in empty)
                      for i, x in enumerate(v))}
    if "fid" not in scores or bad:
        raise AssertionError(f"eval_cli {what}: non-finite {bad}, keys {sorted(scores)}")


def write_sized_results(work_dir: str, n: int, seed=0) -> str:
    """Six result pickles of ``n`` layouts each, scored against a dataset
    registered here whose val and test splits hold ``n`` synthetic layouts
    each.  The conditional tasks keep each test layout's labels and jitter
    its boxes, so that the max-IoU groups and DocSim pairs are those of a
    conditional sampler's output; the unconditional pickle draws layouts of
    its own.  They are not model samples: they give the scorer a result
    directory of a size its users score.  Returns the directory."""
    import pickle
    import shutil

    from layoutdm_tpu_torch.data.datasets import synthetic_layouts
    from layoutdm_tpu_torch.eval_cli import pad_layout_list
    from layoutdm_tpu_torch.registry import DATASET_LABELS, register_dataset

    register_dataset(EVAL_DATASET, DATASET_LABELS["rico5"], overwrite=True)
    proc = os.path.join(work_dir, "datasets", f"{EVAL_DATASET}-max{FID_S}", "processed")
    os.makedirs(proc, exist_ok=True)
    splits = {}
    for i, split in enumerate(("val", "test")):
        splits[split] = synthetic_layouts(n, FID_S, seed=seed + 100 + i)
        bbox, label, mask = pad_layout_list(splits[split], FID_S)
        np.savez(os.path.join(proc, f"{split}.npz"), bbox=bbox, label=label, mask=mask)
    weights = os.path.join(work_dir, "fid_weights")
    shutil.copytree(os.path.join(weights, f"synthetic-max{FID_S}"),
                    os.path.join(weights, f"{EVAL_DATASET}-max{FID_S}"), dirs_exist_ok=True)
    with open(os.path.join(work_dir, "results", "c_test_seed_0.pkl"), "rb") as f:
        train_cfg = pickle.load(f)["train_cfg"]
    train_cfg["dataset"].update(name=EVAL_DATASET, dir=os.path.join(work_dir, "datasets"))
    out_dir = os.path.join(work_dir, "results_at_size")
    os.makedirs(out_dir, exist_ok=True)
    rs = np.random.RandomState(seed)
    for task in SAMPLE_TASKS:
        if task == "unconditional":
            layouts = synthetic_layouts(n, FID_S, seed=seed + 200)
        else:
            layouts = [(np.clip(b + rs.normal(0, 0.02, b.shape), 0, 1).astype(np.float32), l)
                       for b, l in splits["test"]]
        with open(os.path.join(out_dir, f"{task}_test_seed_0.pkl"), "wb") as f:
            pickle.dump({"results": layouts, "train_cfg": train_cfg,
                         "test_cfg": {"cond": task}}, f)
    return out_dir


def phase_eval_cli(work_dir: str, device="cuda", n=EVAL_N) -> dict:
    """``eval_cli`` (its ``main``, as ``python -m`` runs it) with the
    fidnet_train extractor: over the six sample_cli pickles (16 layouts
    each, against the 256 of the synthetic test split), with
    ``--compute_real``, and over six pickles of ``n`` layouts against
    splits of ``n`` (``write_sized_results``) with ``--compute_real``
    there too.  Every score finite, but the Wasserstein pair of a pickle
    with no element (NaN in the JAX package too).  Seconds split between
    feature extraction (numpy to the card and back), each metric, and the
    rest."""
    import glob
    import pickle

    results = os.path.join(work_dir, "results")
    elements = {}
    for path in sorted(glob.glob(os.path.join(results, "*.pkl"))):
        with open(path, "rb") as f:
            layouts = pickle.load(f)["results"]
        elements[os.path.basename(path)] = float(np.mean([len(l) for _, l in layouts]))
    empty = {i for i, e in enumerate(elements.values()) if e == 0}
    sized = write_sized_results(work_dir, n)
    common = ["--fid_weight_dir", f"{work_dir}/fid_weights", "--data_dir",
              f"{work_dir}/datasets", "--max_seq_length", str(FID_S), "--device", str(device)]
    runs = {}
    for name, args, allowed in (
        ("results", [results, "--dataset", "synthetic"], empty),
        ("compute_real", [results, "--dataset", "synthetic", "--compute_real"], ()),
        ("at_size", [sized, "--dataset", EVAL_DATASET], ()),
        ("at_size_compute_real", [sized, "--dataset", EVAL_DATASET, "--compute_real"], ()),
    ):
        scores, runs[name] = timed_eval_cli(args + common)
        check_scores(name, scores, allowed)
        runs[name]["fid"] = scores["fid"]
    out = {"phase": "eval_cli", "pickles": len(runs["results"]["fid"]), "runs": runs,
           "elements_per_layout": elements, "layouts_at_size": n,
           "fid_note": "results: 16 layouts a pickle against 256-d features, FID finite "
                       f"but ill-conditioned; at_size: {n} layouts, well-conditioned"}
    emit(out)
    return out


def phase_render_cli(work_dir: str, num_samples=16) -> dict:
    """``render_cli`` on the task-c pickle: a non-blank image grid and one
    CSV row per layout."""
    from PIL import Image

    from layoutdm_tpu_torch import render_cli

    pkl = os.path.join(work_dir, "results", "c_test_seed_0.pkl")
    out_dir = os.path.join(work_dir, "render")
    t0 = time.perf_counter()
    render_cli.main([pkl, "--out_dir", out_dir, "--num_samples", str(num_samples)])
    sec = time.perf_counter() - t0
    with Image.open(os.path.join(out_dir, "generated.png")) as img:
        pixels = np.asarray(img)
    with open(os.path.join(out_dir, "scores.csv")) as f:
        rows = f.read().splitlines()
    if not (pixels.std() > 0 and len(rows) == num_samples + 1):
        raise AssertionError(f"render_cli: image std {pixels.std()}, {len(rows)} CSV lines")
    out = {"phase": "render_cli", "files": sorted(os.listdir(out_dir)),
           "image": list(pixels.shape), "csv_rows": len(rows) - 1, "seconds": sec}
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


RELATIONS = [{"src": "canvas", "dst": 0, "loc": "top"},
             {"src": 0, "dst": 1, "size": "larger", "loc": "bottom"},
             {"src": 1, "dst": 2, "size": "smaller"}]


def phase_serve(device="cuda", cfg=None, ladder=(25, 100), max_batch=64,
                n_latency=10, smi="", path="default", relation=False) -> dict:
    """The HTTP service on a denoiser ``path`` (default: K1 and the
    unfused FFN; fused: K4 + K3; attn_v2: K5; smajor: K6); ``relation`` adds
    relation-guided requests."""
    from layoutdm_tpu_torch.factory import build_model, build_tokenizer
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
            job_dir, max_batch_size=max_batch, timestep_ladder=ladder, device=device,
            **path_switches(path),
        )
    httpd = LayoutHTTPServer(("127.0.0.1", 0), make_handler(service))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        reset_launches()
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
        violation = None
        if relation:
            # guided by the relations on the categories alone; same seed,
            # same layouts
            req = {"task": "relation", "batch_size": 4, "seed": 11,
                   "layout": {"label": layout["label"]}, "relations": RELATIONS}
            a, b = _post(url, req), _post(url, req)
            _check_layouts(a, 4, num_labels, layout["label"])
            violation = a["violation_rate"]
            if (a["layouts"], violation) != (b["layouts"], b["violation_rate"]) or not (
                    0.0 <= violation <= 1.0):
                raise AssertionError(f"relation answers differ or rate {violation}")

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

        steps = service.steps - steps0
        launches = check_path_launches(
            f"{path} serve (num_layers x {steps} steps)", path,
            cfg.backbone.num_layers * steps,
            ln=ln_launches(path, cfg.backbone.num_layers, steps),
        )
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    out = {
        "phase": "serve" if path == "default" else f"{path}_serve",
        "path": service.model.denoiser_path,
        "requests_ok": True,
        "chain_runs": service.runs - runs0,
        "coalesced_burst_runs": burst_runs,
        "chain_steps": steps,
        "launches": launches,
        "relation_violation_rate": violation,
        "batch1_latency": latency,
        "max_batch_size": max_batch,
        "nvidia_smi": smi,
    }
    emit(out)
    return out


def phase_throughput(device="cuda", batch=1024, cfg=None, smi="", path="default",
                     runs=3) -> dict:
    """Layouts/s of the per-row-seed chain on ``path``: the bench's
    `headline.chain_rows_per_s` (one warm-up chain, ``runs`` timed), the
    last chain's layouts decoded and checked."""
    from layoutdm_tpu_torch.bench.common import spread
    from layoutdm_tpu_torch.bench.headline import chain_rows_per_s
    from layoutdm_tpu_torch.factory import build_model

    cfg = cfg or flagship_config("bfloat16")
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(4),
                        **path_switches(path))
    r = chain_rows_per_s(model, batch, runs, device, seed=0, per_row=True)
    out = model.tokenizer.decode(r["ids"])
    if not (out["bbox"].shape == (batch, cfg.dataset.max_seq_length, 4)
            and torch.isfinite(out["bbox"]).all()):
        raise AssertionError("throughput run produced malformed layouts")
    res = {
        "phase": "throughput" if path == "default" else f"{path}_throughput",
        "path": model.denoiser_path,
        "batch": batch,
        "num_timesteps": model.q.num_timesteps,
        "layouts_per_s": r["value"],
        "runs": r["runs"],
        "spread": spread(r["runs"]),
        "nvidia_smi": smi,
    }
    emit(res)
    return res


# the JAX package's int8 bounds (`tests/test_int8_serving.py`): the bf16
# mirror against the float32 forward, the int8 logits against the bf16 mirror
INT8_MIRROR_BF16 = {"atol": 0.15, "rtol": 0.05, "argmax": 0.98}
INT8_SOFTMAX_L1, INT8_ARGMAX = 0.25, 0.9


def phase_int8(device="cuda", batch=1024, cfg=None, check_batch=64, latency_steps=20,
               smi="") -> dict:
    """The int8 serving engine (`models.int8_serving`, the JAX package's
    ``LAYOUTDM_TPU_INT8=1``) at flagship width, random weights from a seed:
    the float32 mirror against the float32 denoiser forward (DENOISER_TOL),
    the bf16 mirror against it within the JAX bound, the served int8
    predict_start (`make_int8_predict_start`: its own calibration, its head)
    against the bf16 mirror under the same head contract (softmax L1,
    argmax agreement; the MASK lane at -70, nothing above 0); then the same
    predict_start in an unconditional
    T=100 chain at B=``batch`` on the default path and on int8 in turn
    (layouts/s, K1 launched layers x steps on int8, valid layouts), and ms
    a step at B=1 and 64 on both."""
    import copy

    from layoutdm_tpu_torch.factory import build_model, build_tokenizer
    from layoutdm_tpu_torch.models import int8_serving as i8

    cfg = cfg or flagship_config("bfloat16")
    cfg32 = copy.deepcopy(cfg)
    cfg32.model.dtype = "float32"
    tok = build_tokenizer(cfg)
    model = build_model(cfg, tok, device, generator=torch.Generator().manual_seed(12),
                        **path_switches("default"))
    m32 = build_model(cfg32, tok, device, **path_switches("default"))
    m32.net.load_state_dict(model.net.state_dict())
    bb, V, S, T = model.backbone_cfg, model.num_classes, model.seq_len, model.q.num_timesteps
    params = model.net.state_dict()
    rs = np.random.RandomState(13)
    ids = torch.as_tensor(rs.randint(0, V, (check_batch, S)), device=device)
    t = torch.as_tensor(rs.randint(0, T, check_batch), device=device)
    default_ps = model._predict_start
    int8_ps = i8.make_int8_predict_start(model)  # the object the chain below times
    with torch.inference_mode():
        want = m32.net(ids, t)
        err32 = (i8.mirror_forward(params, bb, V, ids, t, dtype=torch.float32)
                 - want).abs().max().item()
        if not (np.isfinite(err32) and err32 <= DENOISER_TOL):
            raise AssertionError(f"float32 int8 mirror against the denoiser: {err32}")
        m16 = i8.mirror_forward(params, bb, V, ids, t, dtype=torch.bfloat16)
        b = INT8_MIRROR_BF16
        bf16_excess = ((m16 - want).abs() - (b["atol"] + b["rtol"] * want.abs())).max().item()
        bf16_argmax = (m16.argmax(-1) == want.argmax(-1)).float().mean().item()
        if not (bf16_excess <= 0 and bf16_argmax > b["argmax"]):
            raise AssertionError(f"bf16 mirror: excess over the bound {bf16_excess}, "
                                 f"argmax agreement {bf16_argmax}")
        # the served predict_start (its own calibration draws, its head)
        # against the bf16 mirror under the same head contract
        got = int8_ps(ids, t).float()
        head = torch.log_softmax(m16[..., :-1].float(), -1)
        ref = torch.clamp(torch.cat([head, torch.full_like(head[..., :1], -70.0)], -1),
                          -70.0, 0.0)
        l1 = (ref.exp() - got.exp()).abs().sum(-1).mean().item()
        agree = (ref.argmax(-1) == got.argmax(-1)).float().mean().item()
        head_ok = bool(torch.isfinite(got).all() and (got[..., -1] == -70.0).all()
                       and got.max() <= 0.0)
        if not (l1 < INT8_SOFTMAX_L1 and agree > INT8_ARGMAX and head_ok):
            raise AssertionError(f"int8 predict_start: softmax L1 {l1}, argmax agreement "
                                 f"{agree}, head contract {head_ok}")
    del m32

    def chain(ps, b, steps=None):
        model._predict_start = ps
        try:
            t0 = time.perf_counter()
            out = model.sample(torch.arange(b, dtype=torch.int64), b, num_timesteps_eval=steps)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        finally:
            model._predict_start = default_ps

    for ps in (default_ps, int8_ps):  # warm-up: kernel builds, GEMM heuristics
        chain(ps, batch, 5)
    _, default_s = chain(default_ps, batch)
    reset_launches()
    out, int8_s = chain(int8_ps, batch)
    # the int8 mirror runs its own norms, not `AdaLayerNorm` or `affine_norm`
    launches = check_path_launches("int8 chain", "default", bb.num_layers * T, adaln=0, ln=0)
    elements = check_decoded("int8 chain", out, batch, cfg)
    ms_per_step = {}
    for b_ in (1, 64):
        for name, ps in (("default", default_ps), ("int8", int8_ps)):
            chain(ps, b_, latency_steps)
            ms_per_step[f"{name}_b{b_}"] = 1e3 * chain(ps, b_, latency_steps)[1] / latency_steps
    res = {
        "phase": "int8",
        "d_model": bb.d_model, "num_layers": bb.num_layers,
        "float32_mirror_max_abs_err": err32,
        "bf16_mirror_excess_over_bound": bf16_excess, "bf16_mirror_argmax": bf16_argmax,
        "int8_softmax_l1": l1, "int8_argmax_agreement": agree,
        "batch": batch, "num_timesteps": T,
        "int8_layouts_per_s": batch / int8_s, "default_layouts_per_s": batch / default_s,
        "int8_ms_per_step": 1e3 * int8_s / T,
        "default_ms_per_step": 1e3 * default_s / T,
        "ms_per_step": ms_per_step, "latency_steps": latency_steps,
        "launches": launches, "elements": elements,
        "nvidia_smi": smi,
    }
    emit(res)
    return res


# a world-1 parallel step against `train_step` (loss and history relative,
# parameters absolute): two runs of `train_step` itself differ by the
# order of the backward's float32 atomics, which Adam's normalised update
# lifts to ~5e-7 in the parameters (seen on the card); a wrong row, draw or
# reduction moves the update at the learning rate's scale (5e-4 a step)
PARALLEL_TOL = 1e-5


def phase_parallel(work_dir: str, device="cuda", cfg=None, batch=1024, steps=3,
                   timed_steps=5, trainer_overrides=(), smi="") -> dict:
    """The parallel training paths on a world-1 process group (NCCL on the
    card, one GPU a rank), without torchrun: the data-parallel step and
    the shard_map step at B=``batch``, bf16, each against `train_step` on
    the same batches and noise (K1 and K2 launched layers x steps), the
    two steps' samples/s beside `train_step`'s; then the trainer with
    ``training.num_devices=1`` into a job the service loads."""
    import torch.distributed as dist

    from layoutdm_tpu_torch.configs import build_train_config
    from layoutdm_tpu_torch.factory import build_model, build_tokenizer
    from layoutdm_tpu_torch.parallel.mesh import make_mesh
    from layoutdm_tpu_torch.serve_cli import LayoutService
    from layoutdm_tpu_torch.train import loop
    from layoutdm_tpu_torch.train.step import (
        fold_in,
        init_train_state,
        make_optimizer,
        make_train_step,
        make_train_step_shardmap,
        train_step,
    )

    cfg = cfg or flagship_config("bfloat16")
    tok = build_tokenizer(cfg)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{work_dir}/dist_store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(cfg.training.num_devices)

        def fresh():
            m = build_model(cfg, tok, device, generator=torch.Generator().manual_seed(14),
                            **path_switches("default"))
            opt = make_optimizer(m.net, cfg.optimizer.lr, cfg.training.weight_decay,
                                 tuple(cfg.optimizer.betas))
            return m, init_train_state(m, opt, cfg.training.grad_norm_clip)

        def cuda_gen(seed):
            return torch.Generator(device=device).manual_seed(seed)

        rs = np.random.RandomState(15)
        model, _ = fresh()
        batches = [model.preprocess(random_layouts(rs, batch, cfg)) for _ in range(steps)]
        layers = model.backbone_cfg.num_layers

        def trajectory(step_fn, state, gen_of):
            reset_launches()
            losses = [step_fn(state, b, gen_of(i))["loss"].item() for i, b in enumerate(batches)]
            k = launch_counts()
            if not k["K1"] == k["K2"] == layers * steps:
                raise AssertionError(f"launches K1 {k['K1']} / K2 {k['K2']} != {layers * steps}")
            return losses, state

        def against(name, got, want):
            (gl, gs), (wl, ws) = got, want
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, wl))
            want_sd = ws.model.net.state_dict()
            param_err = max((v - want_sd[k]).abs().max().item()
                            for k, v in gs.model.net.state_dict().items())
            hist_err = (gs.lt_state.history - ws.lt_state.history).abs().max().item()
            if not (loss_err <= PARALLEL_TOL and param_err <= PARALLEL_TOL
                    and hist_err <= PARALLEL_TOL * ws.lt_state.history.abs().max().item()
                    and torch.equal(gs.lt_state.count, ws.lt_state.count)):
                raise AssertionError(f"{name}: loss rel err {loss_err}, params {param_err}, "
                                     f"history {hist_err}")
            return {"loss_rel_err": loss_err, "param_max_abs_err": param_err,
                    "history_max_abs_err": hist_err, "losses": gl}

        g = cuda_gen(16)
        ref = trajectory(train_step, fresh()[1], lambda i: g)
        m, st = fresh()
        g = cuda_gen(16)
        dp = against("data-parallel step",
                     trajectory(make_train_step(m, st.optimizer, mesh), st, lambda i: g), ref)
        seeds = [100 + i for i in range(steps)]
        ref_sm = trajectory(train_step, fresh()[1],
                            lambda i: cuda_gen(fold_in(seeds[i], 0)))
        m, st = fresh()
        sm = against("shard_map step", trajectory(
            make_train_step_shardmap(m, st.optimizer, mesh), st, lambda i: seeds[i]), ref_sm)

        def samples_per_s(step_fn, state, arg):
            step_fn(state, batches[0], arg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(timed_steps):
                step_fn(state, batches[i % steps], arg)
            torch.cuda.synchronize()
            return batch * timed_steps / (time.perf_counter() - t0)

        m, st = fresh()
        rate = {"train_step": samples_per_s(train_step, st, cuda_gen(17))}
        m, st = fresh()
        rate["data_parallel"] = samples_per_s(make_train_step(m, st.optimizer, mesh), st,
                                              cuda_gen(17))
        m, st = fresh()
        rate["shard_map"] = samples_per_s(make_train_step_shardmap(m, st.optimizer, mesh),
                                          st, 17)
        del m, st, model

        # the trainer over the mesh (num_devices=1) into a job the service loads
        tcfg = build_train_config("layoutdm", "synthetic", [
            "debug=true", "training.num_devices=1", "training.sample_plot_epoch_interval=0",
            f"job_dir={work_dir}/dp_job", f"dataset.dir={work_dir}/datasets",
            *trainer_overrides])
        reset_launches()
        result = loop.train(tcfg, device=device)
        if not (np.isfinite(result["best_val_loss"]) and launch_counts()["K2"] > 0):
            raise AssertionError(f"trainer over the mesh: {result}")
        service = LayoutService(tcfg.job_dir, max_batch_size=8, warm_tasks=(), device=device)
        try:
            resp = service.generate("unconditional", 2, 3, None)
        finally:
            service.close()
        _check_layouts(resp, 2, tcfg.dataset.num_categories)
    finally:
        dist.destroy_process_group()
    out = {"phase": "parallel", "backend": backend, "world_size": 1, "batch": batch,
           "dtype": cfg.model.dtype, "steps": steps, "data_parallel": dp, "shard_map": sm,
           "samples_per_s": rate, "timed_steps": timed_steps,
           "trainer_best_val_loss": result["best_val_loss"],
           "served_layouts": len(resp["layouts"]), "nvidia_smi": smi}
    emit(out)
    return out


def phase_dryrun(device="cuda", smi="") -> dict:
    """The entry points of `graft_entry` at flagship width,
    float32: `entry`'s forward (logits (2, 125, 155), K1 launched once a
    layer), then `dryrun_multichip(1)`, one spawned rank on NCCL (on gloo
    when rehearsed on the CPU): its data-parallel loss equal to
    `train_step`'s, the gathered chain token-identical to one process's,
    the gathered features within 1e-4 of one process's, and the rank's K1
    / K2 launches: layers a train step (data parallel, `train_step`,
    shard_map) and layers x T_eval a chain (its own rows, one process's)."""
    from layoutdm_tpu_torch import graft_entry

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    fn, (seq, t) = graft_entry.entry(device)
    layers = flagship_config("float32").backbone.num_layers
    reset_launches()
    logits = fn(seq, t)
    entry_launches = (check_path_launches("entry", "default", layers,
                                          ln=ln_launches("default", layers, 1))
                      if on_card else {})
    if not (logits.shape == (2, 125, 155) and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"entry logits {tuple(logits.shape)}")
    entry_s = time.perf_counter() - t0
    del fn, logits
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out = graft_entry.dryrun_multichip(1, device)
    dryrun_s = time.perf_counter() - t0
    losses, tol = out["losses"], graft_entry.LOSS_TOL
    if not (out["backend"] == ("nccl" if on_card else "gloo") and out["world_size"] == 1
            and abs(losses["data_parallel"] - losses["train_step"])
            <= tol["atol"] + tol["rtol"] * abs(losses["train_step"])
            and out["chain_equal_one_process"] and out["chain_ranks"] == [0]
            and out["feature_ranks"] == [0]
            and out["feature_max_abs_err"] <= graft_entry.FEATURE_TOL):
        raise AssertionError(f"dryrun_multichip(1): {out}")
    per = {"data_parallel": (1, 1), "train_step": (1, 1), "shard_map": (1, 1),
           "chain": (out["t_eval"], 0), "chain_one_process": (out["t_eval"], 0),
           "features": (0, 0)}
    counted = layers if on_card else 0  # the wrappers count launches on the card only
    want = {name: {"K1": counted * f, "K2": counted * b} for name, (f, b) in per.items()}
    if out["launches_by_step"] != want:
        raise AssertionError(f"dryrun launches {out['launches_by_step']} != {want}")
    res = {"phase": "dryrun", "entry_launches": entry_launches, "entry_seconds": entry_s,
           "dryrun_seconds": dryrun_s, **{k: v for k, v in out.items() if k != "summary"},
           "nvidia_smi": smi}
    emit(res)
    return res


def phase_demo(work_dir: str, device="cuda", untrained_overrides=()) -> dict:
    """The product-API demo (`layoutdm_tpu_torch.demo`, as ``python -m``
    runs it) on the train_cli job and with random weights: the seven files
    of each, non-empty, a GIF frame a step, and K1 launched layers x steps
    over its six chains (unconditional, the four tasks, the GIF's)."""
    from layoutdm_tpu_torch import demo

    res = {"phase": "demo"}
    for mode, args in (("job", ["--job_dir", f"{work_dir}/job"]),
                       ("untrained", ["--untrained", *untrained_overrides])):
        out_dir = f"{work_dir}/demo_{mode}"
        reset_launches()
        t0 = time.perf_counter()
        out = demo.main([*args, "--out_dir", out_dir, "--device", device])
        sec = time.perf_counter() - t0
        files = {name: os.path.getsize(os.path.join(out_dir, name)) for name in demo.FILES}
        if not (all(files.values()) and out["gif_frames"] == out["num_timesteps"]):
            raise AssertionError(f"demo {mode}: files {files}, {out['gif_frames']} GIF frames")
        steps = 6 * out["num_timesteps"]
        launches = (check_path_launches(f"demo {mode}", "default", out["num_layers"] * steps,
                                        ln=ln_launches("default", out["num_layers"], steps))
                    if torch.device(device).type == "cuda" else {})
        res[mode] = {"seconds": sec, "files": files, "gif_frames": out["gif_frames"],
                     "chain_steps": steps, "launches": launches}
    emit(res)
    return res


# K1's symbol: <row width, false> (K6: true), and the long bf16 body's keys a
# warpgroup after them
K1_SYMBOL = r"attention_fwd::attention_(bf16|f32)_kernel<\s*\d+\s*,\s*false\s*(,\s*\d+\s*)?>"


def phase_trace(work_dir: str, device="cuda", num_samples=16, num_timesteps=20) -> dict:
    """`sample_cli` with ``trace_dir`` on the train_cli job (default path):
    a Chrome trace whose kernels include K1's CUDA symbol (K6 shares the
    body with the bias template flag on)."""
    from layoutdm_tpu_torch.sample_cli import main as sample_main

    trace_dir = f"{work_dir}/trace"
    t0 = time.perf_counter()
    sample_main([f"job_dir={work_dir}/job", f"result_dir={work_dir}/trace_results",
                 "cond=unconditional", f"device={device}", f"num_uncond_samples={num_samples}",
                 f"max_batch_size={num_samples}", f"num_timesteps={num_timesteps}",
                 f"trace_dir={trace_dir}"])
    sec = time.perf_counter() - t0
    (name,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    k1 = sorted(k for k in kernels if re.search(K1_SYMBOL, k))
    if not k1:
        raise AssertionError(f"no K1 kernel in the trace; kernels: {sorted(kernels)[:20]}")
    out = {"phase": "trace", "file": name, "bytes": os.path.getsize(os.path.join(trace_dir, name)),
           "events": len(events), "kernel_names": len(kernels), "k1_symbol": k1[0][:160],
           "k1_events": sum(1 for e in events if e.get("name") in k1), "seconds": sec}
    emit(out)
    return out


ROW_KEYS = ("device", "card", "power_limit_w", "runs", "spread")
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "batch", "est_gflops_per_layout",
                 "achieved_tflops", "gemm_ceiling_tflops", "mfu_vs_gemm_ceiling", "mfu")
TRAIN_ROW_KEYS = ("metric", "value", "unit", "batch", "ms_per_step", "achieved_tflops",
                  "gemm_ceiling_tflops", "mfu_vs_gemm_ceiling", "mfu")
SERVE_ROW_KEYS = ("t_eval", "threads", "batch_size", "requests", "req_per_s", "layouts_per_s",
                  "p50_ms", "p95_ms", "program_runs")


def check_bench_row(what: str, r: dict, keys=(), nan_ok=()) -> dict:
    """A bench row holds ``keys`` and `ROW_KEYS`, names the device it ran
    on, and every number in it is finite (but those under a key in
    ``nan_ok``)."""
    missing = [k for k in (*keys, *ROW_KEYS) if k not in r]

    def numbers(x, key=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from numbers(v, k)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from numbers(v, key)
        elif isinstance(x, (int, float)) and not isinstance(x, bool):
            yield key, x

    bad = [k for k, x in numbers(r) if not np.isfinite(x) and not k.startswith(nan_ok or "\0")]
    if missing or bad or not r.get("runs"):
        raise AssertionError(f"bench {what}: missing {missing}, non-finite {bad}: {r}")
    return r


def phase_bench(work_dir: str, device="cuda", overrides=(), batch=1024, train_batch=1024,
                train_steps=20, runs=3, publaynet_batch=256, ladder=(25,), max_batch=64,
                zoo_batch=256, zoo_iters=2, zoo_ladder=(25, 50, 100), e2e_epochs=1,
                e2e_overrides=(), e2e_elements=100, int8_rows=128000, trace_batch=256,
                trace_steps=10) -> dict:
    """The port's bench entry points (`layoutdm_tpu_torch.bench`) at full
    width: the headline on the default path (T=100, B=1024, its MFU) with
    its per-row-seed, train and S=500 rows; the serve bench on a
    random-weight flagship job in a child service at T=25 and T=100; the
    zoo at ``zoo_iters`` calls a run; the S=500 pipeline for one epoch
    (six pickles); the int8 GEMM chains; a traced chain of
    ``trace_steps`` steps, summarised.  Every row well formed and finite,
    K1 and K2 launched by the headline exactly as often as its chains and
    train steps run them, coalescing under 16 clients."""
    from layoutdm_tpu_torch.bench import e2e_bigshape, headline, int8, profile_trace, serve, zoo

    out = os.path.join(work_dir, "bench")
    reset_launches()
    t0 = time.perf_counter()
    rows = headline.run(device, batch=batch, runs=runs, train_batch=train_batch,
                        train_steps=train_steps, publaynet_batch=publaynet_batch,
                        overrides=overrides, out=out)
    seconds = {"headline": time.perf_counter() - t0}
    # K1 once a layer and chain step: a warm-up and ``runs`` timed chains in
    # each of the two regimes and at S=500, and once a layer and train step
    # (dropout 0) in the train row's warm-up and timed runs; K2 once a layer
    # and train step.  The wrappers count only where they launch: on the card
    rico = headline.flagship_config(overrides=overrides)
    pub = headline.flagship_config("publaynet", 100, overrides)
    chain_steps = [c.backbone.num_layers * c.model.num_timesteps for c in (rico, rico, pub)]
    chains = sum(chain_steps) * (1 + runs)
    train = rico.backbone.num_layers * train_steps * (1 + runs)
    # K1's long body: the S=500 chains alone
    want = ({"K1": chains + train, "K2": train, "K1_long": chain_steps[2] * (1 + runs)}
            if device != "cpu" else {"K1": 0, "K2": 0, "K1_long": 0})
    from layoutdm_tpu_torch.ops import attention
    launches = {**launch_counts(), "K1_long": attention.LAUNCHES_LONG}
    launches = {k: launches[k] for k in want}
    if launches != want:
        raise AssertionError(f"bench headline launches {launches}, {want} wanted")
    for r, keys in zip(rows, (HEADLINE_KEYS, HEADLINE_KEYS[:6], TRAIN_ROW_KEYS,
                              HEADLINE_KEYS + ("seq_tokens",))):
        check_bench_row(r["metric"], r, keys if device != "cpu" else
                        [k for k in keys if k not in ("achieved_tflops", "gemm_ceiling_tflops",
                                                      "mfu_vs_gemm_ceiling", "mfu")])

    t0 = time.perf_counter()
    job = serve.write_random_job(os.path.join(work_dir, "bench_job"),
                                 headline.flagship_config(overrides=overrides), seed=3)
    serve_rows = serve.run(job_dir=job, ladder=ladder, max_batch_size=max_batch, device=device,
                           out=out)
    seconds["serve"] = time.perf_counter() - t0
    for r in serve_rows:
        check_bench_row("serve", r, SERVE_ROW_KEYS)
        if r["threads"] > 1 and not r["program_runs"] < r["requests"]:
            raise AssertionError(f"{r['requests']} concurrent requests took "
                                 f"{r['program_runs']} runs: no coalescing")

    t0 = time.perf_counter()
    # the relation-guided row is left to the bench itself: the attn_v2
    # and smajor serve phases and sample_cli already guide chains here
    zoo_rows = zoo.run(device, batch=zoo_batch, iters=zoo_iters, ladder=zoo_ladder,
                       relation=False, overrides=overrides, out=out)
    seconds["zoo"] = time.perf_counter() - t0
    for r in zoo_rows:
        check_bench_row(r["experiment"], r, ("ms_per_batch", "layouts_per_sec"))

    t0 = time.perf_counter()
    e2e = e2e_bigshape.run(os.path.join(out, "e2e_bigshape"), epochs=e2e_epochs,
                           max_elements=e2e_elements, device=device, overrides=e2e_overrides)
    seconds["e2e_bigshape"] = time.perf_counter() - t0
    # a pickle of empty layouts leaves its Wasserstein pair NaN (as in JAX)
    check_bench_row("e2e_bigshape", e2e, ("train_s", "best_val_loss", "tasks", "eval_s",
                                          "metrics"), nan_ok="wdist_")
    if e2e["artifacts"]["pickles"] != len(SAMPLE_TASKS):
        raise AssertionError(f"e2e_bigshape wrote {e2e['artifacts']['pickles']} pickles")

    t0 = time.perf_counter()
    int8_rows = int8.run(device, rows=int8_rows, out=out)
    seconds["int8"] = time.perf_counter() - t0
    for r in int8_rows:
        check_bench_row(r["metric"], r, ("value",))

    t0 = time.perf_counter()
    trace_dir = os.path.join(out, "trace")
    profile_trace.capture(trace_dir, trace_batch, trace_steps, device=device, overrides=overrides)
    trace = check_bench_row("trace", profile_trace.summarize(trace_dir),
                            ("kernel_ms", "kernels", "top"))
    seconds["trace"] = time.perf_counter() - t0
    if device != "cpu" and not any(re.search(K1_SYMBOL, k["kernel"]) for k in trace["top"]):
        raise AssertionError(f"trace summary names no K1 kernel: {trace['top'][:5]}")

    res = {"phase": "bench", "headline": rows, "serve": serve_rows, "zoo": zoo_rows,
           "e2e_bigshape": e2e, "int8": int8_rows, "trace": trace, "launches": launches,
           "seconds": seconds}
    emit({"phase": "bench", "seconds": seconds, "launches": launches})
    return res


def main() -> int:
    if not torch.cuda.is_available() or torch.version.cuda is None:
        print("chip_smoke: no CUDA device (needs an NVIDIA GPU)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(phase, **kw):
        t0 = time.perf_counter()
        out = phase(**kw)
        emit({"phase_seconds": out["phase"], "seconds": time.perf_counter() - t0})
        return out

    dev = run(phase_device)
    smi = dev["nvidia_smi"]
    run(phase_k1_name)  # first: see the module's note on it
    timed = run(phase_kernels)["times"]
    tr = run(phase_train, smi=smi)
    serves = {}
    with tempfile.TemporaryDirectory() as work:
        run(phase_parallel, work_dir=work, smi=smi)
        run(phase_dryrun, smi=smi)
        zoo = run(phase_zoo, work_dir=work, smi=smi)
        run(phase_fidnet_train, work_dir=work)
        run(phase_train_cli, work_dir=work)
        run(phase_demo, work_dir=work)
        for path in DENOISER_PATHS:
            guided = path in ("attn_v2", "smajor")
            serves[path] = run(phase_serve, smi=smi, path=path, relation=guided,
                               n_latency=5 if guided else 10)
            run(phase_throughput, smi=smi, path=path)
        run(phase_int8, smi=smi)
        run(phase_sample_cli, work_dir=work)
        run(phase_trace, work_dir=work)
        run(phase_fidnet, work_dir=work)
        run(phase_eval_cli, work_dir=work)
        run(phase_render_cli, work_dir=work)
        run(phase_bench, work_dir=work)

    # launches on each kernel's main path
    launches = {
        "attention_qkv": serves["default"]["launches"]["K1"],
        "attention_qkv_bwd": tr["launches_bwd"],
        "ln_ffn_residual": serves["fused"]["launches"]["K3"],
        "attention_block": serves["fused"]["launches"]["K4"],
        "attention_blockdiag": serves["attn_v2"]["launches"]["K5"],
        "attention_qkv_smajor": serves["smajor"]["launches"]["K6"],
        "ada_layer_norm": serves["default"]["launches"]["adaLN"],
        "layer_norm": serves["default"]["launches"]["LN"],
        "decode_attention": zoo["families"]["bart"]["sample"]["launches"]["decode"],
    }
    rows = []
    for name, source, replaces, _, shapes in KERNEL_TABLE:
        if name not in launches:
            continue
        t = timed[name][shapes[0][0]]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "bound_share": t["bound_share"],
            "library_ms": t["library_ms"],
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
