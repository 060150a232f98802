"""Analytic FLOP counts of the flagship and the measured GEMM ceiling
they are judged against (port of ``bench.py``'s ``flops_per_layout``,
``measure_gemm_ceiling`` and ``bin/bench_train.py``'s
``train_flops_per_sample``)."""

from __future__ import annotations

import torch

from layoutdm_tpu_torch.bench.common import cuda_ms


def flops_per_layout(model, num_timesteps: int = 100) -> int:
    """Dense FLOPs of one sampled layout (a multiply-add is 2): the
    denoiser's GEMMs (qkv, out, the two FFN products), its attention
    scores and weighted sum, the head, and the posterior's two route
    products over the converter's (Vf, Vp) tables, each of
    ``num_timesteps`` steps.  Elementwise log-space work is left out.  The
    widths are the model's own, after the 29/32 shrink (464 / 1856 at the
    flagship)."""
    bb = model.backbone_cfg
    d, ff, L = bb.d_model, bb.dim_feedforward, bb.num_layers
    S, V = model.seq_len, model.num_classes
    per_token_layer = 2 * d * d * 4 + 2 * d * ff * 2  # qkv + out, 2 FFN GEMMs
    attn = 2 * 2 * S * d  # scores + weighted sum, a token a layer
    head = 2 * d * V
    denoiser = S * (L * (per_token_layer + attn) + head)
    cv = getattr(model.q, "converter", None)
    routes = 2 * (S * 2 * cv.Vf * cv.Vp) if cv is not None else 0
    return num_timesteps * (denoiser + routes)


def train_flops_per_sample(model) -> int:
    """One training sample: a denoiser forward and its backward (2x), the
    posterior routes in the gradient's path."""
    return 3 * flops_per_layout(model, num_timesteps=1)


def measure_gemm_ceiling(batch: int, model, device="cuda", repeats: int = 3) -> float:
    """Measured TFLOP/s of the sampler's dominant GEMM shape on this card:
    the (B*S, d) x (d, ff) -> (B*S, ff) x (ff, d) FFN pair in bf16, each
    output consumed by the next product.  The rescaling that keeps the
    chain finite lives in the constant operands (a pair's gain is 1), so
    nothing but the two products runs.  The time of a pair is the slope
    between chains of 10 and 40 pairs (CUDA events around each chain, the
    median of ``repeats``), so a chain's fixed cost cancels.
    ``torch.matmul`` is the yardstick here, not a port of a kernel; TF32
    plays no part (bf16 operands)."""
    bb = model.backbone_cfg
    m, k, n = batch * model.seq_len, bb.d_model, bb.dim_feedforward
    dt = torch.bfloat16
    a = torch.full((m, k), 0.01, dtype=dt, device=device)
    b1 = torch.full((k, n), 0.01, dtype=dt, device=device)
    # pair gain ~= (0.01 k)(b2 n) == 1
    b2 = torch.full((n, k), 1.0 / (0.01 * k * n), dtype=dt, device=device)

    def chain(iters: int) -> float:
        def run():
            x = a
            for _ in range(iters):
                x = (x @ b1) @ b2
            return x[0].float().sum()

        run()  # warm: allocator, GEMM heuristics
        return cuda_ms(run, iters=repeats, warmup=0, device=device)

    slope_ms = max((chain(40) - chain(10)) / 30, 1e-9)
    return 2.0 * m * k * n * 2 / (slope_ms * 1e-3) / 1e12
