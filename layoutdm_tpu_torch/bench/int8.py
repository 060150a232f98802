"""int8 against bf16 GEMMs at the flagship's FFN shape (port of
``bin/bench_int8.py``).

    python -m layoutdm_tpu_torch.bench.int8 [--out DIR]

The FFN pair (M, 464) x (464, 1856) -> (M, 1856) x (1856, 464), M = B*S =
1024 x 125 rows, chained.  A pair's time is the slope between chains of
10 and 40 pairs (CUDA events around each chain; one slope a run, 3 runs),
so a chain's fixed cost cancels:

- ``bf16_pair``: the two bf16 products and nothing else, each output
  feeding the next product (weights scaled so a product's gain is ~1);
- ``int8_pair``: the two ``torch._int_mm`` products (int8 x int8 -> int32,
  the call `models.int8_serving` makes) and nothing else: both read fixed
  int8 operands (eager PyTorch launches every call, whether or not its
  output is read), so it does the bf16 pair's work;
- ``int8_pair_dynamic``: the pair from bf16 activations, each product's
  input quantized per tensor (max |x| / 127) and its int32 output cast
  back to bf16, as a serving step without fused epilogues would.

Then, timed alone at the first product's shape (CUDA events around each
call, the median of 20): ``int_mm`` (the product), ``quantize``
(bf16 (M, 464) -> int8 with a static scale, `int8_serving._int8_dense`'s
expression), ``dequantize`` (int32 (M, 1856) -> float32 with the per-channel
scale and the bias) and ``int8_dense``, the three as
`int8_serving._int8_dense` runs them.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Callable, Dict, List

import torch

from layoutdm_tpu_torch.bench.common import (
    DEFAULT_OUT,
    card,
    cuda_ms,
    emit,
    require_device,
    row,
    write_rows,
)

K, N = 464, 1856  # the flagship's d_model and FFN width after the 29/32 shrink


def slope_runs(step: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor, runs: int,
               device) -> List[float]:
    """ms a pair: for each run, (time of 40 steps - time of 10) / 30."""
    def chain(iters):
        def go():
            x = x0
            for _ in range(iters):
                x = step(x)
            return x[0].float().sum()
        return go

    def once(fn):
        return cuda_ms(fn, iters=1, warmup=0, device=device)

    lo, hi = chain(10), chain(40)
    lo(), hi()  # warm: allocator, GEMM heuristics
    return [max((once(hi) - once(lo)) / 30, 1e-9) for _ in range(runs)]


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """`int8_serving._int8_dense`'s quantize: round(x / s), clipped to
    [-127, 127], by the reciprocal."""
    return torch.clamp(torch.round(x.float() * (1.0 / scale)), -127, 127).to(torch.int8)


def run(device="cuda", rows: int = 128000, runs: int = 3, calls: int = 20,
        out: str = DEFAULT_OUT) -> List[Dict]:
    from layoutdm_tpu_torch.models.int8_serving import _int8_dense

    device = require_device(device)
    info = card(device)
    g = torch.Generator().manual_seed(0)
    M = rows
    pair_ops = 2.0 * 2 * M * K * N

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    def randint8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(device)

    a = randn(M, K, scale=0.1).to(torch.bfloat16)
    # nn.Linear's (out, in); 1/sqrt(fan-in) keeps a product's gain ~1
    w1 = randn(N, K, scale=K ** -0.5).to(torch.bfloat16)
    w2 = randn(K, N, scale=N ** -0.5).to(torch.bfloat16)
    a8, h8, w1q, w2q = randint8(M, K), randint8(M, N), randint8(N, K), randint8(K, N)

    def bf16_pair(x):
        return (x @ w1.t()) @ w2.t()

    def int8_pair(x):
        torch._int_mm(x, w1q.t())
        torch._int_mm(h8, w2q.t())
        return x

    def int8_pair_dynamic(x):
        s1 = x.abs().amax().float() / 127.0
        h = torch._int_mm(quantize(x, s1), w1q.t()).to(torch.bfloat16)
        s2 = h.abs().amax().float() / 127.0
        o = torch._int_mm(quantize(h, s2), w2q.t()).to(torch.bfloat16)
        return torch.tanh(o * 1e-6)

    out_rows = []
    for name, step, x0, rate in (("bf16_pair", bf16_pair, a, "achieved_tflops"),
                                 ("int8_pair", int8_pair, a8, "achieved_tops"),
                                 ("int8_pair_dynamic", int8_pair_dynamic, a, "achieved_tops")):
        ms = slope_runs(step, x0, runs, device)
        med = statistics.median(ms)
        out_rows.append(emit(row(device, info, ms, "ms a pair", metric=f"int8_bench_{name}",
                                 value=med, unit="ms", rows=M, k=K, n=N,
                                 **{rate: pair_ops / (med * 1e-3) / 1e12})))

    s_act = torch.tensor(0.02, device=device)
    entry = {"w_q": w1q, "s_w": torch.rand(N, generator=g).to(device) * 1e-3 + 1e-4,
             "b": randn(N, scale=0.01)}
    acc = torch._int_mm(a8, w1q.t())
    passes = {
        "int_mm": (lambda: torch._int_mm(a8, w1q.t()), 2.0 * M * K * N),
        "quantize": (lambda: quantize(a, s_act), None),
        "dequantize": (lambda: acc.float() * (s_act * entry["s_w"]) + entry["b"], None),
        "int8_dense": (lambda: _int8_dense(a, entry, s_act), 2.0 * M * K * N),
    }
    for name, (fn, ops) in passes.items():
        fn()
        ms = [cuda_ms(fn, iters=1, warmup=0, device=device) for _ in range(calls)]
        med = statistics.median(ms)
        fields = {"achieved_tops": ops / (med * 1e-3) / 1e12} if ops else {}
        out_rows.append(emit(row(device, info, ms, "ms a call", metric=f"int8_bench_{name}",
                                 value=med, unit="ms", rows=M, k=K, n=N, **fields)))
    write_rows(out, "int8", out_rows)
    return out_rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    a = ap.parse_args(argv)
    return run(a.device, out=a.out)


if __name__ == "__main__":
    main()
