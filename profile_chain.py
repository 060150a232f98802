"""Where a reverse-chain step of the port spends its time, on one NVIDIA GPU.

    python3 profile_chain.py [--batches 1,64,1024] [--steps 10] [--out DIR]

For each batch size, the flagship LayoutDM (Rico25 width, bfloat16, random
weights from a seed) runs a chain of ``--steps`` steps in the service's
per-row-seed regime with the random sampler: once to warm up, once timed,
once under ``torch.profiler``.  The denoiser path follows the JAX
package's switches in the environment (`factory.build_model`):
``LAYOUTDM_TPU_FUSED_BLOCK=1`` and ``LAYOUTDM_TPU_FUSED_FFN=1`` give the
fused path (K4 + K3), ``LAYOUTDM_TPU_ATTN_V2=1`` the block-diagonal
attention (K5), ``LAYOUTDM_TPU_SMAJOR=1`` the S-major attention (K6), none
of them K1 and the unfused FFN; ``LAYOUTDM_TPU_INT8=1`` swaps the
denoiser for the int8 serving mirror (`models.int8_serving`: int8 GEMMs,
K1 attention), as the JAX package's ``bench.py`` does; ``path`` names it
in every row.  Per batch size it reports:

- ``wall_ms_per_step``: host clock around a chain run without the
  profiler, synchronised;
- ``kernel_ms_per_step``: the summed duration of the CUDA kernels the
  profiler recorded in a second run, and ``kernels_per_step``, their count;
- ``idle_share``: 1 - kernel time / wall time (one stream, so kernels do
  not overlap);
- ``components``: median device ms (CUDA events) of one denoiser forward,
  one ``q_posterior_ids``, one per-row Gumbel draw and one argmax;
- ``top_kernels_ms_per_step``: the 15 kernels with the most device time.

Prints one JSON line per batch size and writes ``profile_chain.json`` plus
the profiler's per-op table (``profile_B{B}.txt``) to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

from chip_smoke import flagship_config
from layoutdm_tpu_torch.bench.common import cuda_ms


def profile_batch(batch: int, steps: int, out_dir: str, device="cuda") -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from layoutdm_tpu_torch.factory import build_model
    from layoutdm_tpu_torch.ops.samplers import row_gumbel

    from layoutdm_tpu_torch.models.int8_serving import can_use_int8, make_int8_predict_start

    cfg = flagship_config("bfloat16")
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(4))
    path, denoiser = model.denoiser_path, model.net
    if can_use_int8(model.backbone_cfg, cfg.model.pos_emb):
        model._predict_start = make_int8_predict_start(model)
        denoiser = model._predict_start.logits  # the mirror, as `model.net`: no head
        path = "int8 (K1)"
    seeds = torch.arange(batch, dtype=torch.int64)

    def chain():
        model.sample_ids(seeds, batch, num_timesteps_eval=steps)
        torch.cuda.synchronize()

    chain()  # warm-up: kernel build, allocator, GEMM heuristics
    t0 = time.perf_counter()
    chain()  # timed without the profiler, whose own host cost is not the port's
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chain()

    per_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = per_name[e.name]
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    kernel_ms = sum(v[0] for v in per_name.values())
    n_kernels = sum(v[1] for v in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:15]

    dev = model.device
    rs = torch.Generator().manual_seed(5)
    ids = torch.randint(0, model.num_classes, (batch, model.seq_len), generator=rs).to(dev)
    t = torch.full((batch,), model.q.num_timesteps // 2, dtype=torch.int64, device=dev)
    cuda_seeds = seeds.to(dev)
    with torch.inference_mode():
        log_x0 = model._predict_start(ids, t)
        components = {
            "denoiser_ms": cuda_ms(lambda: denoiser(ids, t)),
            "posterior_ms": cuda_ms(lambda: model.q.q_posterior_ids(log_x0, ids, t)),
            "row_gumbel_ms": cuda_ms(lambda: row_gumbel(cuda_seeds, 0, log_x0.shape)),
            "argmax_ms": cuda_ms(lambda: torch.argmax(log_x0, dim=-1)),
        }

    with open(os.path.join(out_dir, f"profile_B{batch}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30))
    return {
        "B": batch,
        "path": path,
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "kernel_ms_per_step": kernel_ms / steps,
        "idle_share": 1.0 - kernel_ms / wall_ms,
        "kernels_per_step": n_kernels / steps,
        "components": components,
        "top_kernels_ms_per_step": [
            [name[:90], ms / steps, n // steps] for name, (ms, n) in top
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1,64,1024")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="tmp/profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.version.cuda is None:
        print("profile_chain: no CUDA device (needs an NVIDIA GPU)", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    rows = []
    for b in (int(x) for x in args.batches.split(",")):
        row = profile_batch(b, args.steps, args.out)
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "top_kernels_ms_per_step"}
                         | {"nvidia_smi": smi}), flush=True)
    with open(os.path.join(args.out, "profile_chain.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
