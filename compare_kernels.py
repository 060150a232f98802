"""Time the padded-head attention (K5) and the attention backward (K2) of
this checkout against the same kernels built from another checkout, on one
NVIDIA GPU.

    python3 compare_kernels.py --base DIR

DIR is the root of another checkout of the repo, for example the parent
commit unpacked with ``git archive``.  Each kernel is built twice, from this
checkout's sources and from DIR's, with the port's nvcc flags, and called
through its C entry point on the same bfloat16 inputs at the flagship widths
(8 heads of 58; K5 on heads padded to 64).  Both versions are first held to
the plain version on a slice of the batch, within ``chip_smoke``'s
tolerances; then they are timed by CUDA events (median of 25) in the order
base, new, new, base.  Prints the card's name and power limit, then one JSON
line per kernel and shape.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

import chip_smoke as smoke
from layoutdm_tpu_torch.ops import attention, attention_blockdiag
from layoutdm_tpu_torch.ops.cuda_build import load_library

H, HD, HP = smoke.FLAG_H, smoke.FLAG_HD, 64
SHAPES = {  # (B, S) per kernel: the serving and throughput batches, and S = 500
    "K5": ((1, 125), (64, 125), (1024, 125), (256, 500)),
    "K2": ((1024, 125), (256, 500)),
}


def entry_points(base: pathlib.Path) -> dict:
    """{kernel: {"base": fn, "new": fn}}, both bound like the port's own."""
    new = {"K5": attention_blockdiag.kernel_library().lib.attention_blockdiag_launch,
           "K2": attention.bwd_kernel_library().lib.attention_qkv_bwd_launch}
    sources = {"K5": "attention_blockdiag.cu", "K2": "attention_qkv_bwd.cu"}
    out = {}
    for k, fn in new.items():
        src = base / "layoutdm_tpu_torch" / "csrc" / sources[k]
        old = getattr(load_library(f"compare_base_{k}", [str(src.resolve())]).lib, fn.__name__)
        old.argtypes, old.restype = fn.argtypes, fn.restype
        out[k] = {"base": old, "new": fn}
    return out


def k5_call(fn, B, S):
    g = torch.Generator().manual_seed(B * 1000 + S)
    qkv = smoke.padded_slab(g, B, S, H, HD, HP, torch.bfloat16)
    out = torch.empty((B, S, H * HP), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run(qkv=qkv, out=out):
        assert fn(qkv.data_ptr(), out.data_ptr(), qkv.shape[0], S, H, HP, HD ** -0.5, 1,
                  stream) == 0
        return out

    def err():
        sub = qkv[:8].contiguous()
        got = run(sub, torch.empty_like(out[:8]))
        want = attention_blockdiag.blockdiag_attention_reference(sub, H, HP, HD ** -0.5)
        e = (got.float() - want.float()).abs().max().item()
        assert e <= smoke.BF16_TOL and not got.view(-1, H, HP)[..., HD:].count_nonzero(), e
        return e

    return run, err


def k2_call(fn, B, S):
    g = torch.Generator().manual_seed(B * 1000 + S)
    qkv = torch.randn((B, S, 3 * H * HD), generator=g).cuda().bfloat16()
    do = torch.randn((B, S, H * HD), generator=g).cuda().bfloat16()
    out = torch.empty_like(qkv)
    stats = torch.empty((B, H, S, 2), device=qkv.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run(qkv=qkv, do=do, out=out):
        assert fn(qkv.data_ptr(), do.data_ptr(), out.data_ptr(), stats.data_ptr(),
                  qkv.shape[0], S, H, HD, HD ** -0.5, 1, stream) == 0
        return out

    def err():
        sub, dsub = qkv[:8].contiguous(), do[:8].contiguous()
        got = run(sub, dsub, torch.empty_like(sub))
        want = attention.attention_qkv_bwd_reference(sub, dsub, H).float()
        rel = ((got.float() - want).abs().max() / want.abs().max()).item()
        assert rel <= smoke.BWD_BF16_TOL, rel
        return rel

    return run, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="root of the checkout to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.version.cuda is None:
        print("compare_kernels: no CUDA device (needs an NVIDIA GPU)", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    fns = entry_points(pathlib.Path(args.base))
    for kernel, make in (("K5", k5_call), ("K2", k2_call)):
        for B, S in SHAPES[kernel]:
            runs = {v: make(fns[kernel][v], B, S) for v in ("base", "new")}
            err = {v: runs[v][1]() for v in runs}
            ms = {"base": [], "new": []}
            for v in ("base", "new", "new", "base"):
                ms[v].append(smoke.cuda_ms(runs[v][0]))
            print(json.dumps({"kernel": kernel, "B": B, "S": S, "err": err, "ms": ms}),
                  flush=True)
            del runs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
