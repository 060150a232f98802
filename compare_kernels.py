"""Time the kernels K1, K6 (packed-qkv attention forward, batch- and
sequence-major), K5 (padded heads), K2 (backward), K3 (LayerNorm-FFN-
residual) and K4 (attention block) of this checkout against the same
kernels built from another checkout, on one NVIDIA GPU, and hold both
versions of K1, K6 and K4 to their plain versions on sharp scores and at
the 128-key edge.

    python3 compare_kernels.py --base DIR

DIR is the root of another checkout of the repo, for example the parent
commit unpacked with ``git archive``.  Each kernel is built twice, from this
checkout's sources and from DIR's, with the port's nvcc flags, and called
through its C entry point on the same bfloat16 inputs at the flagship widths
(8 heads of 58, FFN 1856; K5 on heads padded to 64).

1. Accuracy: both versions of K1, K6 and K4 against the plain version on
   the cases that show where the normalised softmax is rounded (q and k
   scaled by ``SHARP``; S = 127, 128, 129), one JSON line per case with
   each version's max abs error and whether it is within the port's
   tolerance (``kernel_checks.py``, the on-card tests' tolerances and
   checkers).  A base version that rounds p at another point shows as
   ``false``; the new one must be within.
2. Timing: on a slice of the batch the new version is held to the plain
   version within those tolerances, the base version within a
   sanity bound (K5, K2: the same tolerances); then both are timed by CUDA
   events (median of 25) in the order base, new, new, base, at the serving
   batches (B = 1, 64, 1024 at S = 125) and at B = 256, S = 500.

Prints the card's name and power limit, then one JSON line per case and
per kernel and shape.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

import chip_smoke as smoke
import kernel_checks as checks
from layoutdm_tpu_torch.bench.common import cuda_ms
from layoutdm_tpu_torch.ops import attention, attention_blockdiag, ffn
from layoutdm_tpu_torch.ops.cuda_build import load_library

H, HD, HP = smoke.FLAG_H, smoke.FLAG_HD, 64
D = H * HD
SCALE = HD ** -0.5
SERVE = ((1, 125), (64, 125), (1024, 125), (256, 500))
SHAPES = {  # (B, S) per kernel: the serving and throughput batches, and S = 500
    "K1": SERVE,
    "K6": SERVE,
    "K5": SERVE,
    "K2": ((1024, 125), (256, 500)),
    "K3": SERVE,
    "K4": SERVE,
}
# (name, B, S, q and k scale) of the accuracy cases
CASES = [(f"sharp_s{S}", 16, S, checks.SHARP) for S in (125, 129)] + [
    (f"edge_s{S}", 16, S, 1.0) for S in (127, 128, 129)]
# a base version that is off by more than this does not run the function
SANITY_TOL = 0.1
BUILDS = {  # kernel: (source, the port's binding)
    "K1": ("attention_qkv.cu", attention.kernel_library),
    "K6": ("attention_smajor.cu", attention.smajor_kernel_library),
    "K4": ("attention_block.cu", attention.block_kernel_library),
    "K5": ("attention_blockdiag.cu", attention_blockdiag.kernel_library),
    "K2": ("attention_qkv_bwd.cu", attention.bwd_kernel_library),
    "K3": ("ffn.cu", ffn.kernel_library),
}
ENTRY = {"K3": "ln_ffn_residual_launch"}  # where the C name is not <source>_launch


def entry_points(base: pathlib.Path) -> dict:
    """{kernel: {"base": fn, "new": fn}}, both bound like the port's own."""
    out = {}
    for k, (source, library) in BUILDS.items():
        fn = getattr(library().lib, ENTRY.get(k, source.replace(".cu", "_launch")))
        src = base / "layoutdm_tpu_torch" / "csrc" / source
        old = getattr(load_library(f"compare_base_{k}", [str(src.resolve())]).lib, fn.__name__)
        old.argtypes, old.restype = fn.argtypes, fn.restype
        out[k] = {"base": old, "new": fn}
    return out


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _slab(g, shape, sharp=1.0):
    """A random bf16 slab on the card whose first 2D columns (q, k) are
    scaled by ``sharp``."""
    x = torch.randn(shape, generator=g)
    x[..., : 2 * D] *= sharp
    return x.cuda().bfloat16()


def _attention_err(got, want) -> tuple:
    """(max abs error, within the tolerance, mean error over the mean
    |want|)."""
    err, mean_rel, ok = checks.attention_errors(got, want)
    return err, ok, mean_rel


def k1_call(fn, B, S, sharp=1.0):
    g = torch.Generator().manual_seed(B * 1000 + S)
    qkv = _slab(g, (B, S, 3 * D), sharp)
    out = torch.empty((B, S, D), dtype=qkv.dtype, device=qkv.device)

    def run(qkv=qkv, out=out):
        assert fn(qkv.data_ptr(), out.data_ptr(), qkv.shape[0], S, H, HD, SCALE, 1,
                  _stream()) == 0
        return out

    def err():
        sub = qkv[:8].contiguous()
        got = run(sub, torch.empty_like(out[:8]))
        return _attention_err(got, attention.attention_qkv_reference(sub, H))

    return run, err


def k6_call(fn, B, S, sharp=1.0):
    g = torch.Generator().manual_seed(B * 1000 + S)
    qkv = _slab(g, (S, B, 3 * D), sharp)
    bias = (0.5 * torch.randn((3 * D,), generator=g)).cuda().bfloat16()
    out = torch.empty((B, S, D), dtype=qkv.dtype, device=qkv.device)

    def run(qkv=qkv, out=out):
        assert fn(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), qkv.shape[1], S, H, HD,
                  SCALE, 1, _stream()) == 0
        return out

    def err():
        sub = qkv[:, :8].contiguous()
        got = run(sub, torch.empty_like(out[:8]))
        return _attention_err(got, attention.attention_qkv_smajor_reference(sub, bias, H))

    return run, err


def _fused_err(got, want) -> tuple:
    """K3's or K4's (max abs error, within the tolerance: 2**-7 of the
    largest output, and for K4 the mean within ATTN_BF16_MEAN_REL; mean
    error over the mean |want|)."""
    err, ok = checks.fused_errors(got, want)
    return err, ok, checks.attention_errors(got, want)[1]


def k4_call(fn, B, S, sharp=1.0):
    g = torch.Generator().manual_seed(B * 1000 + S)
    x = (0.5 * torch.randn((B, S, D), generator=g)).cuda().bfloat16()
    w_qkv = torch.randn((3 * D, D), generator=g) * D ** -0.5
    w_qkv[: 2 * D] *= sharp
    p = {"w_qkv": w_qkv, "b_qkv": 0.1 * torch.randn((3 * D,), generator=g),
         "w_out": torch.randn((D, D), generator=g) * D ** -0.5,
         "b_out": 0.1 * torch.randn((D,), generator=g)}
    p = {k: v.cuda().bfloat16() for k, v in p.items()}
    out = torch.empty_like(x)

    def run(x=x, out=out):
        assert fn(x.data_ptr(), p["w_qkv"].data_ptr(), p["b_qkv"].data_ptr(),
                  p["w_out"].data_ptr(), p["b_out"].data_ptr(), out.data_ptr(), x.shape[0], S,
                  H, HD, SCALE, 1, _stream()) == 0
        return out

    def err():
        sub = x[:8].contiguous()
        got = run(sub, torch.empty_like(sub))
        e = _fused_err(got, attention.attention_block_reference(sub, **p, num_heads=H))
        return e[0], e[1] and e[2] <= checks.ATTN_BF16_MEAN_REL, e[2]

    return run, err


def k3_call(fn, B, S):
    g = torch.Generator().manual_seed(B * 1000 + S)
    Fd = smoke.FLAG_F
    x = (0.5 * torch.randn((B, S, D), generator=g)).cuda().bfloat16()
    p = {"ln_scale": 1 + 0.1 * torch.randn((D,), generator=g),
         "ln_bias": 0.1 * torch.randn((D,), generator=g),
         "w1": torch.randn((Fd, D), generator=g) * D ** -0.5,
         "b1": 0.1 * torch.randn((Fd,), generator=g),
         "w2": torch.randn((D, Fd), generator=g) * Fd ** -0.5,
         "b2": 0.1 * torch.randn((D,), generator=g)}
    p = {k: v.cuda() if k.startswith("ln") else v.cuda().bfloat16() for k, v in p.items()}
    out = torch.empty_like(x)
    relu = ffn.ACTIVATION_CODES["relu"]

    def run(x=x, out=out):
        assert fn(x.data_ptr(), p["ln_scale"].data_ptr(), p["ln_bias"].data_ptr(),
                  p["w1"].data_ptr(), p["b1"].data_ptr(), p["w2"].data_ptr(),
                  p["b2"].data_ptr(), out.data_ptr(), x.numel() // D, D, Fd, relu, 1e-6, 1,
                  _stream()) == 0
        return out

    def err():
        sub = x[:8].contiguous()
        got = run(sub, torch.empty_like(sub))
        return _fused_err(got, ffn.ln_ffn_residual_reference(sub, **p, activation="relu"))

    return run, err


def k5_call(fn, B, S):
    g = torch.Generator().manual_seed(B * 1000 + S)
    qkv = smoke.padded_slab(g, B, S, H, HD, HP, torch.bfloat16)
    out = torch.empty((B, S, H * HP), dtype=qkv.dtype, device=qkv.device)

    def run(qkv=qkv, out=out):
        assert fn(qkv.data_ptr(), out.data_ptr(), qkv.shape[0], S, H, HP, SCALE, 1,
                  _stream()) == 0
        return out

    def err():
        sub = qkv[:8].contiguous()
        got = run(sub, torch.empty_like(out[:8]))
        want = attention_blockdiag.blockdiag_attention_reference(sub, H, HP, SCALE)
        assert not got.view(-1, H, HP)[..., HD:].count_nonzero()
        return _attention_err(got, want)

    return run, err


def k2_call(fn, B, S):
    g = torch.Generator().manual_seed(B * 1000 + S)
    qkv = torch.randn((B, S, 3 * D), generator=g).cuda().bfloat16()
    do = torch.randn((B, S, D), generator=g).cuda().bfloat16()
    out = torch.empty_like(qkv)
    stats = torch.empty((B, H, S, 2), device=qkv.device)

    def run(qkv=qkv, do=do, out=out):
        assert fn(qkv.data_ptr(), do.data_ptr(), out.data_ptr(), stats.data_ptr(),
                  qkv.shape[0], S, H, HD, SCALE, 1, _stream()) == 0
        return out

    def err():
        sub, dsub = qkv[:8].contiguous(), do[:8].contiguous()
        got = run(sub, dsub, torch.empty_like(sub))
        want = attention.attention_qkv_bwd_reference(sub, dsub, H).float()
        rel = ((got.float() - want).abs().max() / want.abs().max()).item()
        return rel, rel <= checks.BWD_BF16_TOL, None

    return run, err


CALLS = {"K1": k1_call, "K6": k6_call, "K5": k5_call, "K2": k2_call, "K3": k3_call,
         "K4": k4_call}


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
    for kernel in ("K1", "K6", "K4"):
        for name, B, S, sharp in CASES:
            res = {}
            for v in ("base", "new"):
                fn = fns[kernel][v]
                res[v] = CALLS[kernel](fn, B, S, sharp)[1]()
            print(json.dumps({"kernel": kernel, "case": name,
                              "err": {v: r[0] for v, r in res.items()},
                              "mean_rel": {v: r[2] for v, r in res.items()},
                              "within_tol": {v: r[1] for v, r in res.items()}}), flush=True)
            if not res["new"][1]:
                raise AssertionError(f"{kernel} case {name}: new version over the tolerance")
    for kernel, make in CALLS.items():
        for B, S in SHAPES[kernel]:
            runs = {v: make(fns[kernel][v], B, S) for v in ("base", "new")}
            err = {v: runs[v][1]() for v in runs}
            assert err["new"][1] and err["base"][0] <= SANITY_TOL, err
            ms = {"base": [], "new": []}
            for v in ("base", "new", "new", "base"):
                ms[v].append(cuda_ms(runs[v][0]))
            print(json.dumps({"kernel": kernel, "B": B, "S": S,
                              "err": {v: e[0] for v, e in err.items()},
                              "mean_rel": {v: e[2] for v, e in err.items()}, "ms": ms}),
                  flush=True)
            del runs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
