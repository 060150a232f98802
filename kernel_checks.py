"""The port's tolerances and checkers for its hand-written kernels (K1
attention forward, K2 its backward, K3 LayerNorm-FFN-residual, K4 attention
block, K5 padded-head attention, K6 sequence-major attention, the LayerNorm
kernel in its adaLN and affine modes, the cached decode's attention) and for
the GEMM epilogues' shim
against their plain versions, and the denoiser paths with the switches that
select them.

``tests/test_torch_cuda.py`` holds each kernel to these at its edge cases,
``chip_smoke.py`` at the shapes it times, and ``compare_kernels.py`` both
versions of a kernel it compares.  Each checker returns its max abs error
first and whether the output is within its tolerance last.  Imports no jax.
"""

from __future__ import annotations

import torch

from layoutdm_tpu_torch.ops import adaln

F32_TOL = 1e-4
# K1, K5, K6 in bfloat16: kernel and plain version round the normalised p
# and the output at the same points, so the outputs agree bit for bit
# except where float32 sums taken in another order flip a rounding (of one
# p, a step of p times |v|, or of an output).  Every output within
# BF16_TOL; the mean error within ATTN_BF16_MEAN_REL of the mean |output|,
# one output step (2**-8) on at most one output in 16.  A p rounded at
# another point (an online softmax's unnormalised exp(s - m)) moves about
# half of all outputs by a step.
BF16_TOL = 2e-2
ATTN_BF16_MEAN_REL = 2 ** -12
# q and k scaled by this in the sharp-score cases
SHARP = 3.0
# K2 against its twin, relative to the largest gradient: f32 differs by
# summation order only; bf16 by p and ds rounded to bf16 from f32 values
# that differ in their last bits, and the bf16 output rounding (2**-8)
BWD_F32_TOL = 1e-5
BWD_BF16_TOL = 1e-2
# K3 and K4 in bfloat16, relative to the largest output (the residual
# included): two rounding steps (2**-8 each) of the largest value
FUSED_BF16_REL_TOL = 2 ** -7
# the flagship-width denoiser in float32: 4 layers of float32 GEMMs around
# the kernels
DENOISER_TOL = 1e-3
# adaLN norm1 against its plain version: the kernel sums the statistics in
# another order than PyTorch's LayerNorm, so the normalised value may round
# to the neighbouring bf16 value where the float32 values straddle a
# rounding boundary (a few in 10**5 values); the modulation after it is
# exact.  So every output is the plain version's modulation of the plain
# normalised value or of one of its bf16 neighbours, and at least
# ADALN_EQUAL_SHARE of the outputs are bit-equal.  Float32 io: the
# statistics' summation order alone, ~1e-7 of the normalised value.
ADALN_EQUAL_SHARE = 0.999
ADALN_F32_TOL = 1e-5
# the affine mode against its plain version (F.layer_norm in float32 on the
# card, then the cast): both take float32 statistics, in another summation
# order, so the float32 values differ by a few ulps of the normalised value
# times w (LN_F32_TOL covers it at these inputs, |w y + b| < 10).  A float32
# output is held to that alone; a bfloat16 output to it plus the output's
# own rounding, half a bf16 step (at most 2**-8 of the value), and bit-equal to
# the plain version's cast on at least LN_EQUAL_SHARE of the outputs: a
# float32 value that straddles a rounding boundary is rare.
LN_F32_TOL = 1e-5
LN_EQUAL_SHARE = 0.999
# the GEMM epilogues (`ops.gemm_epilogue`, bfloat16).  ReLU + bias against
# the eager F.relu(F.linear(...)): ReLU commutes with the output's rounding,
# so the two agree bit for bit where cuBLASLt runs the same algorithm for
# both, and else differ by the float32 sums' order: every output within one
# bf16 step of the eager one.  The residual against the float32 sum (x Wᵀ +
# b + r, before any rounding): the epilogue rounds it once, so every output
# lies within half a bf16 step of it (2**-8 of the value) beyond the float32
# sums' own error (EPILOGUE_SUM_TOL of the largest output), and at least
# EPILOGUE_EQUAL_SHARE of the outputs are its rounding to nearest: sums
# taken in another order straddle a rounding boundary rarely (H100: 99.89%
# equal at K = 1,856, 99.97% at K = 464, 99.78% of one row of 1,856; the
# excess over half a step at most 5.3e-6 at outputs up to 6.6).  The eager
# add, which rounds the product first, agrees on ~69%.
EPILOGUE_SUM_TOL = 2 ** -16
EPILOGUE_EQUAL_SHARE = 0.99
# a bf16 denoiser's logits with the epilogues against its logits with the
# eager ReLU and adds, relative to the largest float32 logit: each of up to
# 4 layers rounds its residual sums at other points, half a bf16 step (2**-8)
# a layer (H100: 0.57-0.82% at 2 and 4 layers, three seeds each)
EPILOGUE_DENOISER_REL_TOL = 2 ** -6

# the cached decode's attention (`ops.decode_attention`) against its plain
# version, the eager einsums: in float32 the sums differ in order alone
# (F32_TOL).  In bfloat16 both round the scores, the probabilities and the
# output at the same points, but each q.k sum is taken in another order than
# cuBLAS's gemv, so a score that straddles a bf16 rounding boundary may round
# to its neighbour (a step of 2**-8 of the score), and so may a probability
# or an output: outputs agree bit for bit but for a bf16 step on a small
# share.  Its checker is K1's, `attention_errors`: every output within
# BF16_TOL, the mean error within ATTN_BF16_MEAN_REL of the mean |output|.

# the denoiser paths: the `build_model` switches each turns on, and the
# kernels each launches once a layer and forward
DENOISER_PATHS = {"default": ((), ("K1",)), "fused": (("fused_block", "fused_ffn"), ("K4", "K3")),
                  "attn_v2": (("attn_v2",), ("K5",)), "smajor": (("smajor",), ("K6",))}


def path_switches(path: str) -> dict:
    """`build_model` keywords that select ``path`` whatever the environment."""
    on = DENOISER_PATHS[path][0]
    return {k: k in on for k in ("fused_block", "fused_ffn", "attn_v2", "smajor")}


def _same_layout(got, want) -> bool:
    return got.shape == want.shape and got.dtype == want.dtype


def attention_errors(got, want) -> tuple:
    """(max abs error, mean abs error over the mean |want|, whether they
    are within F32_TOL in float32 or BF16_TOL and ATTN_BF16_MEAN_REL in
    bfloat16) of an attention kernel's output (K1, K5, K6) against its
    plain version's."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    mean_rel = diff.mean().item() / max(want.float().abs().mean().item(), 1e-30)
    if want.dtype == torch.float32:
        ok = err <= F32_TOL
    else:
        ok = err <= BF16_TOL and mean_rel <= ATTN_BF16_MEAN_REL
    return err, mean_rel, ok and _same_layout(got, want)


def fused_errors(got, want) -> tuple:
    """(max abs error, whether it is within F32_TOL in float32 or
    FUSED_BF16_REL_TOL of the largest output in bfloat16) of K3 or K4
    against its plain version."""
    err = (got.float() - want.float()).abs().max().item()
    tol = (F32_TOL if want.dtype == torch.float32
           else FUSED_BF16_REL_TOL * max(1.0, want.float().abs().max().item()))
    return err, err <= tol and _same_layout(got, want)


def block_errors(got, want) -> tuple:
    """K4 as K3 (`fused_errors`), and in bfloat16 the mean error as K1's:
    the normalised p rounded where the plain version rounds it."""
    err, ok = fused_errors(got, want)
    if want.dtype == torch.bfloat16:
        ok = ok and attention_errors(got, want)[1] <= ATTN_BF16_MEAN_REL
    return err, ok


def bwd_errors(got, want) -> tuple:
    """(max abs error, whether it is within BWD_F32_TOL or BWD_BF16_TOL of
    the largest gradient) of K2 against its plain version."""
    want = want.float()
    tol = BWD_F32_TOL if got.dtype == torch.float32 else BWD_BF16_TOL
    err = (got.float() - want).abs().max().item()
    return err, got.shape == want.shape and err <= tol * want.abs().max().item()


def bf16_step(y: torch.Tensor, k: int) -> torch.Tensor:
    """The bf16 value ``k`` representable steps from each of ``y``."""
    b = y.view(torch.int16).to(torch.int32)
    o = torch.where(b < 0, -(b & 0x7FFF), b) + k  # ordered as the values
    b = torch.where(o < 0, (-o) | 0x8000, o)
    return torch.where(b >= 0x8000, b - 0x10000, b).to(torch.int16).view(torch.bfloat16)


def adaln_errors(got, x, cond) -> tuple:
    """(max abs error, whether it is within the adaLN rule above) of the
    adaLN mode's output for ``x`` and ``cond`` against its plain version."""
    want = adaln.ada_layer_norm_reference(x, cond)
    if not _same_layout(got, want):
        return float("inf"), False
    err = (got.float() - want.float()).abs().max().item()
    if x.dtype == torch.float32:
        return err, bool(((got - want).abs() <= ADALN_F32_TOL * (1 + want.abs())).all())
    y = torch.nn.functional.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(x.dtype)
    scale, shift = cond[:, None].chunk(2, dim=-1)
    ok = got == want
    equal = ok.float().mean().item()
    for k in (-1, 1):
        ok |= got == (bf16_step(y, k) * (1 + scale) + shift).to(x.dtype)
    return err, bool(ok.all()) and equal >= ADALN_EQUAL_SHARE


def ln_errors(got, x, w, b, out_dtype) -> tuple:
    """(max abs error, whether it is within the affine rule above) of the
    affine mode's output for ``x``, ``w``, ``b`` against its plain version
    in float32."""
    ref = adaln.layer_norm_reference(x, w, b, torch.float32)
    if not (got.dtype == out_dtype and got.shape == x.shape):
        return float("inf"), False
    diff = (got.float() - ref).abs()
    tol = LN_F32_TOL + (2 ** -8 * ref.abs() if out_dtype == torch.bfloat16 else 0.0)
    ok = bool((diff <= tol).all())
    if out_dtype == torch.bfloat16:
        ok = ok and (got == ref.to(out_dtype)).float().mean().item() >= LN_EQUAL_SHARE
    return diff.max().item(), ok


def relu_epilogue_errors(got, want) -> tuple:
    """(max abs error, share of bit-equal outputs, whether every output is
    within one bf16 step) of the ReLU + bias epilogue against the eager
    pair's output ``want``."""
    if not _same_layout(got, want):
        return float("inf"), 0.0, False
    ok = got == want
    equal = ok.float().mean().item()
    for k in (-1, 1):
        ok |= got == bf16_step(want, k)
    return (got.float() - want.float()).abs().max().item(), equal, bool(ok.all())


def residual_epilogue_errors(got, want) -> tuple:
    """(max abs error, share of outputs equal to ``want``'s rounding, whether
    both are within the residual rule above) of the residual epilogue
    against the float32 sum ``want``."""
    if not (got.shape == want.shape and got.dtype == torch.bfloat16
            and want.dtype == torch.float32):
        return float("inf"), 0.0, False
    diff = (got.float() - want).abs()
    tol = 2 ** -8 * want.abs() + EPILOGUE_SUM_TOL * want.abs().max().item()
    equal = (got == want.to(torch.bfloat16)).float().mean().item()
    return diff.max().item(), equal, bool((diff <= tol).all()) and equal >= EPILOGUE_EQUAL_SHARE
