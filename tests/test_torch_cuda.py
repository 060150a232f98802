"""The port on a CUDA card: the hand-written kernels (K1 attention forward,
K2 its backward, K3 LayerNorm-FFN-residual, K4 attention block, K5
padded-head attention, K6 sequence-major attention) against their plain
versions, the denoiser (every path), the per-row noise and the FIDNet
feature extractor on the card against the CPU.  Every test here is marked ``cuda`` and skips without a card.

This file imports no jax and nothing of the JAX package (as
the port does), so it also runs on a GPU host without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from layoutdm_tpu_torch.configs import BackboneConfig, build_train_config
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.models.nn import make_transformer
from layoutdm_tpu_torch.ops import attention, attention_blockdiag
from layoutdm_tpu_torch.ops.attention import (
    attention_qkv_bwd_reference,
    attention_qkv_reference,
    fused_attention_qkv,
    fused_attention_qkv_bwd,
    fused_attention_qkv_diff,
)
from layoutdm_tpu_torch.ops import ffn
from layoutdm_tpu_torch.ops.samplers import gumbel_noise, row_uniform

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

pytestmark = pytest.mark.cuda

# the tile edges of the tensor-core bodies: K2's 64-row tiles, 16-key steps
# and 128-key chunks (one pass over K/V at S <= 128, two sweeps past it),
# every head width it pads (to 32, 64, 96, 128); K5's 16-key steps, 128-key
# chunks and 128-query blocks up to its sequence limit, at both head pads
BWD_EDGES = [
    (2, S, 4, hd, dtype, 0.0)
    for hd in (32, 58, 64, 96, 128)
    for S in (1, 64, 65, 128, 129, 500)
    for dtype in (torch.float32, torch.bfloat16)
] + [
    # K2's bf16 copy modes: 16-byte windows with heads at every lead (hd 58
    # and 30 over 4 heads), element copies where no window fits (d_model 174
    # is no multiple of 8; hd 124 needs a window wider than 128; odd hd)
    (2, 65, 4, 30, torch.bfloat16, 0.0),
    (2, 65, 3, 58, torch.bfloat16, 0.0),
    (2, 40, 2, 124, torch.bfloat16, 0.0),
    (2, 40, 2, 5, torch.bfloat16, 0.0),
]
BLOCKDIAG_EDGES = [
    (2, S, 2, hd, hp, dtype, 1.0)
    for S in (1, 16, 64, 65, 127, 128, 129, 1024)
    for hd, hp in ((58, 64), (100, 128))
    for dtype in (torch.float32, torch.bfloat16)
]
# K1's and K6's: one key, the 128-key chunk (two sweeps past it), the
# 128-query block, in both dtypes; and sharp scores on both sides of 128
FWD_EDGES = [
    (2, S, 8, 58, dtype, 1.0)
    for S in (1, 127, 128, 129)
    for dtype in (torch.float32, torch.bfloat16)
] + [(4, S, 8, 58, torch.bfloat16, SHARP) for S in (125, 129, 500)]


def _assert_attention_close(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=F32_TOL if want.dtype == torch.float32 else BF16_TOL)
    if want.dtype == torch.bfloat16:
        diff = (got.float() - want.float()).abs().mean().item()
        assert diff <= ATTN_BF16_MEAN_REL * want.float().abs().mean().item(), diff


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _slab(B, S, H, hd, seed=0):
    return np.random.RandomState(seed).randn(B, S, 3 * H * hd).astype(np.float32)


@pytest.mark.parametrize(
    "B,S,H,hd,dtype,scale,sharp",
    [
        (4, 125, 8, 58, torch.float32, 0.0, 1.0),
        (4, 125, 8, 58, torch.bfloat16, 0.0, 1.0),
        (2, 500, 8, 58, torch.float32, 0.0, 1.0),
        (3, 1, 2, 128, torch.float32, 0.0, 1.0),
        (2, 33, 3, 64, torch.bfloat16, 58 ** -0.5, 1.0),
        (1, 70, 1, 5, torch.float32, 0.0, 1.0),
        # the bf16 copy modes and row widths: 16-byte windows at every lead
        # (hd 30 and 58 over 4 heads), element copies where no window fits
        # (d_model 174, hd 124, odd hd), rows 32, 96 and 128 wide
        (2, 65, 4, 30, torch.bfloat16, 0.0, 1.0),
        (2, 65, 4, 24, torch.bfloat16, 0.0, 1.0),
        (2, 65, 3, 58, torch.bfloat16, 0.0, 1.0),
        (2, 40, 2, 124, torch.bfloat16, 0.0, 1.0),
        (2, 40, 2, 5, torch.bfloat16, 0.0, 1.0),
        (2, 65, 4, 96, torch.bfloat16, 0.0, 1.0),
        (2, 200, 2, 128, torch.bfloat16, 0.0, 1.0),
    ] + [(B, S, H, hd, dtype, 0.0, sharp) for B, S, H, hd, dtype, sharp in FWD_EDGES],
)
def test_kernel_matches_plain_version(cuda, B, S, H, hd, dtype, scale, sharp):
    qkv = _slab(B, S, H, hd)
    qkv[..., : 2 * H * hd] *= sharp  # q and k
    qkv = torch.as_tensor(qkv).to(cuda, dtype)
    before = attention.LAUNCHES
    got = fused_attention_qkv(qkv, H, scale=scale)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == before + 1
    want = attention_qkv_reference(qkv, H, scale=scale)
    assert got.dtype == dtype and got.shape == (B, S, H * hd)
    _assert_attention_close(got, want)


def test_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        fused_attention_qkv(torch.zeros(1, 4, 24, device=cuda, dtype=torch.float16), 2)
    with pytest.raises(ValueError):
        fused_attention_qkv(torch.zeros(1, 4, 3 * 2 * 129, device=cuda), 2)
    with pytest.raises(ValueError):
        fused_attention_qkv(torch.zeros(1, 48, 4, device=cuda).transpose(1, 2), 2)


@pytest.mark.parametrize(
    "B,S,H,hd,dtype,scale",
    [
        (4, 125, 8, 58, torch.float32, 0.0),
        (4, 125, 8, 58, torch.bfloat16, 0.0),
        (2, 500, 8, 58, torch.float32, 0.0),
        (2, 500, 8, 58, torch.bfloat16, 0.0),
        (3, 1, 2, 128, torch.float32, 0.0),
        (2, 33, 3, 64, torch.bfloat16, 58 ** -0.5),
        (1, 70, 1, 5, torch.float32, 0.0),
    ] + BWD_EDGES,
)
def test_bwd_kernel_matches_plain_version(cuda, B, S, H, hd, dtype, scale):
    qkv = torch.as_tensor(_slab(B, S, H, hd)).to(cuda, dtype)
    do = torch.as_tensor(
        np.random.RandomState(1).randn(B, S, H * hd).astype(np.float32)
    ).to(cuda, dtype)
    before = attention.LAUNCHES_BWD
    got = fused_attention_qkv_bwd(qkv, do, H, scale=scale)
    torch.cuda.synchronize()
    assert attention.LAUNCHES_BWD == before + 1
    want = attention_qkv_bwd_reference(qkv, do, H, scale=scale)
    assert got.dtype == dtype and got.shape == qkv.shape
    tol = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_on_card_matches_plain_version(cuda, dtype):
    """Through autograd the forward is K1 and the gradient K2 of the saved
    slab and the output's cotangent: both against the twins on the card."""
    B, S, H, hd = 3, 125, 8, 58
    rs = np.random.RandomState(2)
    qkv = torch.as_tensor(rs.randn(B, S, 3 * H * hd).astype(np.float32)).to(cuda, dtype)
    w = torch.as_tensor(rs.randn(H * hd, H * hd).astype(np.float32) * 0.05).to(cuda, dtype)
    x = qkv.clone().requires_grad_()
    launches = attention.LAUNCHES, attention.LAUNCHES_BWD
    o = fused_attention_qkv_diff(x, H)
    o.retain_grad()
    (o @ w).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (attention.LAUNCHES, attention.LAUNCHES_BWD) == (launches[0] + 1, launches[1] + 1)
    _assert_attention_close(o.detach(), attention_qkv_reference(qkv, H))
    want = attention_qkv_bwd_reference(qkv, o.grad, H).float()
    tol = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
    err = (x.grad.float() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


def test_bwd_kernel_rejects_what_it_does_not_take(cuda):
    qkv = torch.zeros(1, 4, 24, device=cuda)
    with pytest.raises(ValueError):
        fused_attention_qkv_bwd(qkv, torch.zeros(1, 4, 6, device=cuda), 2)
    with pytest.raises(ValueError):
        fused_attention_qkv_bwd(qkv, torch.zeros(1, 4, 8, device=cuda, dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError):
        fused_attention_qkv_bwd(qkv, torch.zeros(1, 8, 4, device=cuda).transpose(1, 2), 2)
    with pytest.raises(ValueError):
        fused_attention_qkv_bwd(qkv, torch.zeros(1, 4, 8), 2)


def test_denoiser_on_card_matches_cpu(cuda):
    kw = dict(
        backbone=BackboneConfig(d_model=116, nhead=2, dim_feedforward=64,
                                num_layers=2, timestep_type="adalayernorm",
                                diffusion_step=10),
        num_classes=30, max_token_length=25,
    )
    cpu = make_transformer("cpu", torch.Generator().manual_seed(5), **kw)
    gpu = make_transformer(cuda, torch.Generator().manual_seed(5), **kw)
    rs = np.random.RandomState(0)
    ids = torch.as_tensor(rs.randint(0, 30, (3, 25)))
    t = torch.as_tensor(rs.randint(0, 10, (3,)))
    with torch.inference_mode():
        want = cpu(ids, t)
        got = gpu(ids.to(cuda), t.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)


def test_row_noise_identical_on_card_and_cpu(cuda):
    """Integer hashing: a seed gives the same draws on either device, so a
    service's results do not depend on where it runs."""
    seeds = torch.tensor([0, 17, 2**32 - 1])
    want = row_uniform(seeds, 5, 4096)
    got = row_uniform(seeds.to(cuda), 5, 4096).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_generator_noise_lands_on_card(cuda):
    """A CPU generator's draws are the same whichever device takes them."""
    want = gumbel_noise(torch.Generator().manual_seed(3), (2, 25, 30))
    got = gumbel_noise(torch.Generator().manual_seed(3), (2, 25, 30), device=cuda)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gen_device", ["cpu", "cuda"])
def test_sample_with_generator_on_card(cuda, gen_device):
    """The whole-batch regime: a torch.Generator on either device drives a
    model on the card."""
    cfg = build_train_config("layoutdm", "synthetic", [
        "data.bbox_quantization=linear", "dataset.max_seq_length=5",
        "backbone.d_model=128", "backbone.nhead=2",
        "backbone.dim_feedforward=64", "backbone.num_layers=2",
        "model.num_timesteps=10", "backbone.diffusion_step=10",
    ])
    model = build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    runs = [
        model.sample_ids(torch.Generator(gen_device).manual_seed(1), 3)
        for _ in range(2)
    ]
    assert runs[0].device.type == "cuda" and runs[0].shape == (3, model.seq_len)
    assert ((runs[0] >= 0) & (runs[0] < model.num_classes)).all()
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


def test_train_step_on_card_matches_cpu(cuda):
    """One float32 train step (loss, K1/K2 backward, clip, AdamW) on the card
    against the same step on the CPU (plain versions), same weights and
    injected t, pt and x_t: losses, gradients and updated weights."""
    from layoutdm_tpu_torch.models.diffusion.loss import diffusion_loss
    from layoutdm_tpu_torch.train.step import init_train_state, make_optimizer, train_step

    cfg = build_train_config("layoutdm", "synthetic", [
        "data.bbox_quantization=linear", "dataset.max_seq_length=5",
        "backbone.d_model=128", "backbone.nhead=2",
        "backbone.dim_feedforward=64", "backbone.num_layers=2",
        "model.num_timesteps=10", "backbone.diffusion_step=10",
    ])
    rs = np.random.RandomState(4)
    B = 16
    n = rs.randint(1, 6, (B, 1))
    batch = {"label": rs.randint(0, 5, (B, 5)), "bbox": rs.rand(B, 5, 4).astype(np.float32),
             "mask": np.arange(5)[None] < n}
    t = torch.as_tensor(rs.randint(0, 10, B))
    pt = torch.as_tensor(rs.uniform(0.05, 0.2, B).astype(np.float32))
    states, out = [], []
    for dev in ("cpu", cuda):
        model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(2))
        seq = model.preprocess(batch)["seq"]
        xt = model.q.corrupt(seq, t.to(dev), torch.Generator().manual_seed(3))
        state = init_train_state(model, make_optimizer(model.net), 0.5)

        def loss_fn(lt, model=model, seq=seq, xt=xt, dev=dev):
            return diffusion_loss(
                model.q, model._predict_start, seq, lt, t=t.to(dev), pt=pt.to(dev), xt=xt
            )

        launches = attention.LAUNCHES_BWD
        out.append(train_step(state, None, loss_fn=loss_fn))
        grads = {k: p.grad.cpu() for k, p in model.net.named_parameters()}
        states.append((grads, {k: v.cpu() for k, v in model.net.state_dict().items()}))
    assert attention.LAUNCHES_BWD == launches + 2  # the card's step, 2 layers
    for k in out[0]:
        torch.testing.assert_close(out[1][k].cpu(), out[0][k], rtol=1e-4, atol=0)
    (g_cpu, w_cpu), (g_gpu, w_gpu) = states
    scale = max(g.abs().max().item() for g in g_cpu.values())
    assert max((g_gpu[k] - g_cpu[k]).abs().max().item() for k in g_cpu) <= 1e-4 * scale
    # Adam divides each gradient element by its own scale, so elements whose
    # true gradient is 0 (the key bias) move by float noise; compare the rest
    for k in w_cpu:
        live = g_cpu[k].abs() > 1e-3 * scale
        torch.testing.assert_close(w_gpu[k][live], w_cpu[k][live], rtol=0, atol=1e-5)


def _fused_tol(want):
    if want.dtype == torch.float32:
        return F32_TOL
    return FUSED_BF16_REL_TOL * max(1.0, want.float().abs().max().item())


def _ffn_params(rs, D, Fd, device, dtype):
    t = lambda a: torch.as_tensor(a.astype(np.float32))
    return {
        "ln_scale": t(1 + 0.1 * rs.randn(D)).to(device), "ln_bias": t(0.1 * rs.randn(D)).to(device),
        "w1": t(rs.randn(Fd, D) / np.sqrt(D)).to(device, dtype), "b1": t(0.1 * rs.randn(Fd)).to(device, dtype),
        "w2": t(rs.randn(D, Fd) / np.sqrt(Fd)).to(device, dtype), "b2": t(0.1 * rs.randn(D)).to(device, dtype),
    }


@pytest.mark.parametrize(
    "lead,D,Fd,dtype,act",
    [
        ((4, 125), 464, 1856, torch.float32, "relu"),
        ((4, 125), 464, 1856, torch.bfloat16, "relu"),
        ((21,), 464, 1856, torch.bfloat16, "gelu"),
        ((3, 25), 116, 58, torch.float32, "gelu2"),
        ((3, 25), 116, 58, torch.bfloat16, "gelu2"),
        ((1, 7), 512, 200, torch.bfloat16, "gelu"),
        # the bf16 wgmma body's edges: rows on both sides of its 64-row
        # tile, F not a multiple of its 32-column chunk, D = 512 (256
        # columns a warpgroup) and D <= 232 (the second warpgroup's columns
        # empty); D = 116 and F = 58 take the exact body (no 16-byte rows)
        ((63,), 464, 1856, torch.bfloat16, "relu"),
        ((64,), 464, 1856, torch.bfloat16, "gelu2"),
        ((65,), 464, 1856, torch.bfloat16, "gelu"),
        ((127,), 464, 1856, torch.bfloat16, "relu"),
        ((128,), 464, 1856, torch.bfloat16, "gelu"),
        ((129,), 464, 1856, torch.bfloat16, "gelu2"),
        ((130,), 464, 200, torch.bfloat16, "relu"),
        ((129,), 512, 1856, torch.bfloat16, "gelu"),
        ((75,), 120, 64, torch.bfloat16, "relu"),
        ((65,), 464, 200, torch.float32, "relu"),
    ],
)
def test_ffn_kernel_matches_plain_version(cuda, lead, D, Fd, dtype, act):
    rs = np.random.RandomState(3)
    p = _ffn_params(rs, D, Fd, cuda, dtype)
    x = torch.as_tensor((0.5 * rs.randn(*lead, D)).astype(np.float32)).to(cuda, dtype)
    before = ffn.LAUNCHES_FFN
    got = ffn.fused_ln_ffn_residual(x, **p, activation=act)
    torch.cuda.synchronize()
    assert ffn.LAUNCHES_FFN == before + 1
    want = ffn.ln_ffn_residual_reference(x, **p, activation=act)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=_fused_tol(want))


def test_ffn_kernel_rejects_what_it_does_not_take(cuda):
    rs = np.random.RandomState(4)
    p = _ffn_params(rs, 64, 32, cuda, torch.float32)
    with pytest.raises(TypeError):
        ffn.fused_ln_ffn_residual(torch.zeros(2, 64, device=cuda, dtype=torch.float16), **p,
                                  activation="relu")
    with pytest.raises(ValueError):
        ffn.fused_ln_ffn_residual(torch.zeros(64, 2, device=cuda).T, **p, activation="relu")
    big = _ffn_params(rs, 520, 32, cuda, torch.float32)
    with pytest.raises(ValueError):
        ffn.fused_ln_ffn_residual(torch.zeros(2, 520, device=cuda), **big, activation="relu")


def _block_params(rs, D, device, dtype, sharp=1.0):
    t = lambda a: torch.as_tensor(a.astype(np.float32)).to(device, dtype)
    w_qkv = rs.randn(3 * D, D) / np.sqrt(D)
    w_qkv[: 2 * D] *= sharp  # the rows of W_q and W_k
    return {"w_qkv": t(w_qkv), "b_qkv": t(0.1 * rs.randn(3 * D)),
            "w_out": t(rs.randn(D, D) / np.sqrt(D)), "b_out": t(0.1 * rs.randn(D))}


@pytest.mark.parametrize(
    "B,S,H,hd,dtype,sharp",
    [
        (2, 125, 8, 58, torch.float32, 1.0),
        (3, 125, 8, 58, torch.bfloat16, 1.0),
        (1, 500, 8, 58, torch.bfloat16, 1.0),
        (1, 500, 8, 58, torch.float32, 1.0),
        (2, 1, 2, 64, torch.float32, 1.0),
        (2, 33, 3, 40, torch.bfloat16, 1.0),
        (1, 70, 1, 5, torch.float32, 1.0),
        # the bf16 cluster body's edges: one block a head, 1 to 8 heads
        # (S = 1, 33), an odd head width (2-byte stores of o), and the
        # shapes it leaves to the tiled body: 12 heads, d_model not a
        # multiple of 8, S past 128
        (2, 1, 8, 58, torch.bfloat16, 1.0),
        (2, 33, 1, 64, torch.bfloat16, 1.0),
        (2, 100, 8, 57, torch.bfloat16, 1.0),
        (2, 64, 12, 40, torch.bfloat16, 1.0),
        (2, 50, 2, 58, torch.bfloat16, 1.0),
        (2, 128, 8, 58, torch.bfloat16, 1.0),
        # both sides of the 128 keys up to which the block keeps its
        # scores, and sharp scores (the rows of W_q and W_k scaled)
        (2, 127, 8, 58, torch.bfloat16, 1.0),
        (2, 128, 8, 58, torch.float32, 1.0),
        (2, 129, 8, 58, torch.bfloat16, 1.0),
        (2, 129, 8, 58, torch.float32, 1.0),
        (4, 125, 8, 58, torch.bfloat16, SHARP),
        (4, 129, 8, 58, torch.bfloat16, SHARP),
    ],
)
def test_block_kernel_matches_plain_version(cuda, B, S, H, hd, dtype, sharp):
    rs = np.random.RandomState(5)
    p = _block_params(rs, H * hd, cuda, dtype, sharp)
    x = torch.as_tensor((0.5 * rs.randn(B, S, H * hd)).astype(np.float32)).to(cuda, dtype)
    before = attention.LAUNCHES_BLOCK
    got = attention.fused_attention_block(x, **p, num_heads=H)
    torch.cuda.synchronize()
    assert attention.LAUNCHES_BLOCK == before + 1
    want = attention.attention_block_reference(x, **p, num_heads=H)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=_fused_tol(want))
    if dtype == torch.bfloat16:  # the normalised p rounded as the plain version rounds it
        diff = (got.float() - want.float()).abs()
        assert diff.mean() <= ATTN_BF16_MEAN_REL * want.float().abs().mean()


def test_block_kernel_rejects_what_it_does_not_take(cuda):
    rs = np.random.RandomState(6)
    p = _block_params(rs, 64, cuda, torch.float32)
    with pytest.raises(TypeError):
        attention.fused_attention_block(torch.zeros(1, 4, 64, device=cuda, dtype=torch.float16),
                                        **p, num_heads=2)
    with pytest.raises(ValueError):  # head dim 128 > the kernel's 64
        attention.fused_attention_block(torch.zeros(1, 4, 128, device=cuda),
                                        **_block_params(rs, 128, cuda, torch.float32), num_heads=1)
    with pytest.raises(ValueError):
        attention.fused_attention_block(torch.zeros(1, 64, 4, device=cuda).transpose(1, 2),
                                        **p, num_heads=2)


def test_fused_denoiser_on_card_matches_cpu(cuda):
    """The fused path (K4 + K3) on the card against the same weights on the
    CPU (plain versions), float32."""
    kw = dict(
        backbone=BackboneConfig(d_model=116, nhead=2, dim_feedforward=64,
                                num_layers=2, timestep_type="adalayernorm",
                                diffusion_step=10),
        num_classes=30, max_token_length=25, fused_block=True, fused_ffn=True,
    )
    cpu = make_transformer("cpu", torch.Generator().manual_seed(5), **kw)
    gpu = make_transformer(cuda, torch.Generator().manual_seed(5), **kw)
    rs = np.random.RandomState(0)
    ids = torch.as_tensor(rs.randint(0, 30, (3, 25)))
    t = torch.as_tensor(rs.randint(0, 10, (3,)))
    launches = attention.LAUNCHES_BLOCK, ffn.LAUNCHES_FFN
    with torch.inference_mode():
        want = cpu(ids, t)
        got = gpu(ids.to(cuda), t.to(cuda)).cpu()
    assert (attention.LAUNCHES_BLOCK, ffn.LAUNCHES_FFN) == (launches[0] + 2, launches[1] + 2)
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)


def _padded_slab(rs, B, S, H, hd, hp):
    x = np.zeros((B, S, 3, H, hp), np.float32)
    x[..., :hd] = rs.randn(B, S, 3, H, hd)
    return x.reshape(B, S, 3 * H * hp)


@pytest.mark.parametrize(
    "B,S,H,hd,hp,dtype,sharp",
    [
        (2, 125, 8, 58, 64, torch.float32, 1.0),
        (3, 125, 8, 58, 64, torch.bfloat16, 1.0),
        (1, 500, 8, 58, 64, torch.float32, 1.0),
        (2, 500, 8, 58, 64, torch.bfloat16, 1.0),
        (3, 21, 8, 64, 64, torch.float32, 1.0),
        (2, 21, 4, 100, 128, torch.bfloat16, 1.0),
        (4, 125, 8, 58, 64, torch.bfloat16, SHARP),
        (4, 129, 8, 58, 64, torch.bfloat16, SHARP),
    ] + BLOCKDIAG_EDGES,
)
def test_blockdiag_kernel_matches_plain_version(cuda, B, S, H, hd, hp, dtype, sharp):
    """K5 against its plain version; the padded output lanes exactly 0."""
    qkv = _padded_slab(np.random.RandomState(7), B, S, H, hd, hp)
    qkv.reshape(B, S, 3, H, hp)[:, :, :2] *= sharp  # q and k
    qkv = torch.as_tensor(qkv).to(cuda, dtype)
    scale = hd ** -0.5
    launches = attention_blockdiag.LAUNCHES_BLOCKDIAG
    got = attention_blockdiag.blockdiag_attention(qkv, H, hp, scale)
    torch.cuda.synchronize()
    assert attention_blockdiag.LAUNCHES_BLOCKDIAG == launches + 1
    want = attention_blockdiag.blockdiag_attention_reference(qkv, H, hp, scale)
    assert got.dtype == dtype and got.shape == (B, S, H * hp)
    _assert_attention_close(got, want)
    assert got.view(B, S, H, hp)[..., hd:].count_nonzero().item() == 0


def test_blockdiag_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError):  # head pad 96 is not one the kernel takes
        attention_blockdiag.blockdiag_attention(torch.zeros(1, 4, 3 * 96, device=cuda), 1, 96, 0.1)
    with pytest.raises(ValueError):  # over the score tile's sequence limit
        attention_blockdiag.blockdiag_attention(
            torch.zeros(1, attention_blockdiag.MAX_SEQ + 1, 192, device=cuda), 1, 64, 0.1)
    with pytest.raises(TypeError):
        attention_blockdiag.blockdiag_attention(
            torch.zeros(1, 4, 192, device=cuda, dtype=torch.float16), 1, 64, 0.1)
    with pytest.raises(ValueError):
        attention_blockdiag.blockdiag_attention(
            torch.zeros(1, 192, 4, device=cuda).transpose(1, 2), 1, 64, 0.1)


@pytest.mark.parametrize(
    "B,S,H,hd,dtype,sharp",
    [
        (2, 125, 8, 58, torch.float32, 1.0),
        (3, 125, 8, 58, torch.bfloat16, 1.0),
        (1, 500, 8, 58, torch.float32, 1.0),
        (2, 500, 8, 64, torch.bfloat16, 1.0),
        (5, 21, 4, 64, torch.float32, 1.0),
        (4, 21, 8, 58, torch.bfloat16, 1.0),
        # element copies (d_model 174, no 16-byte window), bias added
        (2, 65, 3, 58, torch.bfloat16, 1.0),
    ] + FWD_EDGES,
)
def test_smajor_kernel_matches_plain_version(cuda, B, S, H, hd, dtype, sharp):
    """K6 against its plain version on sequence-major slabs plus a bias."""
    rs = np.random.RandomState(8)
    qkv = rs.randn(S, B, 3 * H * hd).astype(np.float32)
    qkv[..., : 2 * H * hd] *= sharp  # q and k
    qkv = torch.as_tensor(qkv).to(cuda, dtype)
    bias = torch.as_tensor(0.5 * rs.randn(3 * H * hd).astype(np.float32)).to(cuda, dtype)
    launches = attention.LAUNCHES_SMAJOR
    got = attention.fused_attention_qkv_smajor(qkv, bias, H)
    torch.cuda.synchronize()
    assert attention.LAUNCHES_SMAJOR == launches + 1
    want = attention.attention_qkv_smajor_reference(qkv, bias, H)
    assert got.dtype == dtype and got.shape == (B, S, H * hd)
    _assert_attention_close(got, want)


@pytest.mark.parametrize("path", ["attn_v2", "smajor"])
def test_attention_path_denoiser_on_card_matches_cpu(cuda, path):
    """The V2 (K5) and S-major (K6) paths on the card against the same
    weights on the CPU (plain versions), float32."""
    kw = dict(
        backbone=BackboneConfig(d_model=116, nhead=2, dim_feedforward=64,
                                num_layers=2, timestep_type="adalayernorm",
                                diffusion_step=10),
        num_classes=30, max_token_length=25, **{path: True},
    )
    cpu = make_transformer("cpu", torch.Generator().manual_seed(5), **kw)
    gpu = make_transformer(cuda, torch.Generator().manual_seed(5), **kw)
    rs = np.random.RandomState(0)
    ids = torch.as_tensor(rs.randint(0, 30, (3, 25)))
    t = torch.as_tensor(rs.randint(0, 10, (3,)))
    counters = lambda: (attention.LAUNCHES, attention_blockdiag.LAUNCHES_BLOCKDIAG,
                        attention.LAUNCHES_SMAJOR)
    before = counters()
    with torch.inference_mode():
        want = cpu(ids, t)
        got = gpu(ids.to(cuda), t.to(cuda)).cpu()
    want_launches = (0, 2, 0) if path == "attn_v2" else (0, 0, 2)
    assert tuple(a - b for a, b in zip(counters(), before)) == want_launches
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)


def test_fidnet_on_card_matches_cpu(cuda):
    """FIDNetV3 at full width (d_model 256, 4 heads, 4 + 4 layers, max_bbox
    25) on padded rows, one with no element: features float32 without
    TF32, and the training heads, on the card against the CPU."""
    from layoutdm_tpu_torch.eval.fidnet import FIDNetV3, make_feature_extractor

    torch.manual_seed(0)
    cpu = FIDNetV3(7, max_bbox=25, device="cpu")
    gpu = FIDNetV3(7, max_bbox=25, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(0)
    bbox = rs.rand(64, 25, 4).astype(np.float32)
    label = rs.randint(0, 7, (64, 25))
    n = rs.randint(1, 26, (64, 1))
    n[-1] = 0
    mask = np.arange(25)[None] < n
    got = make_feature_extractor(gpu)(bbox, label, mask)
    assert got.is_cuda and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), make_feature_extractor(cpu)(bbox, label, mask),
                               rtol=0, atol=F32_TOL)
    args = (torch.as_tensor(bbox), torch.as_tensor(label), torch.as_tensor(~mask))
    with torch.no_grad():
        want = cpu(*args)
        heads = gpu(*(a.to(cuda) for a in args))
    for g, w in zip(heads, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=F32_TOL)
