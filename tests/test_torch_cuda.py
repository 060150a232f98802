"""The port on a CUDA card, and its one check there of each hand-written
kernel (K1 attention forward, K2 its backward, K3 LayerNorm-FFN-residual,
K4 attention block, K5 padded-head attention, K6 sequence-major attention,
the LayerNorm kernel in its adaLN norm1 and affine modes, the cached
decode's attention) and of the GEMM epilogues' cuBLASLt shim against its
plain version: at the tile edges, at the sampling cells' shapes and at every
family's widths.  Then the denoiser on every path, a train step and a
chain's launches, BART's cached decode at its published widths and its
launches, the per-row noise and the FIDNet feature extractor on the card
against the CPU.  Every test here is marked ``cuda`` and skips
without a card.  The tolerances and checkers are ``kernel_checks.py``'s.

This file imports no jax and nothing of the JAX package (as
the port does), so it also runs on a GPU host without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from kernel_checks import (
    DENOISER_PATHS,
    DENOISER_TOL,
    EPILOGUE_DENOISER_REL_TOL,
    F32_TOL,
    SHARP,
    adaln_errors,
    attention_errors,
    block_errors,
    bwd_errors,
    fused_errors,
    ln_errors,
    path_switches,
    relu_epilogue_errors,
    residual_epilogue_errors,
)
from layoutdm_tpu_torch.bench.headline import flagship_config
from layoutdm_tpu_torch.configs import build_train_config
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.models import nn as nn_mod
from layoutdm_tpu_torch.ops import (
    adaln,
    attention,
    attention_blockdiag,
    decode_attention,
    ffn,
    gemm_epilogue,
)
from layoutdm_tpu_torch.ops.attention import (
    attention_qkv_bwd_reference,
    attention_qkv_reference,
    fused_attention_qkv,
    fused_attention_qkv_bwd,
    fused_attention_qkv_diff,
)
from layoutdm_tpu_torch.ops.samplers import gumbel_noise, row_uniform

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
    (2, S, H, hd, hp, dtype, 1.0)
    for S in (1, 16, 64, 65, 127, 128, 129, 1024)
    for hd, hp in ((58, 64), (100, 128))
    for dtype in (torch.float32, torch.bfloat16)
    for H in (2, 8)
]
# K1's and K6's: one key, the 128-key chunk (two sweeps past it), the
# 128-query block, in both dtypes; and sharp scores on both sides of 128.
# In bf16 past 128 keys the long body: the keys split between its two
# warpgroups (128 each up to 256 keys, 256 up to 512), its 64-query tiles,
# its limit (512 keys at rows of 64) and the first S past it, heads it does
# not take (hd 96; hd 124 by element copies), element copies (odd hd,
# d_model 174), plain and sharp scores
FWD_EDGES = [
    (2, S, 8, 58, dtype, 1.0)
    for S in (1, 127, 128, 129)
    for dtype in (torch.float32, torch.bfloat16)
] + [(4, S, 8, 58, torch.bfloat16, SHARP) for S in (125, 129, 500)] + [
    (3, S, H, hd, torch.bfloat16, sharp)
    for S in (129, 192, 255, 256, 257, 384, 500, 512, 513)
    for H, hd in ((8, 58), (4, 64))
    for sharp in (1.0, SHARP)
] + [(2, S, 2, 124, torch.bfloat16, 1.0) for S in (129, 256, 257)] + [
    (2, S, 2, 5, torch.bfloat16, SHARP) for S in (300, 512, 513)
] + [(2, S, 2, 96, torch.bfloat16, 1.0) for S in (256, 257)] + [
    (2, S, 3, 58, torch.bfloat16, 1.0) for S in (300, 512)
] + [(2, S, 2, 57, torch.bfloat16, SHARP) for S in (129, 500)]
# the sampling cells' calls: a Rico25 step (B=1024, S=125) and a PubLayNet
# step (B=256, S=500), at the flagship's 8 heads of 58
CELL_SHAPES = [(1024, 125, 8, 58, torch.bfloat16, 1.0), (256, 500, 8, 58, torch.bfloat16, 1.0)]
# the small LayoutDM of the model-level tests: d_model 116 after its 29/32
# shrink, 2 heads of 58, FFN 58, 2 layers, T=10, 25 tokens (synthetic)
SMALL = ["data.bbox_quantization=linear", "dataset.max_seq_length=5",
         "backbone.d_model=128", "backbone.nhead=2", "backbone.dim_feedforward=64",
         "backbone.num_layers=2", "model.num_timesteps=10", "backbone.diffusion_step=10"]


def _id(v):
    """Parameter ids: dtypes by short names, shapes joined by x."""
    if isinstance(v, torch.dtype):
        return {torch.float32: "f32", torch.bfloat16: "bf16"}[v]
    if isinstance(v, tuple):
        return "x".join(map(str, v))
    return None


def _config(width, *overrides):
    """LayoutDM at the small widths (`SMALL`) or the flagship's (Rico25:
    125 tokens, d_model 464, 8 heads of 58, FFN 1856, 4 layers, T=100)."""
    if width == "flagship":
        return flagship_config(overrides=overrides)
    return build_train_config("layoutdm", "synthetic", [*SMALL, *overrides])


def _takes_long_body(S, hd, dtype):
    """The long body's rule: bf16, 128 < S <= 512, and a head that fits a
    row of 64 (a 16-byte window puts a slice up to 6 elements in)."""
    return dtype == torch.bfloat16 and 128 < S <= 512 and hd + (6 if hd % 8 else 0) <= 64


def _launches() -> dict:
    """The kernel wrappers' launch counters (``long``: K1 and K6 calls
    that took the long bf16 body; ``epilogue``: the GEMM epilogues' shim
    calls; ``decode``: the cached decode's attention)."""
    return {"K1": attention.LAUNCHES, "long": attention.LAUNCHES_LONG,
            "K2": attention.LAUNCHES_BWD, "K3": ffn.LAUNCHES_FFN,
            "K4": attention.LAUNCHES_BLOCK, "K5": attention_blockdiag.LAUNCHES_BLOCKDIAG,
            "K6": attention.LAUNCHES_SMAJOR, "adaLN": adaln.LAUNCHES_ADALN,
            "LN": adaln.LAUNCHES_LN, "epilogue": gemm_epilogue.LAUNCHES_EPILOGUE,
            "decode": decode_attention.LAUNCHES_DECODE_ATTN}


def _since(before: dict) -> dict:
    """The launches since ``before`` (`_launches`), by counter that moved."""
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in _launches().items() if v != before[k]}


def _assert_within(check, *args):
    """Assert a `kernel_checks` checker's verdict, its errors in the message."""
    *errors, ok = check(*args)
    assert ok, f"errors {errors}"


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
        (16, 125, 8, 64, torch.float32, 58 ** -0.5, 1.0),
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
    ] + [(B, S, H, hd, dtype, 0.0, sharp)
         for B, S, H, hd, dtype, sharp in FWD_EDGES + CELL_SHAPES],
    ids=_id,
)
def test_kernel_matches_plain_version(cuda, B, S, H, hd, dtype, scale, sharp):
    qkv = _slab(B, S, H, hd)
    qkv[..., : 2 * H * hd] *= sharp  # q and k
    qkv = torch.as_tensor(qkv).to(cuda, dtype)
    before = _launches()
    got = fused_attention_qkv(qkv, H, scale=scale)
    long_body = _takes_long_body(S, hd, dtype)
    assert attention.attention_fwd_long_body(S, hd, dtype) == long_body
    assert _since(before) == {"K1": 1, **({"long": 1} if long_body else {})}
    want = attention_qkv_reference(qkv, H, scale=scale)
    assert got.dtype == dtype and got.shape == (B, S, H * hd)
    _assert_within(attention_errors, got, want)


def test_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        fused_attention_qkv(torch.zeros(1, 4, 24, device=cuda, dtype=torch.float16), 2)
    with pytest.raises(ValueError):
        fused_attention_qkv(torch.zeros(1, 4, 3 * 2 * 129, device=cuda), 2)
    with pytest.raises(ValueError):
        fused_attention_qkv(torch.zeros(1, 48, 4, device=cuda).transpose(1, 2), 2)


@pytest.mark.parametrize("S", [125, 500])
def test_chain_launches_k1_and_its_long_body(cuda, S):
    """Over one bf16 chain K1 launches once a layer and step, and the long
    body (128 < S <= 512) takes every one of those launches at S = 500
    (PubLayNet's length) and none at S = 125 (Rico25's)."""
    cfg = _config("small", f"dataset.max_seq_length={S // 5}", "model.dtype=bfloat16")
    model = build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(7))
    assert model.seq_len == S
    steps = cfg.backbone.num_layers * model.q.num_timesteps
    before = _launches()
    model.sample_ids(torch.Generator(cuda).manual_seed(8), 2)
    got = _since(before)
    assert (got["K1"], got.get("long", 0)) == (steps, steps * (S > 128)), got


@pytest.mark.parametrize(
    "B,S,H,hd,dtype,scale",
    [
        (4, 125, 8, 58, torch.float32, 0.0),
        (4, 125, 8, 58, torch.bfloat16, 0.0),
        (2, 500, 8, 58, torch.float32, 0.0),
        (2, 500, 8, 58, torch.bfloat16, 0.0),
        (3, 1, 2, 128, torch.float32, 0.0),
        (2, 33, 3, 64, torch.bfloat16, 58 ** -0.5),
        (16, 125, 8, 64, torch.float32, 58 ** -0.5),
        (1, 70, 1, 5, torch.float32, 0.0),
    ] + BWD_EDGES,
    ids=_id,
)
def test_bwd_kernel_matches_plain_version(cuda, B, S, H, hd, dtype, scale):
    qkv = torch.as_tensor(_slab(B, S, H, hd)).to(cuda, dtype)
    do = torch.as_tensor(
        np.random.RandomState(1).randn(B, S, H * hd).astype(np.float32)
    ).to(cuda, dtype)
    before = _launches()
    got = fused_attention_qkv_bwd(qkv, do, H, scale=scale)
    assert _since(before) == {"K2": 1}
    assert got.dtype == dtype
    _assert_within(bwd_errors, got, attention_qkv_bwd_reference(qkv, do, H, scale=scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=_id)
def test_autograd_function_on_card_matches_plain_version(cuda, dtype):
    """Through autograd the forward is K1 and the gradient K2 of the saved
    slab and the output's cotangent: both against the twins on the card."""
    B, S, H, hd = 3, 125, 8, 58
    rs = np.random.RandomState(2)
    qkv = torch.as_tensor(rs.randn(B, S, 3 * H * hd).astype(np.float32)).to(cuda, dtype)
    w = torch.as_tensor(rs.randn(H * hd, H * hd).astype(np.float32) * 0.05).to(cuda, dtype)
    x = qkv.clone().requires_grad_()
    before = _launches()
    o = fused_attention_qkv_diff(x, H)
    o.retain_grad()
    (o @ w).float().square().sum().backward()
    assert _since(before) == {"K1": 1, "K2": 1}
    _assert_within(attention_errors, o.detach(), attention_qkv_reference(qkv, H))
    _assert_within(bwd_errors, x.grad, attention_qkv_bwd_reference(qkv, o.grad, H))


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


@pytest.mark.parametrize("width", ["small", "flagship"])
@pytest.mark.parametrize("path", list(DENOISER_PATHS))
def test_denoiser_on_card_matches_cpu(cuda, path, width):
    """A float32 LayoutDM denoiser on one path (default: K1; fused: K4 + K3;
    attn_v2: K5; smajor: K6) on the card against the same weights on the
    CPU (plain versions): logits at random steps, and the posteriors at
    steps across the schedule.  A forward launches the path's kernels, the
    adaLN norm1 and the affine norms (each layer's norm2 but where K3 takes
    it, and the head's) once a layer, and no other kernel."""
    kernels = DENOISER_PATHS[path][1]
    cfg = _config(width, "model.dtype=float32")
    cpu, gpu = (build_model(cfg, device=d, generator=torch.Generator().manual_seed(5),
                            **path_switches(path))
                for d in ("cpu", cuda))
    layers, T = cfg.backbone.num_layers, cpu.q.num_timesteps
    tol = F32_TOL if width == "small" else DENOISER_TOL
    rs = np.random.RandomState(0)
    ids = torch.as_tensor(rs.randint(0, cpu.num_classes, (8, cpu.seq_len)))
    t = torch.as_tensor(rs.randint(0, T, (8,)))
    with torch.inference_mode():
        want = cpu.net(ids, t)
        before = _launches()
        got = gpu.net(ids.to(cuda), t.to(cuda)).cpu()
        launches = _since(before)
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
        for step in (T - 1, 3 * T // 4, T // 2, T // 4, 0):
            posterior = []
            for m, dev in ((cpu, "cpu"), (gpu, cuda)):
                ts, x = torch.full((8,), step, device=dev), ids.to(dev)
                posterior.append(m.q.q_posterior_ids(m._predict_start(x, ts), x, ts).cpu())
            torch.testing.assert_close(posterior[1], posterior[0], rtol=0, atol=tol)
    assert launches == {**{k: layers for k in kernels}, "adaLN": layers,
                        "LN": layers * (path != "fused") + 1}


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
    model = build_model(_config("small"), device=cuda, generator=torch.Generator().manual_seed(0))
    runs = [
        model.sample_ids(torch.Generator(gen_device).manual_seed(1), 3)
        for _ in range(2)
    ]
    assert runs[0].device.type == "cuda" and runs[0].shape == (3, model.seq_len)
    assert ((runs[0] >= 0) & (runs[0] < model.num_classes)).all()
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


@pytest.mark.parametrize("width", ["small", "flagship"])
def test_train_step_on_card_matches_cpu(cuda, width):
    """One float32 train step (loss, K1/K2 backward, clip, AdamW) on the card
    against the same step on the CPU (plain versions), same weights and
    injected t, pt and x_t: losses, gradients and updated weights."""
    from layoutdm_tpu_torch.models.diffusion.loss import diffusion_loss
    from layoutdm_tpu_torch.train.step import init_train_state, make_optimizer, train_step

    cfg = _config(width, "model.dtype=float32")
    E, layers = cfg.dataset.max_seq_length, cfg.backbone.num_layers
    rs = np.random.RandomState(4)
    B = 16
    n = rs.randint(1, E + 1, (B, 1))
    batch = {"label": rs.randint(0, 5, (B, E)), "bbox": rs.rand(B, E, 4).astype(np.float32),
             "mask": np.arange(E)[None] < n}
    t = torch.as_tensor(rs.randint(0, cfg.model.num_timesteps, B))
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
    assert attention.LAUNCHES_BWD == launches + layers  # the card's step
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
        ((21,), 464, 1856, torch.bfloat16, "relu"),
        ((21,), 464, 1856, torch.float32, "gelu2"),
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
        ((129,), 512, 1856, torch.bfloat16, "gelu2"),
        ((75,), 120, 64, torch.bfloat16, "relu"),
        ((65,), 464, 200, torch.float32, "relu"),
        # MaskGIT's FFN (the zoo's width) at the zoo's batch of 256 rows of
        # 125 tokens
        ((256, 125), 512, 2048, torch.bfloat16, "relu"),
    ] + [((m,), 464, 1856, torch.bfloat16, "gelu") for m in (63, 64, 127, 129)] + [
        ((8, 125), 464, 1856, dtype, act)
        for dtype in (torch.float32, torch.bfloat16) for act in ("relu", "gelu", "gelu2")
    ],
    ids=_id,
)
def test_ffn_kernel_matches_plain_version(cuda, lead, D, Fd, dtype, act):
    rs = np.random.RandomState(3)
    p = _ffn_params(rs, D, Fd, cuda, dtype)
    x = torch.as_tensor((0.5 * rs.randn(*lead, D)).astype(np.float32)).to(cuda, dtype)
    before = _launches()
    got = ffn.fused_ln_ffn_residual(x, **p, activation=act)
    assert _since(before) == {"K3": 1}
    _assert_within(fused_errors, got, ffn.ln_ffn_residual_reference(x, **p, activation=act))


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



ADALN_CASES = [
    (1024, 125, 464, torch.bfloat16),  # a Rico25 cell's step
    (256, 500, 464, torch.bfloat16),   # a PubLayNet cell's step
    (8, 125, 464, torch.float32),
    (3, 7, 464, torch.bfloat16),       # 21 rows: a block of 8 rows cut short
    (3, 7, 464, torch.float32),
    (4, 33, 64, torch.bfloat16),
    (4, 33, 1024, torch.bfloat16),     # the gate's widest
    (4, 33, 1024, torch.float32),
]


def _adaln_inputs(B, S, D, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn((B, S, D), generator=g) + 0.3).to(device, dtype)
    cond = (0.5 * torch.randn((B, 2 * D), generator=g)).to(device)
    return x, cond


@pytest.mark.parametrize("B,S,D,dtype", ADALN_CASES, ids=_id)
def test_adaln_kernel_matches_plain_version(cuda, B, S, D, dtype):
    x, cond = _adaln_inputs(B, S, D, dtype, cuda)
    before = _launches()
    got = adaln.ada_layer_norm(x, cond)
    assert _since(before) == {"adaLN": 1}
    _assert_within(adaln_errors, got, x, cond)


def test_adaln_kernel_rejects_what_it_does_not_take(cuda):
    from layoutdm_tpu_torch.ops.adaln import ada_layer_norm

    x, cond = _adaln_inputs(2, 5, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError):  # no whole bf16 vectors
        ada_layer_norm(x[..., :60], cond[:, :120])
    with pytest.raises(ValueError):  # wider than the gate
        ada_layer_norm(torch.zeros(2, 5, 1032, device=cuda, dtype=torch.bfloat16),
                       torch.zeros(2, 2064, device=cuda))
    with pytest.raises(ValueError):
        ada_layer_norm(x.transpose(0, 1).contiguous().transpose(0, 1), cond)
    with pytest.raises(ValueError):
        ada_layer_norm(x, cond.cpu())
    with pytest.raises(TypeError):
        ada_layer_norm(x, cond.to(torch.bfloat16))


def test_adaln_kernel_runs_on_the_sampling_chain(cuda):
    """A chain launches the adaLN mode once a layer and step, the affine
    mode once a layer (norm2) and once for the head a step; a forward under
    autograd takes the plain versions."""
    # d_model 232 after LayoutDM's 29/32 shrink: whole bf16 vectors
    cfg = _config("small", "backbone.d_model=256", "backbone.nhead=4", "model.dtype=bfloat16")
    model = build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    before, before_ln = adaln.LAUNCHES_ADALN, adaln.LAUNCHES_LN
    ids = model.sample_ids(torch.Generator(cuda).manual_seed(1), 3)
    torch.cuda.synchronize()
    assert adaln.LAUNCHES_ADALN == before + 2 * 10
    assert adaln.LAUNCHES_LN == before_ln + (2 + 1) * 10
    logits = model.net(ids.clone(), torch.full((3,), 4, device=cuda))
    logits.float().sum().backward()
    assert adaln.LAUNCHES_ADALN == before + 2 * 10
    assert adaln.LAUNCHES_LN == before_ln + (2 + 1) * 10



LN_CASES = [
    (128000, 464, torch.bfloat16, torch.bfloat16),  # a sampling cell's norm2
    (128000, 464, torch.bfloat16, torch.float32),   # its head's norm
    (1000, 464, torch.float32, torch.float32),
    (21, 464, torch.bfloat16, torch.bfloat16),      # a block of 8 rows cut short
    (132, 64, torch.bfloat16, torch.bfloat16),
    (132, 64, torch.bfloat16, torch.float32),
    (132, 64, torch.float32, torch.float32),
    (33, 1024, torch.bfloat16, torch.float32),      # the gate's widest
    (33, 1024, torch.float32, torch.float32),
]


def _ln_inputs(rows, D, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn((rows, D), generator=g) + 0.3).to(device, dtype)
    w = (1 + 0.3 * torch.randn(D, generator=g)).to(device)
    b = (0.5 * torch.randn(D, generator=g)).to(device)
    return x, w, b


@pytest.mark.parametrize("rows,D,dtype,out_dtype", LN_CASES, ids=_id)
def test_ln_kernel_matches_plain_version(cuda, rows, D, dtype, out_dtype):
    x, w, b = _ln_inputs(rows, D, dtype, cuda)
    before = _launches()
    got = adaln.layer_norm(x, w, b, out_dtype)
    assert _since(before) == {"LN": 1}
    _assert_within(ln_errors, got, x, w, b, out_dtype)


def test_ln_kernel_rejects_what_it_does_not_take(cuda):
    from layoutdm_tpu_torch.ops.adaln import layer_norm

    bf16 = torch.bfloat16
    x, w, b = _ln_inputs(10, 64, bf16, cuda)
    with pytest.raises(ValueError):  # no whole bf16 vectors
        layer_norm(x[:, :60].contiguous(), w[:60], b[:60], bf16)
    with pytest.raises(ValueError):  # no call site narrows float32
        layer_norm(x.float(), w, b, bf16)
    with pytest.raises(ValueError):
        layer_norm(x.T.contiguous().T, w, b, bf16)
    with pytest.raises(ValueError):
        layer_norm(x, w.cpu(), b, bf16)
    with pytest.raises(TypeError):
        layer_norm(x, w.to(bf16), b, bf16)


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
        (4, 33, 8, 58, torch.bfloat16, 1.0),
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
    ids=_id,
)
def test_block_kernel_matches_plain_version(cuda, B, S, H, hd, dtype, sharp):
    rs = np.random.RandomState(5)
    p = _block_params(rs, H * hd, cuda, dtype, sharp)
    x = torch.as_tensor((0.5 * rs.randn(B, S, H * hd)).astype(np.float32)).to(cuda, dtype)
    before = _launches()
    got = attention.fused_attention_block(x, **p, num_heads=H)
    assert _since(before) == {"K4": 1}
    _assert_within(block_errors, got, attention.attention_block_reference(x, **p, num_heads=H))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=_id)
@pytest.mark.parametrize("B,S,H,hd,Fd", [
    (8, 126, 8, 42, 1344),  # BART: d_model 336, 126 tokens with BOS
    (16, 25, 8, 54, 1728),  # the aggregated LayoutDM: d_model 432 over 25 elements
    (256, 126, 8, 42, 1344),  # both at the zoo's batch
    (256, 25, 8, 54, 1728),
])
def test_kernels_at_the_new_families_widths(cuda, B, S, H, hd, Fd, dtype):
    """K1-K6 at head widths 42 (84-byte bf16 heads, 4-byte aligned) and 54,
    and at FFN widths (336, 1344) and (432, 1728), against their plain
    versions (K2 trains the aggregated LayoutDM; BART's training takes the
    plain path, its width is held all the same); K5's heads padded to 64,
    its padded output lanes exactly 0."""
    D = H * hd
    rs = np.random.RandomState(7)
    qkv = torch.as_tensor(_slab(B, S, H, hd, seed=7)).to(cuda, dtype)
    before = _launches()
    _assert_within(attention_errors, fused_attention_qkv(qkv, H), attention_qkv_reference(qkv, H))
    x = torch.as_tensor((0.5 * rs.randn(B, S, D)).astype(np.float32)).to(cuda, dtype)
    p = _ffn_params(rs, D, Fd, cuda, dtype)
    _assert_within(fused_errors, ffn.fused_ln_ffn_residual(x, **p, activation="relu"),
                        ffn.ln_ffn_residual_reference(x, **p, activation="relu"))
    p = _block_params(rs, D, cuda, dtype)
    _assert_within(block_errors, attention.fused_attention_block(x, **p, num_heads=H),
                        attention.attention_block_reference(x, **p, num_heads=H))
    do = torch.as_tensor(rs.randn(B, S, D).astype(np.float32)).to(cuda, dtype)
    _assert_within(bwd_errors, fused_attention_qkv_bwd(qkv, do, H),
                   attention_qkv_bwd_reference(qkv, do, H))
    hp = attention_blockdiag.padded_head_dim(hd)
    pad = torch.as_tensor(_padded_slab(rs, B, S, H, hd, hp)).to(cuda, dtype)
    got = attention_blockdiag.blockdiag_attention(pad, H, hp, hd ** -0.5)
    _assert_within(attention_errors, got, attention_blockdiag.blockdiag_attention_reference(
        pad, H, hp, hd ** -0.5))
    assert got.view(B, S, H, hp)[..., hd:].count_nonzero().item() == 0
    sb = qkv.transpose(0, 1).contiguous()
    bias = torch.as_tensor(0.5 * rs.randn(3 * D).astype(np.float32)).to(cuda, dtype)
    _assert_within(attention_errors, attention.fused_attention_qkv_smajor(sb, bias, H),
                            attention.attention_qkv_smajor_reference(sb, bias, H))
    assert _since(before) == {k: 1 for k in ("K1", "K2", "K3", "K4", "K5", "K6")}


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
        (5, 21, 8, 58, 64, torch.bfloat16, 1.0),
        (2, 21, 4, 100, 128, torch.bfloat16, 1.0),
        (4, 125, 8, 58, 64, torch.bfloat16, SHARP),
        (4, 129, 8, 58, 64, torch.bfloat16, SHARP),
    ] + BLOCKDIAG_EDGES,
    ids=_id,
)
def test_blockdiag_kernel_matches_plain_version(cuda, B, S, H, hd, hp, dtype, sharp):
    """K5 against its plain version; the padded output lanes exactly 0."""
    qkv = _padded_slab(np.random.RandomState(7), B, S, H, hd, hp)
    qkv.reshape(B, S, 3, H, hp)[:, :, :2] *= sharp  # q and k
    qkv = torch.as_tensor(qkv).to(cuda, dtype)
    scale = hd ** -0.5
    before = _launches()
    got = attention_blockdiag.blockdiag_attention(qkv, H, hp, scale)
    assert _since(before) == {"K5": 1}
    want = attention_blockdiag.blockdiag_attention_reference(qkv, H, hp, scale)
    assert got.dtype == dtype and got.shape == (B, S, H * hp)
    _assert_within(attention_errors, got, want)
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
        (16, 125, 4, 64, torch.bfloat16, 1.0),
        (5, 21, 4, 64, torch.float32, 1.0),
        (4, 21, 8, 58, torch.bfloat16, 1.0),
        # element copies (d_model 174, no 16-byte window), bias added
        (2, 65, 3, 58, torch.bfloat16, 1.0),
    ] + FWD_EDGES + CELL_SHAPES,
    ids=_id,
)
def test_smajor_kernel_matches_plain_version(cuda, B, S, H, hd, dtype, sharp):
    """K6 against its plain version on sequence-major slabs plus a bias."""
    rs = np.random.RandomState(8)
    qkv = rs.randn(S, B, 3 * H * hd).astype(np.float32)
    qkv[..., : 2 * H * hd] *= sharp  # q and k
    qkv = torch.as_tensor(qkv).to(cuda, dtype)
    bias = torch.as_tensor(0.5 * rs.randn(3 * H * hd).astype(np.float32)).to(cuda, dtype)
    before = _launches()
    got = attention.fused_attention_qkv_smajor(qkv, bias, H)
    assert _since(before) == {"K6": 1, **({"long": 1} if _takes_long_body(S, hd, dtype) else {})}
    want = attention.attention_qkv_smajor_reference(qkv, bias, H)
    assert got.dtype == dtype and got.shape == (B, S, H * hd)
    _assert_within(attention_errors, got, want)


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


# the GEMM epilogues' calls (M, K, N, bias): the sampling cells' (128,000
# tokens a step through linear1, linear2 and the out projection), one row,
# rows that fill no tile, a zero bias
EPILOGUE_CASES = [(128_000, K, N, "random") for K, N in ((464, 1856), (1856, 464), (464, 464))] + [
    (M, K, N, "random") for M in (1, 1000 * 5 + 3) for K, N in ((464, 1856), (1856, 464))
] + [(1000 * 5 + 3, 464, 464, "zero")]


@pytest.mark.parametrize("epilogue", ["relu", "residual"])
@pytest.mark.parametrize("M,K,N,bias", EPILOGUE_CASES, ids=_id)
def test_gemm_epilogue_matches_its_eager_pair(cuda, M, K, N, bias, epilogue):
    """ReLU + bias against the eager F.linear + F.relu, within a bf16 step;
    the residual against the float32 sum, rounded once; one shim call, and
    no input written (the residual is the GEMM's C, the output a new
    tensor)."""
    g = torch.Generator(cuda).manual_seed(M + K + N)
    randn = lambda *shape, scale=1.0: (  # noqa: E731
        torch.randn(shape, generator=g, device=cuda) * scale).to(torch.bfloat16)
    x, w, r = randn(M, K), randn(N, K, scale=K ** -0.5), randn(M, N, scale=0.5)
    b = randn(N, scale=0.1) if bias == "random" else torch.zeros(N, device=cuda,
                                                                   dtype=torch.bfloat16)
    inputs = [t.clone() for t in (x, w, b, r)]
    before = _launches()
    if epilogue == "relu":
        got = gemm_epilogue.linear_relu(x, w, b)
        check = relu_epilogue_errors, got, torch.nn.functional.relu(
            torch.nn.functional.linear(x, w, b))
    else:
        got = gemm_epilogue.linear_residual(x, w, b, r)
        check = residual_epilogue_errors, got, (
            torch.nn.functional.linear(x.float(), w.float(), b.float()) + r.float())
    assert _since(before) == {"epilogue": 1}
    assert all(torch.equal(a, t) for a, t in zip(inputs, (x, w, b, r)))
    assert got.data_ptr() not in {t.data_ptr() for t in (x, w, b, r)}
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    _assert_within(*check)


def test_gemm_epilogue_rejects_what_it_does_not_take(cuda):
    bf16 = torch.bfloat16
    x, w, b = (torch.zeros(s, device=cuda, dtype=bf16) for s in ((4, 16), (8, 16), (8,)))
    with pytest.raises(TypeError):
        gemm_epilogue.linear_relu(x.float(), w.float(), b.float())
    with pytest.raises(ValueError):  # K not a multiple of 8
        gemm_epilogue.linear_relu(x[:, :12].contiguous(), w[:, :12].contiguous(), b)
    with pytest.raises(ValueError):
        gemm_epilogue.linear_relu(torch.zeros(16, 4, device=cuda, dtype=bf16).t(), w, b)
    with pytest.raises(ValueError):
        gemm_epilogue.linear_residual(x, w, b, torch.zeros(4, 4, device=cuda, dtype=bf16))
    with pytest.raises(ValueError):
        gemm_epilogue.linear_relu(x, w, b.cpu())


def test_gemm_epilogue_shares_torchs_cublaslt(cuda):
    """The shim calls the libcublasLt that torch loaded: the process maps
    one copy."""
    x = torch.ones(16, 16, device=cuda, dtype=torch.bfloat16)
    gemm_epilogue.linear_relu(x, x, x[0])
    torch.cuda.synchronize()
    assert len(gemm_epilogue.loaded_cublaslt()) == 1, gemm_epilogue.loaded_cublaslt()


@pytest.mark.parametrize("width", ["small", "flagship"])
def test_denoiser_epilogues_match_the_eager_forward(cuda, width, monkeypatch):
    """A bf16 denoiser on the default path takes the epilogues in every
    layer (3 shim calls a layer), and its logits are held to the same
    model's forward with the epilogue gate off (the eager ReLU and adds):
    within EPILOGUE_DENOISER_REL_TOL of the largest logit of the float32
    forward of the same weights, and no farther from that forward on average
    (each residual sum rounded once, not twice: H100, the mean error falls
    3-6%)."""
    # the small width at d_model 232 and FFN 232 after the 29/32 shrink: whole
    # bf16 vectors, as the shim and the LayerNorm kernel take them
    wide = ("backbone.d_model=256", "backbone.nhead=4", "backbone.dim_feedforward=256")
    over = wide if width == "small" else ()
    cfg = _config(width, *over, "model.dtype=bfloat16")
    model = build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(5))
    f32 = build_model(_config(width, *over, "model.dtype=float32"), device=cuda,
                      generator=torch.Generator().manual_seed(6))
    f32.net.load_state_dict(model.net.state_dict())
    layers, T = cfg.backbone.num_layers, model.q.num_timesteps
    rs = np.random.RandomState(0)
    ids = torch.as_tensor(rs.randint(0, model.num_classes, (8, model.seq_len))).to(cuda)
    t = torch.as_tensor(rs.randint(0, T, (8,))).to(cuda)
    with torch.inference_mode():
        want32 = f32.net(ids, t)
        before = _launches()
        got = model.net(ids, t)
        assert _since(before) == {"K1": layers, "adaLN": layers, "LN": layers + 1,
                                  "epilogue": 3 * layers}
        monkeypatch.setattr(nn_mod, "takes_gemm_epilogue", lambda *a, **k: False)
        before = _launches()
        eager = model.net(ids, t)
        assert _since(before) == {"K1": layers, "adaLN": layers, "LN": layers + 1}
    gap = (got - eager).abs().max().item()
    tol = EPILOGUE_DENOISER_REL_TOL * want32.abs().max().item()
    got_mean, eager_mean = ((v - want32).abs().mean().item() for v in (got, eager))
    assert gap <= tol and got_mean <= eager_mean, (gap, tol, got_mean, eager_mean)


def test_epilogue_launches_on_a_chain_and_none_in_training(cuda):
    """One bf16 chain of the flagship (4 layers, T=100) calls the shim 1,200
    times (3 a layer and step); a train step under autograd none."""
    from layoutdm_tpu_torch.train.step import init_train_state, make_optimizer, train_step

    cfg = _config("flagship")
    model = build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(3))
    before = gemm_epilogue.LAUNCHES_EPILOGUE
    model.sample_ids(torch.Generator(cuda).manual_seed(4), 2)
    torch.cuda.synchronize()
    assert gemm_epilogue.LAUNCHES_EPILOGUE - before == 3 * 4 * 100 == 1200
    E = cfg.dataset.max_seq_length
    rs = np.random.RandomState(4)
    batch = {"label": rs.randint(0, 5, (4, E)), "bbox": rs.rand(4, E, 4).astype(np.float32),
             "mask": np.arange(E)[None] < rs.randint(1, E + 1, (4, 1))}
    state = init_train_state(model, make_optimizer(model.net), 1.0)
    before = _launches()
    train_step(state, model.preprocess(batch), torch.Generator(cuda).manual_seed(5))
    launches = _since(before)
    assert launches.get("K2") == 4 and "epilogue" not in launches, launches


def test_bart_cached_decode_on_card_matches_cpu(cuda):
    """BART at Rico25's published widths (d_model 336, 8 heads of 42, FFN
    1,344, 4 + 4 layers, 126 positions, vocabulary 61) in float32 on the
    card (the encoder on K1, the LayerNorm kernel in the decoder) against
    the same weights on the CPU, at a small batch: each cached decode
    step's logits, the encoder's memory through the cross keys and values
    included, within DENOISER_TOL."""
    cfg = build_train_config("bart", "rico25", ["data.bbox_quantization=linear",
                                                "model.dtype=float32"])
    cpu, gpu = (build_model(cfg, device=d, generator=torch.Generator().manual_seed(7))
                for d in ("cpu", cuda))
    assert (gpu.backbone_cfg.d_model, gpu.backbone_cfg.dim_feedforward, gpu.num_classes,
            gpu.seq_len) == (336, 1344, 61, 126)
    rs = np.random.RandomState(1)
    enc, dec = (torch.as_tensor(rs.randint(0, cpu.num_classes, (4, cpu.seq_len)))
                for _ in range(2))
    dec[:, 0] = cpu.bos_id
    logits = []
    with torch.inference_mode():
        for model, dev in ((cpu, "cpu"), (gpu, cuda)):
            cache = model.net.new_cache(4, model.net(enc.to(dev), None))
            logits.append(torch.cat([model.net.decode_step(dec[:, i:i + 1].to(dev), cache)
                                     for i in range(cpu.seq_len)], 1).cpu())
    torch.testing.assert_close(logits[1], logits[0], rtol=0, atol=DENOISER_TOL)


# the cached decode's attention: BART's widths (8 heads of 42: a 672-byte
# row, one head 84 bytes) and LayoutTransformer's (8 of 64), one position to
# the 126 of both models' caches (the chunk edges at 32 rows a ring stage:
# 1, 2, 63, 126), both calls: self-attention (this step's k and v written
# into (B, 126, H, hd) caches at n - 1) and cross-attention (keys and values
# read in place from the packed (B, n, 2, H, hd) projection); and sharp
# scores at BART's full length
DECODE_CASES = [
    (300, n, H, hd, dtype, mode, 1.0)
    for H, hd in ((8, 42), (8, 64))
    for n in (1, 2, 63, 126)
    for dtype in (torch.float32, torch.bfloat16)
    for mode in ("self", "cross")
] + [(300, 126, 8, 42, torch.bfloat16, mode, SHARP) for mode in ("self", "cross")]


def _decode_inputs(B, n, H, hd, dtype, device, mode, sharp=1.0, seed=0):
    """q and this step's k and v as views of a (B, 1, 3, H, hd) projection;
    self-attention caches of 126 positions, or cross keys and values as
    views of a (B, n, 2, H, hd) one.  Returns q, [keys, values], new."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, 1, 3, H, hd), generator=g)
    qkv[:, :, :2] *= sharp
    q, k, v = qkv.to(device, dtype).unbind(2)
    if mode == "self":
        caches = [(torch.randn((B, 126, H, hd), generator=g) * s).to(device, dtype)
                  for s in (sharp, 1.0)]
        return q, caches, (k, v)
    kv = torch.randn((B, n, 2, H, hd), generator=g)
    kv[:, :, 0] *= sharp
    return q, list(kv.to(device, dtype).unbind(2)), None


@pytest.mark.parametrize("B,n,H,hd,dtype,mode,sharp", DECODE_CASES, ids=_id)
def test_decode_attention_kernel_matches_plain_version(cuda, B, n, H, hd, dtype, mode, sharp):
    q, kv, new = _decode_inputs(B, n, H, hd, dtype, cuda, mode, sharp)
    mine = [t.clone() for t in kv] if mode == "self" else kv
    before = _launches()
    got = decode_attention.decode_attention(q, *mine, n, new)
    assert _since(before) == {"decode": 1}
    want = decode_attention.decode_attention_reference(q, *kv, n, new)
    # the self call's cache write is a copy: the caches equal the plain
    # version's bit for bit (position n - 1 written, nothing else touched)
    assert all(torch.equal(a, b) for a, b in zip(mine, kv))
    assert got.dtype == dtype and got.shape == (B, 1, H * hd)
    _assert_within(attention_errors, got, want)


def test_decode_attention_kernel_rejects_what_it_does_not_take(cuda):
    call = decode_attention.decode_attention
    q, kv, new = _decode_inputs(4, 8, 8, 42, torch.bfloat16, cuda, "self")
    with pytest.raises(ValueError):  # float16
        call(q.half(), *(t.half() for t in kv), 8)
    with pytest.raises(ValueError):  # an odd head width
        call(torch.zeros((4, 1, 8, 41), device=cuda), *(torch.zeros((4, 8, 8, 41), device=cuda)
                                                        for _ in range(2)), 8)
    with pytest.raises(ValueError):  # more heads than the gate takes
        call(torch.zeros((4, 1, 17, 8), device=cuda), *(torch.zeros((4, 8, 17, 8), device=cuda)
                                                        for _ in range(2)), 8)
    flat = torch.zeros(4 * 126 * 336 + 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # caches two bytes off 16-byte alignment
        call(q, flat[1:1 + 4 * 126 * 336].view(4, 126, 8, 42), kv[1], 8, new)
    rows = flat[:4 * 8 * 337].view(4, 8, 337)[..., :336].view(4, 8, 8, 42)
    with pytest.raises(ValueError):  # positions not 16-byte aligned apart
        call(q, rows, rows, 8)
    with pytest.raises(ValueError):  # keys and values of other lengths
        call(q, kv[0], kv[1][:, :8], 8)
    with pytest.raises(ValueError):  # heads not contiguous within a position
        call(q, kv[0].transpose(2, 3).contiguous().transpose(2, 3), kv[1], 8)
    with pytest.raises(ValueError):  # dtypes that differ
        call(q, kv[0].float(), kv[1], 8)
    with pytest.raises(ValueError):  # caches off the card
        call(q, kv[0].cpu(), kv[1], 8)
    with pytest.raises(ValueError):  # past the caches
        call(q, *kv, 127, new)
    with pytest.raises(ValueError):  # two queries a row
        call(torch.cat([q, q], 1), *kv, 8)


def test_kv_cache_checks_the_decode_operands_once(cuda, monkeypatch):
    """A BART cached chain checks the kernel's operands at its first kernel
    call, every layer's self caches and cross keys and values, and never
    again; a cache whose cross keys are mislaid is refused there."""
    cfg = build_train_config("bart", "rico25", ["data.bbox_quantization=linear",
                                                "model.dtype=bfloat16"])
    model = build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(7))
    layers = model.backbone_cfg.num_layers
    checks = []
    real = nn_mod.check_decode_operands
    monkeypatch.setattr(nn_mod, "check_decode_operands",
                        lambda *a, **kw: checks.append(1) or real(*a, **kw))
    model.sample_ids(torch.Generator(cuda).manual_seed(1), 8)
    assert len(checks) == 2 * layers
    new_cache = model.net.new_cache

    def mislaid(batch, memory):
        cache = new_cache(batch, memory)
        cache.cross_keys[0] = cache.cross_keys[0].transpose(2, 3).contiguous().transpose(2, 3)
        return cache

    monkeypatch.setattr(model.net, "new_cache", mislaid)
    with pytest.raises(ValueError):
        model.sample_ids(torch.Generator(cuda).manual_seed(1), 8)


def test_decode_attention_launches_on_a_bart_chain_and_nowhere_else(cuda):
    """A bf16 BART cached chain at Rico25's widths (4 decoder layers, 125
    steps) launches the kernel twice a layer and step, 1,000 times; its
    recompute decode, its teacher-forced forward and a train step none."""
    from layoutdm_tpu_torch.train.step import init_train_state, make_optimizer, train_step

    cfg = build_train_config("bart", "rico25", ["data.bbox_quantization=linear",
                                                "model.dtype=bfloat16"])
    model = build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(7))
    layers, steps = model.backbone_cfg.num_layers, model.gen_len
    before = decode_attention.LAUNCHES_DECODE_ATTN
    model.sample_ids(torch.Generator(cuda).manual_seed(1), 8)
    torch.cuda.synchronize()
    assert decode_attention.LAUNCHES_DECODE_ATTN - before == 2 * layers * steps == 1000
    before = _launches()
    model.sample_ids(torch.Generator(cuda).manual_seed(1), 2, use_cache=False)
    rs = np.random.RandomState(2)
    enc, dec = (torch.as_tensor(rs.randint(0, model.num_classes, (4, model.seq_len)),
                                device=cuda) for _ in range(2))
    with torch.inference_mode():
        model.net(enc, dec)
    E = cfg.dataset.max_seq_length
    batch = {"label": rs.randint(0, 5, (4, E)), "bbox": rs.rand(4, E, 4).astype(np.float32),
             "mask": np.arange(E)[None] < rs.randint(1, E + 1, (4, 1))}
    state = init_train_state(model, make_optimizer(model.net), 1.0)
    train_step(state, model.preprocess(batch), torch.Generator(cuda).manual_seed(5))
    assert "decode" not in _since(before)
