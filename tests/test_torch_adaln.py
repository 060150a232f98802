"""The denoiser's LayerNorm kernel (`ops.adaln`) on the CPU.  adaLN
``norm1``: the plain version against the module's former arithmetic (the
float32 LayerNorm, its cast, the modulation promoted to float32, then
`Block`'s cast), bit for bit.  The affine mode: its plain version is
``F.layer_norm`` in float32 and the cast, and the modules that call it
through `models.nn.affine_norm` give the logits of the module calls it
replaced, bit for bit.  The gates of the kernel's widths and dtypes; CPU
and autograd forwards launch nothing.  The kernel itself is held to the
plain versions on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from layoutdm_tpu_torch.configs import BackboneConfig, build_train_config
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.models import nn as nn_mod
from layoutdm_tpu_torch.models.nn import (
    LN_EPS,
    AdaLayerNorm,
    Block,
    DecoderBlock,
    affine_norm,
    make_module,
    make_transformer,
)
from layoutdm_tpu_torch.ops import adaln
from layoutdm_tpu_torch.ops.adaln import (
    ada_layer_norm,
    ada_layer_norm_reference,
    can_use_fused_adaln,
    can_use_fused_ln,
    layer_norm,
    layer_norm_reference,
)

D = 48


def _former(norm: AdaLayerNorm, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`AdaLayerNorm.forward` before the kernel, then `Block`'s cast."""
    scale, shift = norm.cond(t)[:, None].chunk(2, dim=-1)
    y = F.layer_norm(x.float(), x.shape[-1:], eps=LN_EPS).to(x.dtype)
    return (y * (1 + scale) + shift).to(x.dtype)


@pytest.mark.parametrize("emb_type", ["adalayernorm", "adalayernorm_mlp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_former_norm1(emb_type, dtype):
    torch.manual_seed(0)
    norm = AdaLayerNorm(D, 10, emb_type)
    with torch.no_grad():  # scales and shifts well away from 0 and 1
        norm.cond.linear.bias.normal_(0.0, 0.5)
    x = (torch.randn(3, 7, D) * 2 + 0.5).to(dtype)
    t = torch.tensor([0, 4, 9])
    with torch.no_grad():
        want = _former(norm, x, t)
        cond = norm.cond(t)
        assert cond.shape == (3, 2 * D) and cond.dtype == torch.float32
        got = {
            "reference": ada_layer_norm_reference(x, cond, LN_EPS),
            "wrapper": ada_layer_norm(x, cond, LN_EPS),
            "module": norm(x, t),
        }
    got["module, grad"] = norm(x, t).detach()
    for name, g in got.items():
        assert g.dtype == dtype, name
        assert torch.equal(g, want), name


@pytest.mark.parametrize("d_model,dtype,takes", [
    (464, torch.bfloat16, True),   # the flagship
    (464, torch.float32, True),
    (64, torch.bfloat16, True),
    (1024, torch.bfloat16, True),  # the widest: 4 vectors a lane
    (1024, torch.float32, True),   # 8 vectors a lane
    (116, torch.float32, True),    # 29 float32 vectors
    (116, torch.bfloat16, False),  # no whole bf16 vectors
    (462, torch.float32, False),
    (1032, torch.bfloat16, False),
    (0, torch.bfloat16, False),
    (464, torch.float16, False),
    (464, torch.float64, False),
])
def test_gate_admits_what_the_kernel_takes(d_model, dtype, takes):
    assert can_use_fused_adaln(d_model, dtype) is takes


def test_wrapper_rejects_shapes_it_does_not_take():
    x = torch.zeros(2, 5, D)
    with pytest.raises(ValueError):
        ada_layer_norm(x[0], torch.zeros(2, 2 * D))
    with pytest.raises(ValueError):
        ada_layer_norm(x, torch.zeros(2, D))
    with pytest.raises(ValueError):
        ada_layer_norm(x, torch.zeros(2, 1, 2 * D))
    with pytest.raises(ValueError):
        layer_norm(x, torch.ones(D + 1), torch.zeros(D + 1), x.dtype)
    with pytest.raises(ValueError):
        layer_norm(x, torch.ones(D), torch.zeros(1, D), x.dtype)


@pytest.mark.parametrize("d_model,dtype,out_dtype,takes", [
    (464, torch.bfloat16, torch.bfloat16, True),  # norm2 at the flagship
    (464, torch.bfloat16, torch.float32, True),   # the vocab head's norm
    (464, torch.float32, torch.float32, True),
    (116, torch.float32, torch.float32, True),
    (116, torch.bfloat16, torch.float32, False),  # no whole bf16 vectors
    (464, torch.float32, torch.bfloat16, False),  # no call site narrows float32
    (464, torch.float16, torch.float16, False),
    (1032, torch.float32, torch.float32, False),
])
def test_affine_gate_admits_what_the_kernel_takes(d_model, dtype, out_dtype, takes):
    assert can_use_fused_ln(d_model, dtype, out_dtype) is takes


def _affine_params(d: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return 1 + 0.3 * torch.randn(d, generator=g), 0.5 * torch.randn(d, generator=g)


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
])
def test_affine_plain_version_is_layer_norm_then_cast(dtype, out_dtype):
    w, b = _affine_params(D)
    x = (torch.randn(3, 7, D, generator=torch.Generator().manual_seed(1)) * 2 + 0.5).to(dtype)
    want = F.layer_norm(x.float(), (D,), w, b, LN_EPS).to(out_dtype)
    for got in (layer_norm_reference(x, w, b, out_dtype, LN_EPS),
                layer_norm(x, w, b, out_dtype, LN_EPS)):
        assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
])
def test_affine_norm_takes_the_plain_version_on_cpu_and_under_autograd(grad, dtype, out_dtype):
    norm = torch.nn.LayerNorm(D, eps=LN_EPS)
    with torch.no_grad():
        norm.weight.copy_(_affine_params(D)[0])
        norm.bias.copy_(_affine_params(D)[1])
    x = torch.randn(2, 5, D, generator=torch.Generator().manual_seed(2)).to(dtype)
    before = adaln.LAUNCHES_LN
    with torch.set_grad_enabled(grad):
        got = affine_norm(norm, x, out_dtype)
    assert adaln.LAUNCHES_LN == before
    assert got.requires_grad is grad and got.dtype == out_dtype
    assert torch.equal(got.detach(), norm(x.float()).to(out_dtype).detach())


def _former_affine_norm(norm, x, dtype):
    """The module calls `affine_norm` replaced: the float32 LayerNorm,
    left to the Dense after it to cast."""
    return norm(x.float())


def _shake_norms(net: torch.nn.Module) -> None:
    """Affine LayerNorms away from their unit init, so the affine counts."""
    for i, m in enumerate(m for m in net.modules() if isinstance(m, torch.nn.LayerNorm)):
        w, b = _affine_params(m.normalized_shape[0], seed=10 + i)
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)


def _tiny_backbone(timestep_type):
    return BackboneConfig(d_model=D, nhead=2, dim_feedforward=32, num_layers=2, dropout=0.0,
                          timestep_type=timestep_type, diffusion_step=10)


@pytest.mark.parametrize("case", ["block", "block_adaln", "decoder_block", "categorical",
                                  "categorical_adaln"])
def test_modules_give_the_logits_of_the_calls_they_replace(case, monkeypatch):
    g = torch.Generator().manual_seed(3)
    bf16 = torch.bfloat16
    x = torch.randn(2, 6, D, generator=g).to(bf16)
    t = torch.tensor([1, 7])
    if case.startswith("block"):
        bb = _tiny_backbone("adalayernorm" if case == "block_adaln" else None)
        net = make_module(Block, "cpu", g, cfg=bb, dtype=bf16)
        run = lambda: net(x, t)  # noqa: E731
    elif case == "decoder_block":
        net = make_module(DecoderBlock, "cpu", g, cfg=_tiny_backbone(None), dtype=bf16)
        memory = torch.randn(2, 4, D, generator=g).to(bf16)
        run = lambda: net(x, memory)  # noqa: E731
    else:
        bb = _tiny_backbone("adalayernorm" if case == "categorical_adaln" else None)
        net = make_transformer("cpu", g, backbone=bb, num_classes=11, max_token_length=10,
                               dtype=bf16)
        seq = torch.randint(0, 11, (2, 10), generator=g)
        run = lambda: net(seq, t if bb.timestep_type else None)  # noqa: E731
    _shake_norms(net)
    with torch.no_grad():
        got = run()
        monkeypatch.setattr(nn_mod, "affine_norm", _former_affine_norm)
        want = run()
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_cpu_and_autograd_forwards_launch_nothing():
    cfg = build_train_config("layoutdm", "synthetic", [
        "data.bbox_quantization=linear", "dataset.max_seq_length=5",
        "backbone.d_model=64", "backbone.nhead=2",
        "backbone.dim_feedforward=32", "backbone.num_layers=2",
        "model.num_timesteps=5", "backbone.diffusion_step=5",
    ])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    before = adaln.LAUNCHES_ADALN, adaln.LAUNCHES_LN
    ids = model.sample_ids(torch.Generator().manual_seed(1), 2)
    logits = model.net(ids.clone(), torch.tensor([1, 3]))  # ids: an inference tensor
    logits.sum().backward()
    assert (adaln.LAUNCHES_ADALN, adaln.LAUNCHES_LN) == before
