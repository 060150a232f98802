"""adaLN ``norm1`` (`ops.adaln`): the plain version against the module's
former arithmetic (the float32 LayerNorm, its cast, the modulation
promoted to float32, then `Block`'s cast), bit for bit; the gate of the
kernel's widths and dtypes; and that CPU and autograd forwards launch
nothing.  The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from layoutdm_tpu_torch.configs import build_train_config
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.models.nn import LN_EPS, AdaLayerNorm
from layoutdm_tpu_torch.ops import adaln
from layoutdm_tpu_torch.ops.adaln import (
    ada_layer_norm,
    ada_layer_norm_reference,
    can_use_fused_adaln,
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


def test_cpu_and_autograd_forwards_launch_nothing():
    cfg = build_train_config("layoutdm", "synthetic", [
        "data.bbox_quantization=linear", "dataset.max_seq_length=5",
        "backbone.d_model=64", "backbone.nhead=2",
        "backbone.dim_feedforward=32", "backbone.num_layers=2",
        "model.num_timesteps=5", "backbone.diffusion_step=5",
    ])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    before = adaln.LAUNCHES_ADALN
    ids = model.sample_ids(torch.Generator().manual_seed(1), 2)
    logits = model.net(ids.clone(), torch.tensor([1, 3]))  # ids: an inference tensor
    logits.sum().backward()
    assert adaln.LAUNCHES_ADALN == before
