"""The GEMM epilogues' gate (`models.nn.takes_gemm_epilogue`) and the shim's
plain versions (`ops.gemm_epilogue`) on the CPU.  The gate admits a
product only on a CUDA device, without autograd or dropout, in bfloat16,
with ReLU for an activation, through layers with a bias, no tensor-parallel
split and widths in multiples of 8.  Every case that the gate refuses, and
every forward on the CPU, runs the Block's eager calls: the tensor it
returned before the epilogues, bit for bit, and no shim call.  The shim
itself is held to its eager pair on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from layoutdm_tpu_torch.configs import BackboneConfig
from layoutdm_tpu_torch.models import nn as nn_mod
from layoutdm_tpu_torch.models.nn import Block, Dropout, _linear, affine_norm, make_module
from layoutdm_tpu_torch.ops import gemm_epilogue

D, FFN = 48, 32
GATE_CASES = ["admits", "cpu", "grad", "dropout", "float32", "gelu", "gelu2",
              "tensor_parallel", "width"]


class _WholeSplit:
    """A tensor-parallel split over one rank: the whole product."""
    lo, hi, total = 0, FFN, FFN

    def __call__(self, x, weight, bias):
        return F.linear(x, weight, bias)


def _former_forward(block: Block, x, t, dropout):
    """`Block.forward` before the epilogues: the eager ReLU and adds."""
    drop = dropout or (lambda h, rate, cols=None: h)
    dt = block.dtype
    x = block.norm1(x, t).to(dt)
    x = x + drop(block.attn(x, dropout), block.dropout)
    h = block.activation(_linear(affine_norm(block.norm2, x, dt), block.linear1, dt))
    h = _linear(drop(h, block.dropout, getattr(block.linear1, "tensor_parallel", None)),
                block.linear2, dt)
    return x + drop(h, block.dropout)


@pytest.mark.parametrize("case", GATE_CASES)
def test_gate_admits_only_the_bf16_relu_inference_product(case):
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    act = case if case in ("gelu", "gelu2") else "relu"
    bb = BackboneConfig(d_model=D, nhead=2, dim_feedforward=36 if case == "width" else FFN,
                        num_layers=1, dropout=0.1 if case == "dropout" else 0.0, activation=act,
                        timestep_type="adalayernorm", diffusion_step=10)
    g = torch.Generator().manual_seed(1)
    block = make_module(Block, "cpu", g, cfg=bb, dtype=dtype)
    if case == "tensor_parallel":
        block.linear1.tensor_parallel = block.linear2.tensor_parallel = _WholeSplit()

    def draws():  # the same keep-masks for each forward
        return Dropout(torch.Generator().manual_seed(2)) if case == "dropout" else None

    device = torch.device("cpu" if case == "cpu" else "cuda")
    x = torch.randn(2, 5, D, generator=g).to(dtype)
    t = torch.tensor([1, 7])
    before = gemm_epilogue.LAUNCHES_EPILOGUE
    with torch.set_grad_enabled(case == "grad"):
        ffn = nn_mod.takes_gemm_epilogue(device, dtype, draws(), block.linear1, block.linear2,
                                         activation=act)
        out = nn_mod.takes_gemm_epilogue(device, dtype, draws(), block.attn.out)
        got, want = block(x, t, draws()), _former_forward(block, x, t, draws())
    assert ffn == (case == "admits")
    assert out == (case not in ("cpu", "grad", "dropout", "float32"))
    assert got.dtype == dtype and torch.equal(got, want)
    assert gemm_epilogue.LAUNCHES_EPILOGUE == before


def test_plain_versions_on_the_cpu():
    """`linear_relu` is the eager pair; `linear_residual` the float32 sum
    rounded once, which the eager add (product rounded, then the sum) is
    not everywhere."""
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(64, D, generator=g), torch.randn(FFN, D, generator=g) * D ** -0.5
    b, r = torch.randn(FFN, generator=g), torch.randn(64, FFN, generator=g)
    x, w, b, r = (a.to(torch.bfloat16) for a in (x, w, b, r))
    before = gemm_epilogue.LAUNCHES_EPILOGUE
    assert torch.equal(gemm_epilogue.linear_relu(x, w, b), F.relu(F.linear(x, w, b)))
    got = gemm_epilogue.linear_residual(x, w, b, r)
    want = (F.linear(x.float(), w.float(), b.float()) + r.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not torch.equal(got, r + F.linear(x, w, b))
    assert gemm_epilogue.LAUNCHES_EPILOGUE == before
    with pytest.raises(ValueError):
        gemm_epilogue.linear_residual(x, w, b, r[:, :8])
