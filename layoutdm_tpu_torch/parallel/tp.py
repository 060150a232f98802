"""Tensor parallelism over the mesh's "model" axis, the Megatron FFN split
(port of ``layoutdm_tpu/parallel/tp.py``).

``linear1`` is column-parallel: its weight's rows (the hidden units, in the
``nn.Linear`` (out, in) layout) and its bias are split, and its input goes
through Megatron's *f* (identity forward, all-reduce of the gradient
backward).  ``linear2`` is row-parallel: its weight's columns are split,
the partial products are summed by an all-reduce (*g*: all-reduce forward,
identity backward), and its bias is added once, after the reduce.  The
FFN is 2/3 of the transformer's operations; the hidden's dropout draws the
whole hidden's mask and keeps this rank's columns.

The attention projections stay replicated, for the JAX package's reason:
the packed qkv weight keeps the torch MHA layout ``(3D, D)``, and a flat
split of that axis crosses the q/k/v block boundaries unless the degree is
a multiple of 3; with 8 heads of 58 the attention GEMMs are too small to
pay for the resharding.

AdamW's moments shard with their parameters by construction: each rank's
optimizer holds its own shards, so the moments it creates have the shards'
shapes (`shard_train_state` also slices moments that already exist).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

# (module, parameter) -> the mesh axis of each dim, None where a dim is not
# split: column-parallel linear1 (rows of the (out, in) weight and the
# bias), row-parallel linear2 (columns; its bias is replicated)
_FFN_RULES = {
    ("linear1", "weight"): ("model", None),
    ("linear1", "bias"): ("model",),
    ("linear2", "weight"): (None, "model"),
}
REPLICATED: Tuple = ()


def tp_param_specs(params: Mapping[str, torch.Tensor]) -> Dict[str, Tuple]:
    """Parameter name -> spec (the mesh axis of each dim); every parameter
    no rule matches is replicated (``()``)."""
    return {name: _FFN_RULES.get(tuple(name.split(".")[-2:]), REPLICATED) for name in params}


def _assert_divisible(params: Mapping[str, torch.Tensor], specs: Mapping[str, Tuple],
                      n_model: int) -> None:
    for name, leaf in params.items():
        for dim, axis in enumerate(specs[name]):
            if axis == "model" and leaf.shape[dim] % n_model:
                raise ValueError(
                    f"TP degree {n_model} does not divide dim {dim} of "
                    f"{name} (shape {tuple(leaf.shape)})"
                )


def state_shardings(state, mesh: DeviceMesh) -> Dict[str, Tuple]:
    """The spec of every parameter of ``state``'s net, its AdamW moments
    alike; everything else of the state (aux state, step) is replicated."""
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    params = dict(state.model.net.named_parameters())
    specs = tp_param_specs(params)
    _assert_divisible(params, specs, n_model)
    return specs


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the replicated input as it is; its gradient summed
    over the model group (each rank's shard contributes a part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the partial products summed over the model group; the
    gradient passes to every rank as it is."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ColumnParallel:
    """``linear1``'s product on this rank's hidden units [lo, hi) of ``total``."""

    def __init__(self, group, lo: int, hi: int, total: int):
        self.group, self.lo, self.hi, self.total = group, lo, hi, total

    def __call__(self, x, weight, bias):
        return F.linear(_CopyToModel.apply(x, self.group), weight, bias)


class RowParallel:
    """``linear2``'s product on this rank's hidden units, summed over the
    model group, the bias added once after the sum."""

    def __init__(self, group):
        self.group = group

    def __call__(self, x, weight, bias):
        y = _ReduceFromModel.apply(F.linear(x, weight), self.group)
        return y if bias is None else y + bias


def _model_coordinate(mesh: DeviceMesh) -> Tuple[int, int]:
    axis = mesh.mesh_dim_names.index("model")
    return mesh.get_coordinate()[axis], mesh.size(axis)


@torch.no_grad()
def shard_train_state(state, mesh: DeviceMesh):
    """Split ``state``'s net in place per `state_shardings`: each split
    parameter (and any AdamW moment of it) keeps this rank's shard, and the
    FFN layers run their column- and row-parallel products over the model
    group.  The parameter objects stay the optimizer's.  Returns ``state``."""
    specs = state_shardings(state, mesh)
    net = state.model.net
    if any(getattr(m, "fused_ffn", False) for m in net.modules()):
        raise ValueError("tensor parallelism splits the unfused FFN; build the model "
                         "without fused_ffn")
    index, n = _model_coordinate(mesh)
    group = mesh.get_group("model")

    def local(t: torch.Tensor, spec: Tuple) -> torch.Tensor:
        dim = spec.index("model")
        size = t.shape[dim] // n
        return t.narrow(dim, index * size, size).contiguous()

    for name, p in net.named_parameters():
        spec = specs[name]
        if "model" not in spec:
            continue
        p.data = local(p.data, spec)
        for key, moment in state.optimizer.state.get(p, {}).items():
            if torch.is_tensor(moment) and moment.dim():
                state.optimizer.state[p][key] = local(moment, spec)
    for mname, m in net.named_modules():
        if mname.endswith("linear1") and isinstance(m, torch.nn.Linear):
            F_total = m.weight.shape[0] * n
            m.tensor_parallel = ColumnParallel(group, index * m.weight.shape[0],
                                               (index + 1) * m.weight.shape[0], F_total)
        elif mname.endswith("linear2") and isinstance(m, torch.nn.Linear):
            m.tensor_parallel = RowParallel(group)
    state.tp_specs = specs
    return state


@torch.no_grad()
def gathered_state_dict(state, mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """The net's full ``state_dict`` on every rank: each split parameter's
    shards gathered over the model group, in order."""
    group = mesh.get_group("model")
    _, n = _model_coordinate(mesh)
    out = {}
    for name, t in state.model.net.state_dict().items():
        spec = state.tp_specs.get(name, REPLICATED)
        if "model" in spec:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim=spec.index("model"))
        out[name] = t.detach().clone()
    return out


def make_train_step_tp(model, optimizer, mesh: DeviceMesh, state):
    """The 2-D (data x model) train step: the batch split over "data" (the
    data-parallel step of `train.step.make_train_step`, the full batch's
    noise, gradients averaged over the data group before the clip), the
    FFN weights and their AdamW moments split over "model", the global
    gradient norm summed over the model group for the split parameters.
    ``state`` must have been through `shard_train_state`."""
    from layoutdm_tpu_torch.train.step import make_train_step

    if state.tp_specs is None:
        raise ValueError("shard the state with shard_train_state first")
    return make_train_step(model, optimizer, mesh, tp_specs=state.tp_specs)
