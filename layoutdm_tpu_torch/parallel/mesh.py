"""Process mesh and batch sharding over ``torch.distributed`` (port of
``layoutdm_tpu/parallel/mesh.py``).

The JAX package lays its devices on a ``("data", "model")`` mesh and lets
GSPMD split the batch and insert the collectives.  Here there is one
process a device (``torchrun --nproc_per_node=N``, or a test's gloo
processes on the CPU), a ``DeviceMesh`` of the same axes over the launched
ranks, and the collectives are spelled out by the train steps
(`train.step`, `parallel.tp`).  Rank ``r`` sits at mesh position
``(r // model_parallel, r % model_parallel)``, the JAX mesh's
``reshape(n // model_parallel, model_parallel)``.

`make_multislice_mesh` lays out ``("dcn", "data")``: ranks are slice-major
(a multi-node ``torchrun`` numbers each node's ranks together), so the
batch split over both axes (`hierarchical_batch_spec`) is the flattened
data group, and the gradient all-reduce runs over it.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BATCH_AXES = ("dcn", "data")  # mesh axes that split the batch, outermost first


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: launch with torchrun --nproc_per_node=N (or call "
            "torch.distributed.init_process_group) before building a mesh"
        )
    return dist.get_world_size()


def make_mesh(num_devices: int = 0, model_parallel: int = 1) -> DeviceMesh:
    """A 2-D ``("data", "model")`` mesh over the launched ranks.
    ``num_devices`` 0 means the world size (the JAX ``0``: every local
    device); any other value must equal it (1 without a process group)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if num_devices and num_devices != n:
        raise ValueError(
            f"num_devices={num_devices} but the launched world size is {n}: launch "
            f"with torchrun --nproc_per_node={num_devices}, or set num_devices=0"
        )
    n = _world()
    if n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide world size {n}")
    return init_device_mesh(_device_type(), (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def make_multislice_mesh(num_slices: int) -> DeviceMesh:
    """A ``("dcn", "data")`` mesh: the outer axis across slices (nodes),
    the inner one over each slice's ranks, slice-major."""
    n = _world()
    if n % num_slices:
        raise ValueError(f"{n} ranks not divisible by {num_slices} slices")
    return init_device_mesh(_device_type(), (num_slices, n // num_slices),
                            mesh_dim_names=("dcn", "data"))


def hierarchical_batch_spec(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The mesh axes the batch is split over, outermost first."""
    return tuple(a for a in BATCH_AXES if a in mesh.mesh_dim_names)


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def batch_shards(mesh: DeviceMesh) -> int:
    """How many shards the batch is split into."""
    return int(np.prod([_axis_size(mesh, a) for a in hierarchical_batch_spec(mesh)]))


def batch_index(mesh: DeviceMesh) -> int:
    """This rank's shard of the batch: its position along the batch axes,
    flattened outermost first."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in hierarchical_batch_spec(mesh):
        index = index * _axis_size(mesh, a) + coord[a]
    return index


def batch_group(mesh: DeviceMesh):
    """The process group over the batch axes: the data group, or, on a
    multislice mesh, every rank (the flattened ``("dcn", "data")``)."""
    axes = hierarchical_batch_spec(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if mesh.size() != dist.get_world_size():
        raise ValueError("a multislice mesh must span every rank")
    return dist.group.WORLD


def shard_rows(batch_size: int, mesh: DeviceMesh) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of a batch of ``batch_size`` rows."""
    n = batch_shards(mesh)
    if batch_size % n:
        raise ValueError(f"batch {batch_size} does not split into {n} shards")
    i, per = batch_index(mesh), batch_size // n
    return i * per, (i + 1) * per


def shard_batch(batch: Any, mesh: DeviceMesh) -> Any:
    """This rank's rows of every array of ``batch`` (a tensor, an array, or
    a dict of them), in order: rank position r holds rows [r·B/N, (r+1)·B/N)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    lo, hi = shard_rows(batch.shape[0], mesh)
    return batch[lo:hi]


@torch.no_grad()
def gather_rows(t: torch.Tensor, mesh: DeviceMesh) -> Tuple[torch.Tensor, List[int]]:
    """Every rank's rows of ``t`` (this rank's rows `shard_rows` of the
    batch) gathered over the batch group, in batch order: the rows of batch
    index r land at ``[r·b, (r+1)·b)`` for ``b`` rows a rank (the JAX
    data-sharded ``out_shardings``, gathered).  Also returns the global
    ranks that contributed rows, in that order.  On NCCL ``t`` lies on the
    rank's GPU (``all_gather_into_tensor``); on gloo, on the CPU."""
    group = batch_group(mesh)
    n = dist.get_world_size(group)
    t = t.contiguous()
    who = torch.tensor([batch_index(mesh), dist.get_rank()], device=t.device)

    def gather(x):
        if dist.get_backend(group) == "nccl":
            out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x, group=group)
            return list(out.chunk(n))
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x, group=group)
        return out

    parts, whos = gather(t), torch.stack(gather(who))
    index, ranks = whos[:, 0].tolist(), whos[:, 1].tolist()
    if sorted(index) != list(range(n)):
        raise AssertionError(f"batch indices {index} of the batch group are not 0..{n - 1}")
    order = sorted(range(n), key=index.__getitem__)
    return torch.cat([parts[i] for i in order]), [ranks[i] for i in order]


@torch.no_grad()
def replicate(tree: Any) -> Any:
    """Every tensor of ``tree`` (a tensor or a dict of them, e.g. a
    ``state_dict``, whose tensors share the module's storage) overwritten
    in place with global rank 0's: the mesh spans every rank."""
    if isinstance(tree, dict):
        for v in tree.values():
            replicate(v)
        return tree
    dist.broadcast(tree, src=0)
    return tree
