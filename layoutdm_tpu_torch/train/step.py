"""One training step: loss, backward, global-norm clip, AdamW (port of
``layoutdm_tpu/train/step.py``; reference `main.py:221-243`,
`base_model.py:54-106`).

The JAX package's step is a pure jitted function over a param tree; here
the state is a `TrainState` of the model, its ``torch.optim.AdamW`` and the
model's aux state, updated in place.  The model is any family of
`factory.build_model` (``loss(tokens, state, generator, is_train)``), and
its aux state an ``LtState`` (LayoutDM, VQDiffusion), a ``SeqLenState``
(MaskGIT, BLT) or ``None`` (RUITE, the autoregressive model, BART,
DiffusionLM, BitDiffusion), as in the JAX `train/step.py:87-135`.  The
model's ``net`` holds every trained parameter (DiffusionLM's rounder and
token embedding too).  The weight-decay mask becomes two parameter
groups.  Gradients are clipped as optax's ``clip_by_global_norm`` does:
scaled by ``max_norm / norm`` only when ``norm > max_norm`` (torch's
``clip_grad_norm_`` adds 1e-6 to the norm).
Every step runs in the span ``layoutdm.train_step``, which holds
``layoutdm.forward``, ``layoutdm.backward`` and ``layoutdm.optimizer`` in
turn (`utils.profiling.span`).

Over a mesh (`parallel.mesh`, one process a device) the steps spell out the
collectives that GSPMD and ``shard_map`` insert in the JAX package:

- `make_train_step` with a mesh is the data-parallel step.  Every rank gets
  the full batch and the same generator state, draws the full batch's
  noise and keeps its own rows (`ops.samplers.RowShard`), and the gradients
  are averaged over the data group before the clip.  The aux state merges
  to what the full batch gives: an ``LtState``'s history is the
  visit-count-weighted mean of the ranks' updates and its counts add up;
  any other aux state (MaskGIT's and BLT's ``SeqLenState``) is averaged.
  A masked mean (the zoo's and BART's cross-entropy over masked or
  non-PAD tokens) divides by the whole batch's count
  (`models.base.full_batch_means`), so for every family the step equals
  the full-batch step, as the JAX step over a sharded batch does.
- `make_train_step_shardmap` is JAX's explicit-collective step: each rank
  draws its own rows' noise from the step's seed with its shard index
  folded in (`fold_in`), and the gradients, losses and ``LtState.history``
  are averaged, ``count = old + sum(new - old)``.
- `parallel.tp.make_train_step_tp` adds the FFN's tensor parallelism: the
  global norm sums the split parameters' squares over the model group and
  counts every replicated parameter once.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from layoutdm_tpu_torch.models.base import Draws, full_batch_means
from layoutdm_tpu_torch.models.diffusion.loss import LtState
from layoutdm_tpu_torch.ops.samplers import RowShard
from layoutdm_tpu_torch.parallel.mesh import (
    batch_group,
    batch_index,
    batch_shards,
    shard_batch,
    shard_rows,
)
from layoutdm_tpu_torch.utils.profiling import span

# modules whose parameters never decay (JAX `NO_DECAY_MODULES`): the norms,
# including the Dense inside each AdaLayerNorm (`norm1.cond.linear`)
NO_DECAY_MODULES = ("norm1", "norm2", "head_norm")


def decayed_parameter_names(net: nn.Module) -> List[str]:
    """Names of the parameters AdamW decays: the weight of every Linear
    outside a norm module (the JAX `decay_mask`: Dense kernels only, no
    biases, embeddings, positions or norm parameters)."""
    names = []
    for mname, m in net.named_modules():
        if isinstance(m, nn.Linear) and not set(mname.split(".")) & set(NO_DECAY_MODULES):
            names.append(f"{mname}.weight")
    return names


def make_optimizer(
    net: nn.Module,
    lr: float = 5e-4,
    weight_decay: float = 0.1,
    betas: Tuple[float, float] = (0.9, 0.999),
) -> torch.optim.AdamW:
    """AdamW over two groups: decayed Linear weights and the rest (no
    decay).  optax's defaults: eps 1e-8, decoupled decay scaled by lr."""
    decay = set(decayed_parameter_names(net))
    params = dict(net.named_parameters())
    groups = [
        {"params": [p for n, p in params.items() if n in decay],
         "weight_decay": weight_decay},
        {"params": [p for n, p in params.items() if n not in decay],
         "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=lr, betas=tuple(betas), eps=1e-8)


@dataclass
class TrainState:
    model: object  # a model of `factory.build_model`
    optimizer: torch.optim.AdamW
    lt_state: object  # the model's aux state (the JAX field name): LtState, SeqLenState or None
    grad_norm_clip: float = 1.0
    step: int = 0
    # parameter name -> split spec, once `parallel.tp.shard_train_state` split the net
    tp_specs: Optional[Dict[str, Tuple]] = None


def init_train_state(model, optimizer, grad_norm_clip: float = 1.0) -> TrainState:
    return TrainState(model, optimizer, model.init_state(), grad_norm_clip)


def set_learning_rate(state: TrainState, lr: float) -> None:
    """Host-side LR override (plateau / cosine schedules)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float, split: Sequence[torch.Tensor] = (),
                        group=None) -> torch.Tensor:
    """optax ``clip_by_global_norm``: g * max_norm / norm where norm >
    max_norm, g unchanged otherwise.  ``split``: parameters that each rank
    of ``group`` holds a shard of (`parallel.tp`); their squared norms are
    summed over the group, every other parameter's counted once.  Returns
    the norm before clipping; nothing waits on the host."""
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if split:
        ids = {id(p) for p in split}
        sq = [torch.linalg.vector_norm(p.grad) ** 2 for p in params
              if p.grad is not None and id(p) in ids]
        split_sq = torch.stack(sq).sum()
        dist.all_reduce(split_sq, group=group)
        rest = [torch.linalg.vector_norm(p.grad) ** 2 for p in params
                if p.grad is not None and id(p) not in ids]
        norm = torch.sqrt(torch.stack(rest).sum() + split_sq)
    else:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads])
        )
    factor = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    torch._foreach_mul_(grads, factor)
    return norm


def fold_in(seed: int, index: int) -> int:
    """The seed of shard ``index`` of a step seeded ``seed`` (splitmix64 of
    the pair), so that the shards of `make_train_step_shardmap` draw
    independent noise."""
    m64 = (1 << 64) - 1
    x = (seed * 0x9E3779B97F4A7C15 + index + 1) & m64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m64
    return (x ^ (x >> 31)) >> 1  # 63 bits: a torch seed


def _batch_size(tokens) -> int:
    return (next(iter(tokens.values())) if isinstance(tokens, dict) else tokens).shape[0]


def _mean(t: torch.Tensor, group, n: int) -> torch.Tensor:
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t / n


def _mean_fields(state, group, n: int):
    """An aux state (MaskGIT's and BLT's ``SeqLenState``) averaged field by field."""
    return type(state)(**{f.name: _mean(getattr(state, f.name), group, n)
                          for f in dataclasses.fields(state)})


def merge_full_batch(old, new, group, n: int):
    """The ranks' aux states merged to the full batch's: an ``LtState``'s
    history is the mean of the ranks' updates weighted by each one's visits
    to each t (the full batch's EMA step by the mean over all its rows at
    t), its counts add up; any other aux state is averaged."""
    if new is None or n == 1:  # one rank's state is the batch's
        return new
    if isinstance(new, LtState):
        visits = new.count - old.count
        both = torch.stack([visits, visits * new.history])
        dist.all_reduce(both, group=group)
        history = torch.where(both[0] > 0, both[1] / torch.clamp(both[0], min=1.0), old.history)
        return LtState(history=history, count=old.count + both[0])
    return _mean_fields(new, group, n)


def merge_shardmap(old, new, group, n: int):
    """JAX ``make_train_step_shardmap``'s merge: ``history`` averaged,
    ``count = old + psum(new - old)``; any other aux state averaged."""
    if new is None or n == 1:
        return new
    if isinstance(new, LtState):
        visits = new.count - old.count
        dist.all_reduce(visits, group=group)
        return LtState(history=_mean(new.history, group, n), count=old.count + visits)
    return _mean_fields(new, group, n)


@dataclass
class _Collectives:
    """How a step over a mesh combines the ranks' work."""

    group: object  # the data group
    n: int  # its size
    merge: Callable  # (old aux, new aux, group, n) -> aux
    split: Sequence[torch.Tensor] = ()  # parameters split over the model group
    model_group: object = None

    @torch.no_grad()
    def average_grads(self, params: Sequence[torch.Tensor]) -> None:
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= self.n
        parts = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(parts, grads)])


def _update(model, optimizer, state: "TrainState", losses: Dict[str, torch.Tensor], new_lt,
            coll: Optional[_Collectives] = None) -> Dict[str, torch.Tensor]:
    """Backward of the summed losses, the gradients (and over a mesh the
    losses and the aux state) combined, the clip, one AdamW update."""
    with span("layoutdm.backward"):
        total = sum(losses.values())
        optimizer.zero_grad(set_to_none=True)
        total.backward()
    with span("layoutdm.optimizer"):
        params = list(model.net.parameters())
        metrics = {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
        if coll is None:
            clip_by_global_norm(params, state.grad_norm_clip)
        else:
            coll.average_grads(params)
            clip_by_global_norm(params, state.grad_norm_clip, coll.split, coll.model_group)
            new_lt = coll.merge(state.lt_state, new_lt, coll.group, coll.n)
            metrics = {k: _mean(v, coll.group, coll.n) for k, v in metrics.items()}
        optimizer.step()
    state.lt_state = new_lt
    state.step += 1
    return metrics


def train_step(
    state: TrainState,
    tokens,
    generator: Optional[torch.Generator] = None,
    loss_fn: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """The summed losses' gradient, clipped, one AdamW update and the new
    aux state; returns the step's metrics as device tensors.
    ``loss_fn(lt_state) -> (losses, new_lt_state)`` replaces the model's
    sampled training loss (tests pin t, x_t and dropout through it)."""
    model = state.model
    with span("layoutdm.train_step"):
        with span("layoutdm.forward"):
            if loss_fn is None:
                losses, new_lt = model.loss(tokens, state.lt_state, generator, is_train=True)
            else:
                losses, new_lt = loss_fn(state.lt_state)
        return _update(model, state.optimizer, state, losses, new_lt)


def make_train_step(model, optimizer, mesh=None, tp_specs=None):
    """The train step ``(state, tokens, generator=None, loss_fn=None) ->
    metrics``: `train_step` without a mesh; with one, the data-parallel
    step (module docstring).  Every rank passes the full batch and a
    generator in the same state; ``loss_fn(lt_state)``, where given, is
    the rank's own rows' loss.  Metrics are averaged over the data group.
    ``tp_specs`` (from `parallel.tp.make_train_step_tp`) names the
    parameters split over the model group."""
    coll = None
    if mesh is not None:
        split = [p for name, p in model.net.named_parameters()
                 if "model" in (tp_specs or {}).get(name, ())]
        coll = _Collectives(batch_group(mesh), batch_shards(mesh), merge_full_batch,
                            split, mesh.get_group("model") if split else None)

    def losses_of(state, tokens, generator, loss_fn):
        if loss_fn is not None:
            return loss_fn(state.lt_state)
        if mesh is None:
            return model.loss(tokens, state.lt_state, generator, is_train=True)
        B = _batch_size(tokens)
        rows = RowShard(*shard_rows(B, mesh), B)
        return model.loss(shard_batch(tokens, mesh), state.lt_state,
                          Draws(generator, rows=rows), is_train=True)

    def step(state, tokens, generator=None, loss_fn=None):
        with span("layoutdm.train_step"):
            with span("layoutdm.forward"):
                if coll is None:
                    losses, new_lt = losses_of(state, tokens, generator, loss_fn)
                else:
                    with full_batch_means(coll.group, coll.n):
                        losses, new_lt = losses_of(state, tokens, generator, loss_fn)
            return _update(model, optimizer, state, losses, new_lt, coll)

    return step


def make_train_step_shardmap(model, optimizer, mesh):
    """JAX's explicit-collective step ``(state, tokens, seed, loss_fn=None)
    -> metrics``: each rank takes its rows of the full batch and draws
    their noise from a generator on the model's device seeded
    ``fold_in(seed, shard index)``; gradients, losses and
    ``LtState.history`` are averaged over the data group, the visit counts
    summed (`merge_shardmap`)."""
    coll = _Collectives(batch_group(mesh), batch_shards(mesh), merge_shardmap)

    def step(state, tokens, seed: int, loss_fn=None):
        with span("layoutdm.train_step"):
            with span("layoutdm.forward"):
                if loss_fn is None:
                    gen = torch.Generator(device=model.device).manual_seed(
                        fold_in(seed, batch_index(mesh)))
                    losses, new_lt = model.loss(shard_batch(tokens, mesh), state.lt_state, gen,
                                                is_train=True)
                else:
                    losses, new_lt = loss_fn(state.lt_state)
            return _update(model, optimizer, state, losses, new_lt, coll)

    return step


def make_eval_step(model, mesh=None):
    """Validation loss ``(lt_state, tokens, generator) -> loss``: no dropout,
    no auxiliary loss; over a mesh, each rank's rows with the full batch's
    noise and masked means over the full batch's count, averaged over the
    data group."""
    if mesh is None:
        return lambda lt_state, tokens, generator: eval_loss(model, lt_state, tokens, generator)
    group, n = batch_group(mesh), batch_shards(mesh)

    def fn(lt_state, tokens, generator):
        B = _batch_size(tokens)
        rows = RowShard(*shard_rows(B, mesh), B)
        with full_batch_means(group, n):
            loss = eval_loss(model, lt_state, shard_batch(tokens, mesh),
                             Draws(generator, rows=rows))
        return _mean(loss, group, n)

    return fn


@torch.no_grad()
def eval_loss(model, lt_state, tokens, generator) -> torch.Tensor:
    """Validation loss: no dropout, no auxiliary loss (`main.py:271-294`)."""
    losses, _ = model.loss(tokens, lt_state, generator, is_train=False)
    return sum(losses.values())
