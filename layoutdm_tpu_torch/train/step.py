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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

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


def init_train_state(model, optimizer, grad_norm_clip: float = 1.0) -> TrainState:
    return TrainState(model, optimizer, model.init_state(), grad_norm_clip)


def set_learning_rate(state: TrainState, lr: float) -> None:
    """Host-side LR override (plateau / cosine schedules)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: g * max_norm / norm where norm >
    max_norm, g unchanged otherwise.  Returns the norm before clipping;
    nothing waits on the host."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads])
    )
    factor = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    torch._foreach_mul_(grads, factor)
    return norm


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
    if loss_fn is None:
        losses, new_lt = model.loss(tokens, state.lt_state, generator, is_train=True)
    else:
        losses, new_lt = loss_fn(state.lt_state)
    total = sum(losses.values())
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    clip_by_global_norm(model.net.parameters(), state.grad_norm_clip)
    state.optimizer.step()
    state.lt_state = new_lt
    state.step += 1
    return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}


@torch.no_grad()
def eval_loss(model, lt_state, tokens, generator: torch.Generator) -> torch.Tensor:
    """Validation loss: no dropout, no auxiliary loss (`main.py:271-294`)."""
    losses, _ = model.loss(tokens, lt_state, generator, is_train=False)
    return sum(losses.values())
