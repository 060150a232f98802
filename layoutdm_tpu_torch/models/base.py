"""Shared pieces of the baseline zoo (port of ``layoutdm_tpu/models/base.py``;
reference `models/base_model.py:13-150`, `nn_lib.py:26-52`).

Every family has the same surface as `models.layoutdm.LayoutDM`:
``net`` (a `models.nn.CategoricalTransformer`), ``init_state()``,
``preprocess(batch, generator)``, ``loss(tokens, state, generator,
is_train)`` -> (losses, new state), ``sample_ids`` / ``sample``.  The aux
state is explicit, as in the JAX package: the element-count histogram
(`SeqLenState`) for MaskGIT and BLT, nothing (``None``) for RUITE and the
autoregressive model.

The zoo's random draws go through `Draws`: from a ``torch.Generator``, or,
for parity tests, injected by name; in the data-parallel train step a
`Draws` with ``rows`` draws the whole batch's noise and keeps a rank's rows,
and `full_batch_means` makes a rank's masked mean (`cross_entropy`) a share
of the whole batch's.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from layoutdm_tpu_torch.models.nn import Dropout, denoiser_path, make_transformer
from layoutdm_tpu_torch.ops.samplers import (
    RowShard,
    draw_rows,
    gumbel_noise,
    num_draws,
    sample_tokens,
)
from layoutdm_tpu_torch.utils.device import require_device


class Draws:
    """The models' random draws: uniforms, normals, coins, integers and
    Gumbel noise from ``generator`` (on any device; the draws move to the
    caller's), or, where ``injected`` names them, taken as given from its
    lists in call order."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 injected: Optional[Dict[str, Sequence]] = None,
                 rows: Optional[RowShard] = None):
        """``rows``: the data-parallel rank's rows; its batch-led draws are
        the whole batch's, sliced (`ops.samplers.RowShard`)."""
        self.generator = generator
        self.injected = {k: list(v) for k, v in (injected or {}).items()}
        self.rows = rows

    def dropout(self) -> Dropout:
        """Training mode's dropout, drawn from the generator for these rows."""
        return Dropout(self.generator, rows=self.rows)

    def _draw(self, fn, shape) -> torch.Tensor:
        return draw_rows(self.rows, fn, shape)

    def _take(self, name: str, device):
        if name in self.injected:
            return torch.as_tensor(self.injected[name].pop(0), device=device)
        if self.generator is None:
            raise ValueError(f"no generator for the draw {name!r}")
        return None

    def uniform(self, name: str, shape, device, high: float = 1.0) -> torch.Tensor:
        """U[0, ``high``) (an injected draw is taken as it is)."""
        got = self._take(name, device)
        if got is not None:
            return got
        g = self.generator
        u = self._draw(lambda sh: torch.rand(sh, generator=g, device=g.device), shape).to(device)
        return u * high if high != 1.0 else u

    def normal(self, name: str, shape, device) -> torch.Tensor:
        got = self._take(name, device)
        if got is not None:
            return got
        g = self.generator
        return self._draw(lambda sh: torch.randn(sh, generator=g, device=g.device),
                          shape).to(device)

    def bernoulli(self, name: str, p: float, shape, device) -> torch.Tensor:
        """Boolean coins, True with probability ``p``."""
        got = self._take(name, device)
        if got is not None:
            return got.bool()
        return self.uniform(name, shape, device) < p

    def gumbel(self, name: str, shape, device) -> torch.Tensor:
        got = self._take(name, device)
        if got is not None:
            return got
        return self._draw(lambda sh: gumbel_noise(self.generator, sh, device=device), shape)

    def randint(self, name: str, high: int, shape, device) -> torch.Tensor:
        got = self._take(name, device)
        if got is not None:
            return got
        g = self.generator
        return self._draw(lambda sh: torch.randint(0, high, sh, generator=g, device=g.device),
                          shape).to(device)


def as_draws(rng) -> Draws:
    """A `Draws` from a generator, or the `Draws` given."""
    return rng if isinstance(rng, Draws) else Draws(rng)


def sample_logits(logits: torch.Tensor, sampling, draws: Draws) -> torch.Tensor:
    """`ops.samplers.sample_tokens` with its Gumbel draws (name
    ``"tokens"``) from ``draws``."""
    n = num_draws(sampling.name)
    noise = draws.gumbel("tokens", (n,) + tuple(logits.shape), logits.device) if n else None
    return sample_tokens(logits, sampling.name, sampling.temperature,
                         sampling.top_k, sampling.top_p, noise=noise)


@dataclass
class SeqLenState:
    """EMA histogram over the number of elements (`nn_lib.py:26-52`),
    weight 0.999."""

    probs: torch.Tensor  # (max_elements,) float32

    @classmethod
    def init(cls, max_elements: int, device) -> "SeqLenState":
        return cls(torch.full((max_elements,), 1.0 / max_elements, device=device))

    def update(self, elem_mask: torch.Tensor, weight: float = 0.999) -> "SeqLenState":
        n = self.probs.shape[0]
        counts = torch.bincount(elem_mask.sum(dim=1), minlength=n + 1)[: n + 1]
        batch_prob = counts[1:].to(torch.float32) / elem_mask.shape[0]
        return SeqLenState(self.probs * weight + (1 - weight) * batch_prob)

    def sample(self, batch_size: int, draws) -> torch.Tensor:
        """Element counts in [1, max_elements] (`nn_lib.py:47-52`): the
        categorical draw as argmax(log p + Gumbel), its noise (name
        ``"seq_len"``, (B, max_elements)) from ``draws``."""
        logp = torch.log(self.probs + 1e-12)
        g = as_draws(draws).gumbel("seq_len", (batch_size, logp.shape[0]), logp.device)
        return torch.argmax(logp + g, dim=-1) + 1


def cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Masked mean CE with optional label smoothing (torch semantics)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if label_smoothing > 0:
        nll = (1 - label_smoothing) * nll + label_smoothing * (-logp.mean(dim=-1))
    if mask is None:
        return nll.mean()
    return masked_mean(nll, mask)


# the data group and its size while a data-parallel step computes a rank's loss
_FULL_BATCH: List[Tuple[object, int]] = []


@contextmanager
def full_batch_means(group, n: int):
    """Within, `masked_mean` divides by the count of the whole batch, summed
    over the ``n`` ranks of ``group``, and scales by ``n``: the ranks' mean
    of their losses (and of their gradients) is then the full batch's
    masked mean, as the JAX package's data-parallel step computes it over a
    sharded batch."""
    _FULL_BATCH.append((group, n))
    try:
        yield
    finally:
        _FULL_BATCH.pop()


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(values where mask) / max(#mask, 1); the count is the full
    batch's inside `full_batch_means`."""
    total = torch.where(mask, values, 0.0).sum()
    count = mask.sum()
    if _FULL_BATCH:
        group, n = _FULL_BATCH[-1]
        dist.all_reduce(count, group=group)
        total = total * n
    return total / torch.clamp(count, min=1)


class TokenModel:
    """What every zoo family shares: the tokenizer, the device, a
    timestep-free `CategoricalTransformer` built on it, and decoding.  The
    zoo's samplers split one stream per batch, so they take no per-row
    seeds, and they take no guidance (`serve_cli` reads these flags)."""

    supports_per_row_keys = False
    supports_guidance = False

    def __init__(self, backbone, tokenizer, model_cfg, dtype, device, generator,
                 pos_emb="default", lookahead=True, **switches):
        import dataclasses

        from layoutdm_tpu_torch.configs import ModelConfig

        self.tokenizer = tokenizer
        self.cfg = model_cfg or ModelConfig()
        self.device = require_device(device)
        self.seq_len = tokenizer.max_token_length
        self.num_classes = tokenizer.N_total
        self.pad_id = tokenizer.name_to_id("pad")
        self.backbone_cfg = dataclasses.replace(backbone, timestep_type=None)
        self.net = make_transformer(
            self.device, generator,
            backbone=self.backbone_cfg,
            num_classes=self.num_classes,
            max_token_length=self.seq_len,
            pos_emb=pos_emb,
            n_attr_per_elem=tokenizer.N_var_per_element,
            dtype=dtype,
            lookahead=lookahead,
            **switches,
        )

    @property
    def denoiser_path(self) -> str:
        return denoiser_path(self.net)

    def init_state(self):
        return None

    def _apply(self, seq, padding_mask=None, dropout=None):
        return self.net(seq, None, dropout, key_padding_mask=padding_mask)

    def _encode(self, batch) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device) for k, v in self.tokenizer.encode(batch).items()}

    @staticmethod
    def _dropout(generator, is_train: bool, dropout: Optional[Dropout]) -> Optional[Dropout]:
        """Training mode's dropout: the one given, else drawn from the
        generator (of a `Draws` too); none in evaluation."""
        if not is_train:
            return None
        return dropout or as_draws(generator).dropout()

    def sample_ids(self, rng, batch_size, cond=None, sampling=None, **kw):
        raise NotImplementedError

    def sample(self, rng, batch_size, cond=None, sampling=None, **kw):
        """Sample and decode to {bbox, label, mask}."""
        ids = self.sample_ids(rng, batch_size, cond, sampling, **kw)
        return self.tokenizer.decode(ids)
