"""Token samplers over logits (port of ``layoutdm_tpu/ops/samplers.py``).

Vocabulary is the LAST axis.  JAX's ``jax.random.categorical`` is
argmax(logits + Gumbel noise); here the Gumbel noise is an ARGUMENT
(``noise``), so a test can hand both packages the same draws, or it is drawn
from a passed ``torch.Generator``.  The ``gumbel`` strategy layers a second
Gumbel draw on top of the categorical one (reference `sampling.py:112-116`),
so it takes two draws: ``noise[0]`` is the explicit layer, ``noise[1]`` the
categorical draw.

For request coalescing the reverse chain needs noise that depends only on a
row's own seed; `row_gumbel` is a counter-based draw keyed by
(row seed, counter) — murmur3's 32-bit finalizer over the lane index — so a
row's noise never depends on its batch-mates.

`RowShard` is the data-parallel trainer's view of a batch: each rank draws
the whole batch's noise from the same stream and keeps its own rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

NEG_INF = -float("inf")

_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class RowShard:
    """Rows [lo, hi) of a batch of ``total`` rows, the ones a data-parallel
    rank holds.  `draw` makes a batch-led draw at the whole batch's shape
    and keeps these rows, so every rank consumes its generator as a single
    process would and holds that process's noise for its rows."""

    lo: int
    hi: int
    total: int

    def draw(self, fn: Callable[[tuple], torch.Tensor], shape) -> torch.Tensor:
        """``fn(shape)`` for a scalar draw; ``fn((total, ...))[lo:hi]`` for
        one whose leading dim is the shard's rows."""
        shape = tuple(shape)
        if not shape:
            return fn(shape)
        if shape[0] != self.hi - self.lo:
            raise ValueError(f"a draw of shape {shape} is not led by the shard's "
                             f"{self.hi - self.lo} rows")
        return fn((self.total,) + shape[1:])[self.lo:self.hi]


def draw_rows(rows: Optional[RowShard], fn: Callable[[tuple], torch.Tensor], shape):
    """``fn(shape)``, through ``rows`` where a shard is given."""
    return fn(tuple(shape)) if rows is None else rows.draw(fn, shape)


def num_draws(name: str) -> int:
    """How many Gumbel draws of the logits' shape ``name`` consumes."""
    if name == "deterministic":
        return 0
    return 2 if name == "gumbel" else 1


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The reference's explicit Gumbel construction (`base.py:167-174`)."""
    return -torch.log(-torch.log(u + 1e-30) + 1e-30)


def gumbel_noise(
    generator: torch.Generator, shape, device=None, dtype=torch.float32
) -> torch.Tensor:
    """Gumbel noise on ``device``, drawn on the generator's own device: a CPU
    generator gives the same draws whatever ``device`` is (at the cost of a
    copy), a generator on ``device`` draws in place."""
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=dtype)
    return gumbel_from_uniform(u if device is None else u.to(device))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32), split in 16-bit
    halves so no int64 product overflows."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer (a bijection with full avalanche)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def row_uniform(seeds: torch.Tensor, counter: int, n: int) -> torch.Tensor:
    """(B, n) float32 uniforms in (0, 1); row b depends only on
    (seeds[b], counter).  ``seeds``: (B,) int64 in [0, 2**32)."""
    c = torch.full_like(seeds, (counter + 1) & _M32)
    key = _fmix32(seeds ^ _mul32(c, 0x9E3779B9))  # (B,)
    lanes = torch.arange(n, dtype=torch.int64, device=seeds.device)
    h = _fmix32((_mul32(lanes, 0x632BE5AB)[None, :] + key[:, None]) & _M32)
    h = _fmix32(h ^ key[:, None])
    # 24 random bits -> (0, 1), exactly representable in float32
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def row_gumbel(seeds: torch.Tensor, counter: int, shape) -> torch.Tensor:
    """Gumbel noise of ``shape`` (leading dim B = len(seeds)), row-keyed."""
    B = shape[0]
    n = 1
    for s in shape[1:]:
        n *= s
    u = row_uniform(seeds, counter, n).reshape(B, *shape[1:])
    return gumbel_from_uniform(u)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k most likely lanes, -inf the rest (`sampling.py:73-78`)."""
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering (`sampling.py:94-109`): drop lanes once the
    cumulative probability of more-likely lanes exceeds p, always keeping the
    most likely lane.  Stable argsorts, as in the JAX package."""
    sorted_logits = torch.flip(torch.sort(logits, dim=-1).values, dims=[-1])
    order = torch.argsort(-logits, dim=-1, stable=True)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    rank = torch.arange(logits.shape[-1], device=logits.device)
    drop = (cum > p) & (rank > 0)
    sorted_kept = torch.where(drop, NEG_INF, sorted_logits)
    inv = torch.argsort(order, dim=-1, stable=True)
    return torch.gather(sorted_kept, -1, inv)


def sample_tokens(
    logits: torch.Tensor,
    name: str = "random",
    temperature: float = 1.0,
    top_k: int = 5,
    top_p: float = 0.9,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sample token ids of shape ``logits.shape[:-1]`` (`sampling.py:81-130`).

    ``noise``: (num_draws(name),) + logits.shape Gumbel noise; drawn from
    ``generator`` when omitted."""
    if name == "deterministic":
        return torch.argmax(logits, dim=-1)
    if noise is None:
        noise = gumbel_noise(
            generator, (num_draws(name),) + tuple(logits.shape),
            device=logits.device, dtype=logits.dtype,
        )

    scaled = logits / temperature
    if name == "top_k":
        scaled = top_k_filter(scaled, k=top_k)
    elif name == "top_p":
        scaled = top_p_filter(scaled, p=top_p)
    elif name == "top_k_top_p":
        scaled = top_p_filter(top_k_filter(scaled, k=top_k), p=top_p)
    elif name == "gumbel":
        scaled = scaled + noise[0]
    elif name != "random":
        raise NotImplementedError(name)
    return torch.argmax(scaled + noise[-1], dim=-1)
