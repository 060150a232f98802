"""The noise of the reverse chain, as the sampler's contract states it
(reference implementation; no import of the program).

The random sampler picks ``argmax(log_probs + G)`` with Gumbel noise
``G = -log(-log(u + 1e-30) + 1e-30)``, one draw of the log-probs' shape
(B, S, V) a step.  In a batch job ``u`` comes from the ``torch.Generator``
the caller hands the chain, as ``torch.rand((1, B, S, V))`` in float32
each step.
"""

from __future__ import annotations

import torch


def gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u + 1e-30) + 1e-30)


def generator_noise(state: torch.Tensor, shape, device) -> torch.Tensor:
    """The Gumbel draw a chain step makes from a generator whose state
    before the draw was ``state``."""
    g = torch.Generator(device=device)
    g.set_state(state)
    return gumbel(torch.rand((1,) + tuple(shape), generator=g, device=device)[0])
