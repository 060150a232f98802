"""What a chain holds fixed (reference implementation; no import of the
program).  The benchmark's cells sample unconditionally: nothing is held,
every token starts as MASK, and PAD may be drawn anywhere.  A cell with a
conditional task (LayoutDM's ``c``, ``cwh``, ``partial``, ``refinement``)
adds its held positions, forbidden PAD and prior here."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from perfbench.reference.tokens import Vocab


@dataclass
class Cond:
    """(B, S) start ids, held positions, PAD forbidden; (B, S, V) prior."""

    start: torch.Tensor
    held: torch.Tensor
    no_pad: torch.Tensor
    prior: Optional[torch.Tensor]

    def to(self, device) -> "Cond":
        return Cond(*(None if x is None else x.to(device)
                      for x in (self.start, self.held, self.no_pad, self.prior)))


def unconditional(v: Vocab, B: int) -> Cond:
    z = torch.zeros((B, v.seq_len), dtype=torch.bool)
    return Cond(torch.full((B, v.seq_len), v.mask), z, z.clone(), None)
