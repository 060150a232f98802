"""The least time a kernel could take on the card: its bytes over the
memory rate or its operations over the peak, whichever is larger (frozen
from the port's ``chip_smoke.bound``).  Bytes count each input once and
each output once; operations count what the attention needs at these
shapes, whatever a kernel reads again."""

from __future__ import annotations

from perfbench.yardstick.peaks import HBM_BYTES_PER_S, PEAK_BF16_FLOPS


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def attention_fwd(B: int, S: int, d: int, elem_bytes: int = 2):
    """(bytes, flops) of one attention forward over a packed (B, S, 3d)
    q|k|v slab: the slab read and the (B, S, d) output written; scores
    and the weighted sum, 2 * 2 * S * S * d a row."""
    return B * S * 4 * d * elem_bytes, 4 * B * S * S * d


def attention_bwd(B: int, S: int, d: int, elem_bytes: int = 2):
    """(bytes, flops) of one attention backward: q, k, v and the output's
    gradient read, the gradients of q, k and v written; the scores again,
    and the four products of the backward, 2 * 5 * S * S * d a row."""
    return B * S * 7 * d * elem_bytes, 10 * B * S * S * d
