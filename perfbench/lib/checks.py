"""The comparisons that decide ``correct``: the program's recorded chains
and training steps against the plain reference (``perfbench/reference``),
which reads the program's outputs only to judge them."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from perfbench.reference import denoiser, diffusion, noise
from perfbench.reference.diffusion import LOG0
from perfbench.reference.tasks import Cond


class reference_precision:
    """Float32 products with TF32 off, for the reference's stretch."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def chain_gaps(diff: diffusion.Diffusion, params: Dict, cfg: Dict, steps: torch.Tensor,
               final: torch.Tensor, cond: Cond, noise_of: Callable[[int], torch.Tensor],
               block_tokens: int = 128_000) -> Dict:
    """One recorded chain: ``steps`` (n, R, S) the ids each step started
    from, ``final`` (R, S) what it returned, ``cond`` the rows' task,
    ``noise_of(i)`` (R, S, V) step i's Gumbel noise.  For each step the
    reference works out the log-probs the step samples from, from the
    program's ids, and adds the noise; the gap of a token is by how much
    its score lies below the best score.  Returns the gaps' sum over every
    token drawn, the draws and the start's mismatches.  (The widest gap
    does not separate the program from its lower-precision control: it
    grows with the draws checked.  The mean gap does: a token flips with a
    chance and by an amount that both grow with the error of the scores.)"""
    T = diff.T
    n, R, S = steps.shape
    if n != T:
        return {"steps_missing": abs(T - n), "gap_sum": float("inf"), "draws": 1}
    x = steps.long()
    nxt = torch.cat([x[1:], final.long()[None]])
    V = diff.vocab.size
    held_log = torch.where(torch.arange(V, device=x.device) == cond.start[..., None], 0.0, LOG0)
    pad_lane = torch.arange(V, device=x.device) == diff.vocab.pad
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    per = max(1, block_tokens // (R * S))
    for i0 in range(0, n, per):
        i1 = min(n, i0 + per)
        ids = x[i0:i1].reshape(-1, S)
        t = (T - 1 - torch.arange(i0, i1, device=x.device)).repeat_interleave(R)
        lx0 = diffusion.predict_start(denoiser.forward(params, cfg, ids, t))
        mlp = diff.posterior(lx0, ids, t).view(i1 - i0, R, S, V)
        mlp = torch.where(cond.held[None, ..., None], held_log[None], mlp)
        if cond.prior is not None:
            mlp = mlp + cond.prior[None]
        mlp = torch.where(cond.no_pad[None, ..., None] & pad_lane, LOG0, mlp)
        score = mlp + torch.stack([noise_of(i) for i in range(i0, i1)])
        got = score.gather(-1, nxt[i0:i1, ..., None])[..., 0]
        total += (score.max(-1).values - got).double().sum()
    return {"gap_sum": float(total), "draws": n * R * S,
            "start_mismatch": int((x[0] != cond.start).sum())}


def merge(results: List[Dict]) -> Dict:
    """Several chains' results: counts added up, and the mean gap of a
    token over every draw (``token_gap_mean``)."""
    out: Dict = {"start_mismatch": 0, "steps_missing": 0}
    gap, draws = 0.0, 0
    for r in results:
        gap += r["gap_sum"]
        draws += r["draws"]
        for k in out:
            out[k] += r.get(k, 0)
    out["token_gap_mean"] = gap / draws if draws else float("inf")
    return out


def generator_noise_of(states: List[torch.Tensor], rows, shape, device):
    idx = torch.as_tensor(rows, device=device)

    def f(i):
        return noise.generator_noise(states[i], shape, device).index_select(0, idx)

    return f


def decode_mismatch(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]) -> int:
    """Elements whose validity, category or box differ between the
    reference's decoding of the returned ids and the program's answer."""
    m = ref["mask"].cpu()
    bad = (m != got["mask"].cpu())
    bad |= m & (ref["label"].cpu() != got["label"].cpu())
    bad |= m & ((ref["bbox"].cpu() - got["bbox"].cpu()).abs() > 1e-6).any(-1)
    return int(bad.sum())
