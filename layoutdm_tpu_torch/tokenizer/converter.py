"""Full-vocab <-> per-attribute partial-vocab routing (port of
``layoutdm_tpu/tokenizer/converter.py``; reference
`helpers/layout_tokenizer.py:414-568`).

Every partial vocabulary is padded to one width ``Vp = max(N_cat, num_bins)
+ 2``: lanes ``0 .. n_normal[a]-1`` are the attribute's normal tokens (PAD
included), lanes ``n_normal[a] .. Vp-2`` are dead (pinned to LOG_EPS) and
lane ``Vp-1`` is MASK.  The JAX package routes log-probs with one-hot
matmuls, a TPU choice (minor-dim gathers are slow there); on the GPU each
direction is one index gather, which yields the same values: a one-hot
matmul adds one term times 1.0 to exact zeros.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from layoutdm_tpu_torch.ops.log_math import LOG_EPS
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer


class Converter:
    """Routing tables as host numpy (``p2f``, ``f2p``, ``lane_valid``) plus
    their device copies, made once per device."""

    def __init__(self, A, Vf, Vp, n_normal, p2f, f2p, lane_valid):
        self.A = A  # attributes per element (5)
        self.Vf = Vf  # full vocab size (tokenizer.N_total)
        self.Vp = Vp  # padded partial vocab width
        self.n_normal = n_normal  # (A,) normal lanes per attr
        self.p2f = p2f  # (A, Vp) partial lane -> full id (dead lanes -> 0)
        self.f2p = f2p  # (A, Vf) full id -> partial lane (-1 if absent)
        self.lane_valid = lane_valid  # (A, Vp) bool
        self._dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    @classmethod
    def build(cls, tok: LayoutSequenceTokenizer) -> "Converter":
        # the partial vocabularies cover attribute tokens + PAD + MASK only;
        # BOS/EOS ids have no lane (`layout_tokenizer.py:407-408`)
        if set(tok.special_tokens) != {"pad", "mask"}:
            raise ValueError(
                "constrained diffusion requires special_tokens ('pad','mask'); "
                f"got {tok.special_tokens}"
            )
        A = tok.N_var_per_element
        Vf = tok.N_total
        pad_id, mask_id = tok.name_to_id("pad"), tok.name_to_id("mask")

        # mat_size per attr (`constrained.py:50-54`)
        mat_size = [tok.N_category + 2] + [tok.N_bbox_per_var + 2] * (A - 1)
        Vp = max(mat_size)

        p2f = np.zeros((A, Vp), dtype=np.int64)
        f2p = np.full((A, Vf), -1, dtype=np.int64)
        lane_valid = np.zeros((A, Vp), dtype=bool)
        n_normal = np.asarray(mat_size, dtype=np.int64) - 1

        for a, key in enumerate(tok.var_names):
            if key == "c":
                full_ids = list(range(tok.N_category))
            else:
                sl = tok.get_slice(key)
                full_ids = list(range(sl.start, sl.stop))
            full_ids = full_ids + [pad_id]  # normal lanes, then MASK last
            for lane, fid in enumerate(full_ids):
                p2f[a, lane] = fid
                f2p[a, fid] = lane
                lane_valid[a, lane] = True
            p2f[a, Vp - 1] = mask_id
            f2p[a, mask_id] = Vp - 1
            lane_valid[a, Vp - 1] = True
        return cls(A, Vf, Vp, n_normal, p2f, f2p, lane_valid)

    def tables(self, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            # normal tensors even when a chain under inference mode builds
            # them first, so that a later train step may save them
            with torch.inference_mode(False):
                t = {
                    "p2f": torch.as_tensor(self.p2f, device=device),
                    "f2p": torch.as_tensor(np.maximum(self.f2p, 0), device=device),
                    "present": torch.as_tensor(self.f2p >= 0, device=device),
                    "lane_valid": torch.as_tensor(self.lane_valid, device=device),
                    "f2p_flat": torch.as_tensor(
                        np.maximum(self.f2p, 0).reshape(-1), device=device
                    ),
                    "p2f_flat": torch.as_tensor(
                        self.p2f.reshape(-1), device=device
                    ),
                }
            self._dev[device] = t
        return t

    # ---- log-prob conversion (vocab-last layout) --------------------------
    def f_to_p_log(self, log_full: torch.Tensor) -> torch.Tensor:
        """(B, S, A, Vf) -> (B, S, A, Vp); dead lanes get LOG_EPS."""
        t = self.tables(log_full.device)
        idx = t["p2f"].expand(log_full.shape[:-1] + (self.Vp,))
        picked = torch.gather(log_full, -1, idx)
        return torch.where(t["lane_valid"], picked, LOG_EPS)

    def p_to_f_log(self, log_part: torch.Tensor) -> torch.Tensor:
        """(B, S, A, Vp) -> (B, S, A, Vf); absent ids get LOG_EPS."""
        t = self.tables(log_part.device)
        idx = t["f2p"].expand(log_part.shape[:-1] + (self.Vf,))
        placed = torch.gather(log_part, -1, idx)
        return torch.where(t["present"], placed, LOG_EPS)

    # ---- id conversion ----------------------------------------------------
    def f_to_p_id(self, ids_full: torch.Tensor) -> torch.Tensor:
        """(B, S, A) full ids -> partial lanes (`layout_tokenizer.py:523-538`)."""
        t = self.tables(ids_full.device)
        offs = torch.arange(self.A, device=ids_full.device) * self.Vf
        return t["f2p_flat"][ids_full + offs]

    def p_to_f_id(self, ids_part: torch.Tensor) -> torch.Tensor:
        """(B, S, A) partial lanes -> full ids (`layout_tokenizer.py:499-513`)."""
        t = self.tables(ids_part.device)
        offs = torch.arange(self.A, device=ids_part.device) * self.Vp
        return t["p2f_flat"][ids_part + offs]
