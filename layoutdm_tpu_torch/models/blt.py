"""BLT: grouped iterative decoding, category -> size -> position (port of
``layoutdm_tpu/models/blt.py``; reference `models/blt.py:39-236`).

The masked-token transformer of MaskGIT, decoded in three attribute groups
(``TARGET_ATTRS``, `blt.py:27`), each refined for T/3 steps; training masks
a random count of one random attribute group per sample.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from layoutdm_tpu_torch.configs import BackboneConfig, ModelConfig, SamplingConfig
from layoutdm_tpu_torch.models.base import SeqLenState, as_draws, sample_logits
from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond
from layoutdm_tpu_torch.models.maskgit import MaskGIT
from layoutdm_tpu_torch.models.nn import Dropout
from layoutdm_tpu_torch.ops.masking import batch_topk_mask
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer

TARGET_ATTRS = (("c",), ("w", "h"), ("x", "y"))  # `blt.py:27`


class BLT(MaskGIT):
    def __init__(
        self,
        backbone: BackboneConfig,
        tokenizer: LayoutSequenceTokenizer,
        model_cfg: Optional[ModelConfig] = None,
        dtype=torch.float32,
        device="cuda",
        generator: Optional[torch.Generator] = None,
        **switches,
    ):
        if tokenizer.var_names != ("c", "x", "y", "w", "h"):
            raise ValueError(f"BLT needs var order c-x-y-w-h, got {tokenizer.var_names}")
        super().__init__(backbone, tokenizer, model_cfg, dtype=dtype, device=device,
                         generator=generator, **switches)
        C = tokenizer.N_var_per_element
        # (3, C): which attribute slots belong to each group
        groups = np.zeros((len(TARGET_ATTRS), C), bool)
        for g, attrs in enumerate(TARGET_ATTRS):
            for a in attrs:
                groups[g, tokenizer.var_names.index(a)] = True
        self.group_attr = torch.as_tensor(groups, device=self.device)

    def loss(self, tokens, state: SeqLenState, generator, is_train: bool = True,
             dropout: Optional[Dropout] = None):
        """Mask a random count of one random attribute group per sample
        (`blt.py:192-226`); plain CE (`blt.py:74`).  ``generator``: a
        torch.Generator or a `Draws` (``"group"`` (B,) ints in [0, 3),
        ``"count"`` (B,) and ``"scores"`` (B, S) uniforms)."""
        draws = as_draws(generator)
        seq, mask = tokens["seq"], tokens["mask"]
        B, S = seq.shape
        dev = seq.device
        C = self.tokenizer.N_var_per_element
        grp = draws.randint("group", len(TARGET_ATTRS), (B,), dev)
        attr_of_slot = torch.arange(S, device=dev) % C
        candidates = self.group_attr[grp][:, attr_of_slot] & mask
        # a uniform count in [1, #candidates] (`blt.py:30-36`)
        n_cand = candidates.sum(dim=1)
        topk = (draws.uniform("count", (B,), dev) * n_cand).to(torch.int32) + 1
        topk = torch.minimum(topk, torch.clamp(n_cand, min=1).to(torch.int32))
        scores = draws.uniform("scores", (B, S), dev)
        loss_mask, _ = batch_topk_mask(scores, topk, mask=candidates)
        return self._loss_on(tokens, loss_mask, state, draws, is_train, dropout, 0.0)

    @torch.inference_mode()
    def sample_ids(
        self,
        rng,
        batch_size: int,
        cond: Optional[SamplerCond] = None,
        sampling: Optional[SamplingConfig] = None,
        state: Optional[SeqLenState] = None,
        num_timesteps_eval: Optional[int] = None,
        **_unused,
    ) -> torch.Tensor:
        """Three grouped refinement phases of T/3 steps (`blt.py:98-190`)."""
        sampling = sampling or SamplingConfig()
        total_T = num_timesteps_eval or sampling.num_timesteps or 9
        if total_T % 3:
            raise ValueError(f"BLT decodes in 3 groups: {total_T} steps is not a multiple of 3")
        T = total_T // 3
        draws = as_draws(rng)
        seq, mask_user, _ = self._initial(batch_size, cond, state, draws)
        B, S = seq.shape
        C = self.tokenizer.N_var_per_element
        seq_user = seq
        padding_mask = (seq == self.pad_id) & mask_user  # `blt.py:126-159`
        illegal = ~self._legal[None].expand(B, S, self.num_classes)
        attr_of_slot = torch.arange(S, device=self.device) % C

        for g in range(len(TARGET_ATTRS)):
            keep_attr = ~self.group_attr[g][attr_of_slot][None, :].expand(B, S)
            n_free = (~(mask_user | keep_attr)).sum(dim=1).to(torch.float32)
            for t in range(T):
                ratio = (torch.tensor(float(T - (t + 1)), dtype=torch.float32) / T).to(self.device)
                logits = self._apply(seq, padding_mask).masked_fill(illegal, -torch.inf)
                seq_pred = sample_logits(logits, sampling, draws)
                conf = torch.gather(logits, -1, seq_pred[..., None])[..., 0]
                upd = (seq == self.mask_id) & ~keep_attr
                new_seq = torch.where(upd, seq_pred, seq)
                if t < T - 1:
                    topk = (n_free * ratio).to(torch.int32)
                    unconfident, _ = batch_topk_mask(-conf, topk, mask=upd)
                    new_seq = torch.where(unconfident, self.mask_id, new_seq)
                seq = torch.where(mask_user, seq_user, new_seq)
        return seq
