"""MaskGIT: masked-token training and iterative parallel decoding (port of
``layoutdm_tpu/models/maskgit.py``; reference `models/maskgit.py:84-297`).

The T-step decode predicts every token, keeps the most confident and
re-masks the rest; the element-count histogram (`SeqLenState`) is explicit
state.  Attention always gets the key-padding mask of the user-fixed PAD
slots, as in the JAX package, so it runs on the plain path (the kernels
decline masks); under ``fused_ffn`` the FFN of each step runs on K3.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from layoutdm_tpu_torch.configs import BackboneConfig, ModelConfig, SamplingConfig
from layoutdm_tpu_torch.models.base import (
    SeqLenState,
    TokenModel,
    as_draws,
    cross_entropy,
    sample_logits,
)
from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond
from layoutdm_tpu_torch.models.nn import Dropout
from layoutdm_tpu_torch.ops.masking import batch_topk_mask, sample_mask
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer


def mask_schedule(ratio: torch.Tensor, schedule: str = "cosine",
                  total_unknown: Optional[int] = None) -> torch.Tensor:
    """Mask-rate schedule R(ratio) (`maskgit.py:33-71`), float32;
    ``total_unknown`` feeds the log/exp variants."""
    ratio = torch.as_tensor(ratio, dtype=torch.float32)
    if schedule == "linear":
        r = 1.0 - ratio
    elif schedule == "cosine":
        r = torch.cos(math.pi * 0.5 * ratio)
    elif schedule == "square":
        r = 1.0 - ratio**2
    elif schedule == "cubic":
        r = 1.0 - ratio**3
    elif schedule == "sqrt":
        r = 1.0 - torch.sqrt(ratio)
    elif schedule == "log":
        r = -torch.log2(ratio) / math.log2(float(total_unknown))
    elif schedule == "exp":
        r = 1.0 - torch.exp2(-math.log2(float(total_unknown)) * (1.0 - ratio))
    else:
        raise NotImplementedError(schedule)
    return torch.clamp(r, 1e-6, 1.0)


class MaskGIT(TokenModel):
    def __init__(
        self,
        backbone: BackboneConfig,
        tokenizer: LayoutSequenceTokenizer,
        model_cfg: Optional[ModelConfig] = None,
        mask_schedule_name: str = "cosine",
        use_gumbel_noise: bool = True,
        dtype=torch.float32,
        device="cuda",
        generator: Optional[torch.Generator] = None,
        **switches,
    ):
        super().__init__(backbone, tokenizer, model_cfg, dtype, device, generator,
                         pos_emb="default", **switches)
        self.mask_schedule_name = mask_schedule_name
        self.use_gumbel_noise = use_gumbel_noise
        self.mask_id = tokenizer.name_to_id("mask")
        self._legal = torch.as_tensor(tokenizer.token_mask(), device=self.device)  # (S, V)

    def init_state(self) -> SeqLenState:
        return SeqLenState.init(self.tokenizer.max_elements, self.device)

    # -- training -----------------------------------------------------------
    def preprocess(self, batch: Dict, generator=None) -> Dict[str, torch.Tensor]:
        tokens = self._encode(batch)
        tokens["elem_mask"] = torch.as_tensor(batch["mask"], dtype=torch.bool, device=self.device)
        return tokens

    def _loss_on(self, tokens, loss_mask, state, draws, is_train, dropout,
                 label_smoothing):
        seq, mask = tokens["seq"], tokens["mask"]
        masked = torch.where(loss_mask, self.mask_id, seq)
        logits = self._apply(masked, ~mask, self._dropout(draws, is_train, dropout))
        nll = cross_entropy(logits, seq, loss_mask, label_smoothing)
        new_state = state.update(tokens["elem_mask"]) if is_train else state
        return {"nll_loss": nll}, new_state

    def loss(self, tokens, state: SeqLenState, generator, is_train: bool = True,
             dropout: Optional[Dropout] = None):
        """Masked-token CE with label smoothing 0.1
        (`maskgit.py:129-148,264-286`).  ``generator``: a torch.Generator or
        a `Draws` (draws ``"ratio"`` (B,) and ``"mask"`` (B, S) uniforms);
        ``dropout`` replaces the one drawn from the generator."""
        draws = as_draws(generator)
        seq, mask = tokens["seq"], tokens["mask"]
        B = seq.shape[0]
        ratio = mask_schedule(draws.uniform("ratio", (B,), seq.device),
                              self.mask_schedule_name, total_unknown=self.seq_len)
        loss_mask = sample_mask(mask, ratio, scores=draws.uniform("mask", mask.shape, seq.device))
        return self._loss_on(tokens, loss_mask, state, draws, is_train, dropout, 0.1)

    # -- sampling -----------------------------------------------------------
    def _initial(self, batch_size, cond, state, draws):
        """(seq0, user-fixed slots, whether the element count is known)."""
        S, C = self.seq_len, self.tokenizer.N_var_per_element
        if cond is not None:
            cond = cond.to(self.device)
            known = cond.pad_suppress.any() | ~cond.strong_mask.any()
            return cond.seq.long(), cond.strong_mask, known
        n_el = (state or self.init_state()).sample(batch_size, draws) * C
        valid = torch.arange(S, device=self.device)[None, :] < n_el[:, None]
        seq0 = torch.where(valid, self.mask_id, self.pad_id)
        return seq0, ~valid, torch.ones((), dtype=torch.bool, device=self.device)

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
        """Iterative parallel decode, T steps (`maskgit.py:150-253`).
        ``rng``: a torch.Generator or a `Draws` (``"seq_len"``, ``"tokens"``,
        ``"confidence"``)."""
        sampling = sampling or SamplingConfig()
        T = num_timesteps_eval or sampling.num_timesteps or 10
        draws = as_draws(rng)
        seq0, mask_user, known = self._initial(batch_size, cond, state, draws)
        B, S = seq0.shape
        V = self.num_classes
        # the key-padding mask of the user-fixed PAD slots (`maskgit.py:166-176`)
        padding_mask = (seq0 == self.pad_id) & mask_user
        # PAD is never predicted where the element count is known (`maskgit.py:207-216`)
        pad_lane = torch.arange(V, device=self.device) == self.pad_id
        illegal = ~self._legal[None].expand(B, S, V)
        illegal = illegal | (known & (seq0 != self.pad_id)[..., None] & pad_lane)
        n_free = (~mask_user).sum(dim=1).to(torch.float32)

        seq = seq0
        for t in range(T):
            float_t = torch.tensor(t + 1.0, dtype=torch.float32) / T
            ratio = mask_schedule(float_t, self.mask_schedule_name, total_unknown=self.seq_len)
            is_masked = seq == self.mask_id
            logits = self._apply(seq, padding_mask).masked_fill(illegal, -torch.inf)
            seq_pred = sample_logits(logits, sampling, draws)
            conf = torch.gather(torch.log_softmax(logits, dim=-1), -1, seq_pred[..., None])[..., 0]
            if self.use_gumbel_noise:
                temp_t = sampling.temperature * (1.0 - float_t.to(self.device))
                conf = conf + temp_t * draws.gumbel("confidence", conf.shape, self.device)
            new_seq = torch.where(is_masked, seq_pred, seq)
            # re-mask the least confident predictions, except at the last step
            if t < T - 1:
                topk = (n_free * ratio.to(self.device)).to(torch.int32)
                unconfident, _ = batch_topk_mask(-conf, topk, mask=is_masked)
                new_seq = torch.where(unconfident, self.mask_id, new_seq)
            seq = torch.where(mask_user, seq0, new_seq)
        return seq
