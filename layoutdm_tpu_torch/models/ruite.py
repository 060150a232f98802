"""RUITE: a one-shot layout denoiser, the refinement baseline (port of
``layoutdm_tpu/models/ruite.py``; reference `models/ruite.py:22-124`).

Encodes a noise-perturbed layout and predicts the clean tokens with CE
(PAD targets ignored); sampling is one forward pass with the user-known
tokens put back.  The ``ruite`` experiment's loader adds the noise
(``AddNoiseToBBox`` draws from the loader's numpy generator and keeps
``bbox_orig``); `RUITE.preprocess` adds it only where the loader did not.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from layoutdm_tpu_torch.configs import BackboneConfig, ModelConfig, SamplingConfig
from layoutdm_tpu_torch.models.base import TokenModel, as_draws, cross_entropy, sample_logits
from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond
from layoutdm_tpu_torch.models.nn import Dropout
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer


class RUITE(TokenModel):
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
        super().__init__(backbone, tokenizer, model_cfg, dtype, device, generator,
                         pos_emb="default", **switches)

    def preprocess(self, batch: Dict, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """Noisy input -> clean target (`ruite.py:102-114`)."""
        if "bbox_orig" in batch:
            noisy, clean = batch["bbox"], batch["bbox_orig"]
        else:
            if generator is None:
                raise ValueError("RUITE adds box noise with a generator")
            clean = torch.as_tensor(batch["bbox"], dtype=torch.float32)
            noise = 0.05 * torch.randn(clean.shape, generator=generator,
                                       device=generator.device).to(clean.device)
            mask = torch.as_tensor(batch["mask"], dtype=torch.float32)
            noisy = clean + noise * mask[..., None]
        inputs = self._encode({"label": batch["label"], "mask": batch["mask"], "bbox": noisy})
        targets = self._encode({"label": batch["label"], "mask": batch["mask"], "bbox": clean})
        return {"seq": inputs["seq"], "mask": inputs["mask"], "target": targets["seq"]}

    def loss(self, tokens, state, generator, is_train: bool = True,
             dropout: Optional[Dropout] = None):
        """CE ignoring PAD targets (`ruite.py:52-54`)."""
        logits = self._apply(tokens["seq"], ~tokens["mask"],
                             self._dropout(generator, is_train, dropout))
        nll = cross_entropy(logits, tokens["target"], tokens["target"] != self.pad_id)
        return {"nll_loss": nll}, state

    @torch.inference_mode()
    def sample_ids(
        self,
        rng,
        batch_size: int,
        cond: Optional[SamplerCond] = None,
        sampling: Optional[SamplingConfig] = None,
        **_unused,
    ) -> torch.Tensor:
        sampling = sampling or SamplingConfig()
        if cond is None:
            # RUITE cannot generate unconditionally: a dummy layout (`ruite.py:91-97`)
            seq = torch.full((batch_size, self.seq_len), self.pad_id, dtype=torch.int64,
                             device=self.device)
            seq[:, 0] = 0
            seq[:, 1:5] = self.tokenizer.N_category
            return seq
        cond = cond.to(self.device)
        logits = self._apply(cond.seq, cond.seq == self.pad_id)
        seq = sample_logits(logits, sampling, as_draws(rng))
        return torch.where(cond.strong_mask, cond.seq, seq)
