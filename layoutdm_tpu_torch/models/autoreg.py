"""LayoutTransformer: a decoder-only autoregressive model (port of
``layoutdm_tpu/models/autoreg.py``; reference
`models/elem_wise_autoreg.py:24-156`).

Training is next-token CE (label smoothing 0.1, PAD ignored) over BOS +
sequence under the causal mask.  Sampling decodes token by token with
per-slot vocabulary legality, the user's tokens forced and the refinement
prior added: by default one token a step through the stack against
per-layer key/value caches (`models.nn.KVCache`), or, with
``use_cache=False``, by recomputing the whole prefix each step as the
reference does (kept to hold the two against each other).  The
attention takes the causal mask, so it runs on the plain path.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from layoutdm_tpu_torch.configs import BackboneConfig, ModelConfig, SamplingConfig
from layoutdm_tpu_torch.models.base import TokenModel, as_draws, cross_entropy, sample_logits
from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond
from layoutdm_tpu_torch.models.nn import Dropout
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer


class ElemWiseAutoreg(TokenModel):
    def __init__(
        self,
        backbone: BackboneConfig,
        tokenizer: LayoutSequenceTokenizer,
        model_cfg: Optional[ModelConfig] = None,
        pos_emb: str = "default",
        dtype=torch.float32,
        device="cuda",
        generator: Optional[torch.Generator] = None,
        **switches,
    ):
        if "bos" not in tokenizer.special_tokens:
            raise ValueError("the autoregressive model needs a BOS token")
        # the token length includes BOS; decode positions exclude it
        super().__init__(backbone, tokenizer, model_cfg, dtype, device, generator,
                         pos_emb=pos_emb, lookahead=False, **switches)
        self.gen_len = self.seq_len - 1
        self.bos_id = tokenizer.name_to_id("bos")
        # -1 when there is no [MASK]: every slot then takes the given token
        # of a condition, or the prediction unconditionally
        self.mask_id = (tokenizer.name_to_id("mask")
                        if "mask" in tokenizer.special_tokens else -1)
        self._legal = torch.as_tensor(tokenizer.token_mask(), device=self.device)  # (L, V)

    def preprocess(self, batch: Dict, generator=None) -> Dict[str, torch.Tensor]:
        """input = seq[:-1], target = seq[1:] (`elem_wise_autoreg.py:140-145`)."""
        tokens = self._encode(batch)
        return {"seq": tokens["seq"][:, :-1], "target": tokens["seq"][:, 1:],
                "mask": tokens["mask"][:, 1:]}

    def loss(self, tokens, state, generator, is_train: bool = True,
             dropout: Optional[Dropout] = None):
        logits = self._apply(tokens["seq"], dropout=self._dropout(generator, is_train, dropout))
        nll = cross_entropy(logits, tokens["target"], tokens["target"] != self.pad_id,
                            label_smoothing=0.1)
        return {"nll_loss": nll}, state

    def _condition(self, batch_size, cond):
        """(given tokens, weak prior, where it applies), without the BOS
        column, each (B, L[, V])."""
        B, L = batch_size, self.gen_len
        if cond is None:
            return (torch.full((B, L), self.mask_id, dtype=torch.int64, device=self.device),
                    torch.zeros((B, 1, 1), device=self.device),
                    torch.zeros((B, L), dtype=torch.bool, device=self.device))
        cond = cond.to(self.device)

        def drop_bos(x):
            return x[:, 1:] if x.shape[1] == L + 1 else x

        return drop_bos(cond.seq.long()), drop_bos(cond.weak_logits), drop_bos(cond.weak_mask)

    @torch.inference_mode()
    def sample_ids(
        self,
        rng,
        batch_size: int,
        cond: Optional[SamplerCond] = None,
        sampling: Optional[SamplingConfig] = None,
        use_cache: bool = True,
        **_unused,
    ) -> torch.Tensor:
        """Token-by-token causal decode (`elem_wise_autoreg.py:74-138`);
        returns the generated ids without the BOS column.  ``rng``: a
        torch.Generator or a `Draws` (``"tokens"``)."""
        sampling = sampling or SamplingConfig()
        draws = as_draws(rng)
        B, L = batch_size, self.gen_len
        given_all, weak, weak_mask = self._condition(B, cond)

        def constrain_and_sample(logit_i, i):
            w = weak[:, i] if weak.shape[1] > 1 else weak[:, 0]
            logit_i = logit_i + torch.where(weak_mask[:, i][:, None], w, 0.0)
            logit_i = logit_i.masked_fill(~self._legal[i][None, :], -torch.inf)
            pred = sample_logits(logit_i, sampling, draws)
            given = given_all[:, i]  # forced (`elem_wise_autoreg.py:128-133`)
            return torch.where(given == self.mask_id, pred, given)

        preds = []
        if use_cache:
            cache = self.net.new_cache(B)
            tok = torch.full((B, 1), self.bos_id, dtype=torch.int64, device=self.device)
            for i in range(L):
                pred = constrain_and_sample(self.net.decode_step(tok, cache)[:, 0], i)
                preds.append(pred)
                tok = pred[:, None]
        else:
            # a fixed-length buffer [BOS, ...]; step i fills position i + 1
            buf = torch.full((B, L), self.bos_id, dtype=torch.int64, device=self.device)
            for i in range(L):
                pred = constrain_and_sample(self._apply(buf)[:, i], i)
                preds.append(pred)
                if i + 1 < L:
                    buf[:, i + 1] = pred
        return torch.stack(preds, dim=1)
