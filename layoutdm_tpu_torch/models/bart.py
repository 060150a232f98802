"""BART: an encoder-decoder with constrained autoregressive decoding (port of
``layoutdm_tpu/models/bart.py``; reference `models/bart.py:27-263`).

Training: the encoder sees a task-masked sequence (by default the random
task), the causal decoder reconstructs the whole sequence (teacher forcing,
cross-entropy with PAD ignored).  The backbone shrinks by 21/32 for
parameter parity (`bart.py:62-63`): d_model 336, FFN 1344, 8 heads of 42
at the defaults.

Sampling runs the encoder once, then decodes token by token with the
per-slot vocabulary legality, the condition's tokens forced and, under
``sort_by="category_alphabetical"``, categories in non-decreasing order:
by default one token a step against the self-attention caches and the
cross-attention keys and values projected once from the memory
(``use_cache=True``), or by recomputing the decoder over the whole buffer
each step (``use_cache=False``).  The partial task under the alphabetical
order re-inserts the kept elements on the host (`_reinsert_partial`).  The
encoder's mask-free inference reaches the kernels; the decoder's masked
self-attention and its cross-attention take the plain path.  The encoder
pass runs in the span ``layoutdm.encode`` (with the cross keys and values
on the cached path), each generated token in ``layoutdm.decode_step``
(the decoder, the legality mask, the draw and the forcing), and
``DECODE_STEPS`` counts the cached steps.

Random draws go through `models.base.Draws`: the task's (``ratio`` and
``scores`` for the random task), the target permutation's (``perm``: its
argsort is the permutation), the decode's Gumbel noise (``tokens``) and
the task choice (``task``) where several tasks are trained.
"""

from __future__ import annotations

import dataclasses
import random as _random
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from layoutdm_tpu_torch.configs import BackboneConfig, ModelConfig, SamplingConfig
from layoutdm_tpu_torch.models.base import Draws, as_draws, cross_entropy, sample_logits
from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond
from layoutdm_tpu_torch.models.nn import (
    CategoricalEncDecTransformer,
    Dropout,
    denoiser_path,
    make_module,
)
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer
from layoutdm_tpu_torch.utils.device import require_device
from layoutdm_tpu_torch.utils.profiling import span

# cached decode steps run (one a generated token of a ``use_cache`` decode)
DECODE_STEPS = 0


class BART:
    # one stream for the whole batch and no guidance (`serve_cli`)
    supports_per_row_keys = False
    supports_guidance = False

    def __init__(
        self,
        backbone: BackboneConfig,
        tokenizer: LayoutSequenceTokenizer,
        model_cfg: Optional[ModelConfig] = None,
        sort_by: Optional[str] = None,
        tasks: Sequence[str] = ("random",),
        pos_emb: str = "default",
        dtype=torch.float32,
        device="cuda",
        generator: Optional[torch.Generator] = None,
        **switches,
    ):
        """``switches``: the encoder's denoiser-path keywords
        (`models.nn.Block`); ``fused_ffn`` also puts the decoder's
        full-sequence FFN on K3."""
        if tuple(tokenizer.special_tokens) != ("pad", "bos", "eos", "mask"):
            raise ValueError("BART needs the special tokens pad, bos, eos, mask")
        self.tokenizer = (dataclasses.replace(tokenizer, sort_by=sort_by)
                          if sort_by else tokenizer)
        self.cfg = model_cfg or ModelConfig()
        self.tasks: List[str] = list(tasks)
        self.sort_by = sort_by
        self.device = require_device(device)
        self.seq_len = tokenizer.max_token_length  # BOS included
        self.gen_len = self.seq_len - 1
        self.num_classes = tokenizer.N_total
        self.pad_id = tokenizer.name_to_id("pad")
        self.bos_id = tokenizer.name_to_id("bos")
        self.mask_id = tokenizer.name_to_id("mask")
        self.backbone_cfg = dataclasses.replace(backbone.shrunk(21 / 32), timestep_type=None)
        self.net = make_module(
            CategoricalEncDecTransformer, self.device, generator,
            backbone=self.backbone_cfg,
            num_classes=self.num_classes,
            max_token_length=self.seq_len,
            pos_emb=pos_emb,
            n_attr_per_elem=tokenizer.N_var_per_element,
            dtype=dtype,
            **switches,
        )
        self._legal = torch.as_tensor(self.tokenizer.token_mask(), device=self.device)

    @property
    def denoiser_path(self) -> str:
        return denoiser_path(self.net)

    def init_state(self):
        return None

    # -- training -----------------------------------------------------------
    def _task_noise(self, task: str, batch: Dict, draws: Draws) -> Dict:
        """The draws `tasks.get_cond` takes for ``task``, from ``draws``."""
        dev = self.device
        B = batch["label"].shape[0]
        C = self.tokenizer.N_var_per_element
        if task == "random":
            return {"ratio": draws.uniform("ratio", (B,), dev),
                    "scores": draws.uniform("scores", (B, self.seq_len), dev)}
        if task == "partial":
            return {"scores": draws.uniform("scores", (B, self.gen_len // C), dev),
                    "topk": draws.randint("topk", 10_000, (B,), dev)}
        if task == "refinement":
            return {"bbox": draws.normal("bbox", tuple(batch["bbox"].shape), dev)}
        return {}

    def preprocess(self, batch: Dict, generator=None) -> Dict[str, torch.Tensor]:
        """Task-masked input -> whole-sequence target (`bart.py:218-252`),
        on the model's device.  ``generator``: a torch.Generator or a
        `Draws`; without one, a generator seeded 0 (the JAX default key)."""
        from layoutdm_tpu_torch.tasks import get_cond

        draws = as_draws(generator if generator is not None
                         else torch.Generator().manual_seed(0))
        dev = self.device
        batch = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(dev)
                 for k, v in batch.items()}
        seq = self.tokenizer.encode(batch)["seq"].to(dev)
        if len(self.tasks) == 1:
            task = self.tasks[0]
        else:
            task = self.tasks[int(draws.randint("task", len(self.tasks), (), dev))]
        if task == "unconditional":
            inp = seq.clone()
            inp[:, 1:] = self.mask_id
        else:
            inp = get_cond(batch, self.tokenizer, task, model_type="bart",
                           noise=self._task_noise(task, batch, draws))["seq"].to(dev)
        target = seq
        if self.tasks == ["random"] and self.sort_by == "category_alphabetical":
            # permute the target's elements so the decoder cannot read the
            # per-category counts from positions (`bart.py:236-247`)
            B = target.shape[0]
            C = self.tokenizer.N_var_per_element
            n_elem = self.gen_len // C
            perm = torch.argsort(draws.uniform("perm", (B, n_elem), dev), dim=1)
            idx = (perm[..., None] * C + torch.arange(C, device=dev)).reshape(B, n_elem * C)
            target = torch.cat([target[:, :1], torch.gather(target[:, 1:], 1, idx)], dim=1)
        return {"seq": inp, "target": target}

    def loss(self, tokens, state, generator, is_train: bool = True,
             dropout: Optional[Dropout] = None):
        """Teacher-forced cross-entropy, PAD ignored; in training the
        dropout draws from ``generator`` (or is the one given)."""
        if is_train and dropout is None:
            dropout = as_draws(generator).dropout()
        target = tokens["target"]
        logits = self.net(tokens["seq"], target[:, :-1], dropout if is_train else None)
        nll = cross_entropy(logits, target[:, 1:], target[:, 1:] != self.pad_id)
        return {"nll_loss": nll}, state

    # -- sampling -----------------------------------------------------------
    @torch.inference_mode()
    def sample_ids(
        self,
        rng,
        batch_size: int,
        cond: Optional[SamplerCond] = None,
        sampling: Optional[SamplingConfig] = None,
        cond_type: Optional[str] = None,
        use_cache: bool = True,
        **_unused,
    ) -> torch.Tensor:
        """Constrained decode (`bart.py:103-216`); returns the ids without
        BOS.  ``rng``: a torch.Generator or a `Draws` (``"tokens"``)."""
        sampling = sampling or SamplingConfig()
        draws = as_draws(rng)
        B, L, dev = batch_size, self.gen_len, self.device
        C = self.tokenizer.N_var_per_element
        alpha = self.sort_by == "category_alphabetical"
        is_special = alpha and cond_type == "partial"
        if cond is not None:
            cond = cond.to(dev)
            enc_in = seq_user = cond.seq.long()
            mask_user = cond.strong_mask
        else:
            enc_in = torch.full((B, L + 1), self.mask_id, dtype=torch.int64, device=dev)
            enc_in[:, 0] = self.bos_id
            seq_user = torch.full((B, L + 1), self.mask_id, dtype=torch.int64, device=dev)
            mask_user = torch.zeros((B, L + 1), dtype=torch.bool, device=dev)
        force = cond is not None and not is_special
        vocab = torch.arange(self.num_classes, device=dev)

        def constrain(logit_i, prev_cat, i):
            illegal = ~self._legal[i][None, :]
            if alpha and i % C == 0 and i // C > 0:  # `bart.py:162-171`
                illegal = illegal | (vocab[None, :] < prev_cat[:, None])
            pred = sample_logits(logit_i.masked_fill(illegal, -torch.inf), sampling, draws)
            if force:
                pred = torch.where(mask_user[:, i + 1], seq_user[:, i + 1], pred)
            return pred

        global DECODE_STEPS
        with span("layoutdm.encode"):
            memory = self.net(enc_in, None)  # the encoder runs once
            cache = self.net.new_cache(B, memory) if use_cache else None
        preds = []
        if use_cache:
            tok = torch.full((B, 1), self.bos_id, dtype=torch.int64, device=dev)
            cat_buf = torch.zeros((B,), dtype=torch.int64, device=dev)
            for i in range(L):
                with span("layoutdm.decode_step"):
                    pred = constrain(self.net.decode_step(tok, cache)[:, 0], cat_buf, i)
                DECODE_STEPS += 1
                if i % C == 0:  # the latest category, for the order rule
                    cat_buf = pred
                preds.append(pred)
                tok = pred[:, None]
        else:
            # a fixed-length buffer [BOS, ...]; step i fills position i + 1
            buf = torch.full((B, L + 1), self.bos_id, dtype=torch.int64, device=dev)
            for i in range(L):
                with span("layoutdm.decode_step"):
                    logits = self.net(None, buf, memory=memory)
                    pred = constrain(logits[:, i], buf[:, max(i - (C - 1), 0)], i)
                preds.append(pred)
                buf[:, i + 1] = pred
        seq = torch.stack(preds, dim=1)
        if is_special and cond is not None:
            seq = self._reinsert_partial(seq.cpu().numpy(), cond)
        return seq

    def _reinsert_partial(self, seq: np.ndarray, cond: SamplerCond) -> torch.Tensor:
        """The partial task's element re-insertion under the alphabetical
        order (`bart.py:184-212`), on the host, with the JAX package's
        ``random.Random(0)``."""
        C = self.tokenizer.N_var_per_element
        rng = _random.Random(0)
        seq = seq.copy()
        cseq = cond.seq.cpu().numpy()
        cmask = cond.strong_mask.cpu().numpy()
        for b in range(seq.shape[0]):
            kept = cseq[b][cmask[b]][1:]  # drop BOS
            kept = kept[: (len(kept) // C) * C].reshape(-1, C)
            elems = seq[b].reshape(-1, C)
            remaining = list(kept)
            kept_set = {tuple(e.tolist()) for e in kept}
            # insert where the order admits it
            for s in range(elems.shape[0]):
                if not remaining:
                    break
                if elems[s, 0] >= remaining[0][0]:
                    elems[s] = remaining.pop(0)
            # leftovers replace random elements
            guard = 0
            while remaining and guard < 1000:
                guard += 1
                ind = rng.randint(0, elems.shape[0] - 1)
                if tuple(elems[ind].tolist()) in kept_set:
                    continue
                elems[ind] = remaining.pop(0)
            seq[b] = elems.reshape(-1)
        return torch.as_tensor(seq, device=self.device)

    def sample(self, rng, batch_size, cond=None, sampling=None, **kw):
        """Sample and decode to {bbox, label, mask}."""
        ids = self.sample_ids(rng, batch_size, cond, sampling, **kw)
        return self.tokenizer.decode(ids)
