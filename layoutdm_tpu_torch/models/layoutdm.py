"""LayoutDM — tokenizer + constrained Q + denoiser + reverse chain + loss
(port of ``layoutdm_tpu/models/layoutdm.py``; reference
`models/layoutdm.py:26-126`).  Backbone widths shrink by 29/32 for
parameter parity with the baselines (`models/layoutdm.py:54`).

The model lives on CUDA unless given ``device="cpu"``.  ``fused_block`` /
``fused_ffn`` put the denoiser's inference on the fused kernels K4 / K3,
``attn_v2`` / ``smajor`` its attention on K5 / K6 (``models.nn.Block``);
training keeps the unfused path.

``q_type="constrained"`` (LayoutDM) and ``q_type="vanilla"`` (the
``vqdiffusion`` experiment: one mask-and-replace matrix over the full
vocabulary), with the flattened transformer or, under
``transformer_type="aggregated"``, `models.nn.CategoricalAggregatedTransformer`
(attention over the elements; its backbone shrinks by a further 27/29:
d_model 432, FFN 1728, 8 heads of 54 at the defaults).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from layoutdm_tpu_torch.configs import BackboneConfig, ModelConfig, SamplingConfig
from layoutdm_tpu_torch.models.diffusion.constrained import ConstrainedQ
from layoutdm_tpu_torch.models.diffusion.loss import LtState, diffusion_loss
from layoutdm_tpu_torch.models.diffusion.sampler import (
    SamplerCond,
    make_predict_start,
    sample_chain,
)
from layoutdm_tpu_torch.models.diffusion.vanilla import VanillaQ
from layoutdm_tpu_torch.models.nn import (
    CategoricalAggregatedTransformer,
    Dropout,
    denoiser_path,
    make_module,
    make_transformer,
)
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer
from layoutdm_tpu_torch.utils.device import require_device


class LayoutDM:
    # serving capabilities (`serve_cli`): the chain takes per-row seeds
    # (request coalescing) and a guidance function (relation task)
    supports_per_row_keys = True
    supports_guidance = True

    def __init__(
        self,
        backbone: BackboneConfig,
        tokenizer: LayoutSequenceTokenizer,
        model_cfg: Optional[ModelConfig] = None,
        dtype=torch.float32,
        device="cuda",
        generator: Optional[torch.Generator] = None,
        fused_block: bool = False,
        fused_ffn: bool = False,
        attn_v2: bool = False,
        smajor: bool = False,
    ):
        cfg = model_cfg or ModelConfig()
        if cfg.q_type not in ("constrained", "vanilla"):
            raise ValueError(f"unknown q_type {cfg.q_type!r}")
        if cfg.transformer_type not in ("flattened", "aggregated"):
            raise ValueError(f"unknown transformer_type {cfg.transformer_type!r}")
        # MASK must be the last vocabulary id (`models/layoutdm.py:46`)
        if tokenizer.id_to_name(tokenizer.N_total - 1) != "mask":
            raise ValueError("MASK must be the last vocabulary id")

        self.tokenizer = tokenizer
        self.cfg = cfg
        self.device = require_device(device)
        self.seq_len = tokenizer.max_token_length
        self.num_classes = tokenizer.N_total
        sched = dict(att_1=cfg.att_1, att_T=cfg.att_T, ctt_1=cfg.ctt_1,
                     ctt_T=cfg.ctt_T, device=self.device)
        if cfg.q_type == "constrained":
            self.q = ConstrainedQ(tokenizer, cfg.num_timesteps, **sched)
        else:
            self.q = VanillaQ(tokenizer.N_total, cfg.num_timesteps, **sched)
        self.backbone_cfg = backbone.shrunk(29 / 32)
        kw = dict(num_classes=self.num_classes, max_token_length=self.seq_len,
                  n_attr_per_elem=tokenizer.N_var_per_element, dtype=dtype,
                  fused_block=fused_block, fused_ffn=fused_ffn, attn_v2=attn_v2,
                  smajor=smajor)
        if cfg.transformer_type == "aggregated":
            # extra 27/29 shrink for parameter parity (`base.py:85-93`)
            self.backbone_cfg = self.backbone_cfg.shrunk(27 / 29)
            self.net = make_module(CategoricalAggregatedTransformer, self.device, generator,
                                   backbone=self.backbone_cfg, **kw)
        else:
            self.net = make_transformer(self.device, generator, backbone=self.backbone_cfg,
                                        pos_emb=cfg.pos_emb, **kw)
        self._predict_start = make_predict_start(self.net, self.num_classes)

    @property
    def denoiser_path(self) -> str:
        """The kernels the denoiser's inference runs."""
        return denoiser_path(self.net)

    # -- training -----------------------------------------------------------
    def init_state(self) -> LtState:
        return LtState.init(self.q.num_timesteps, self.device)

    def loss(
        self,
        tokens,
        lt_state: LtState,
        generator: torch.Generator,
        is_train: bool = True,
    ):
        """(losses dict, new LtState).  ``tokens``: `preprocess` output with
        ``seq`` (B, S) clean token ids, or the ids themselves.  Timesteps,
        corruption and (when ``is_train``) dropout draw from ``generator``,
        which lives on the model's device."""
        seq = tokens["seq"] if isinstance(tokens, dict) else tokens
        return diffusion_loss(
            self.q,
            self._predict_start,
            seq,
            lt_state,
            generator,
            dropout=Dropout(generator) if is_train else None,
            auxiliary_loss_weight=self.cfg.auxiliary_loss_weight,
            is_train=is_train,
        )

    def preprocess(
        self, batch: Dict, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """Dense layout batch (numpy or tensors) -> token batch on the
        model's device (`layoutdm.py:99-114`).  ``seq_type == "set"``
        shuffles the element slots of each row, drawing from ``generator``."""
        ids = {k: v.to(self.device) for k, v in self.tokenizer.encode(batch).items()}
        if self.cfg.seq_type == "set":
            if generator is None:
                raise ValueError("seq_type='set' shuffles with a generator")
            B, S = ids["mask"].shape
            C = self.tokenizer.N_var_per_element
            u = torch.rand((B, S // C), generator=generator, device=generator.device)
            perm = torch.argsort(u, dim=1).to(self.device)
            idx = (perm[..., None] * C + torch.arange(C, device=self.device)).reshape(B, S)
            ids = {k: torch.gather(v, 1, idx) for k, v in ids.items()}
        return ids

    def sample_ids(
        self,
        rng: Union[torch.Generator, torch.Tensor],
        batch_size: int,
        cond: Optional[SamplerCond] = None,
        sampling: Optional[SamplingConfig] = None,
        num_timesteps_eval: Optional[int] = None,
        get_intermediates: bool = False,
        guidance_fn=None,
        state=None,
    ):
        """Run the reverse chain and return token ids (B, S) on the model's
        device.  ``rng``: a ``torch.Generator`` on any device (the noise is
        drawn there and moved to the model's device) or (B,) int64 row
        seeds.  ``guidance_fn(log_probs, t, cond)`` adjusts each step's
        log-probs (relation guidance); a guided chain runs under
        ``torch.no_grad`` rather than inference mode, so the guidance can
        differentiate its own loss, and the denoiser still sees no grad.
        ``state`` is unused (the zoo's samplers read theirs)."""
        sampling = sampling or SamplingConfig()
        if cond is None:
            cond = SamplerCond.empty(batch_size, self.seq_len, self.device)
        if isinstance(rng, torch.Tensor):
            rng = rng.to(self.device)
        with torch.inference_mode() if guidance_fn is None else torch.no_grad():
            return sample_chain(
                self._predict_start,
                self.q,
                rng,
                cond.to(self.device),
                sampling,
                pad_id=self.tokenizer.name_to_id("pad"),
                num_timesteps_eval=num_timesteps_eval or sampling.num_timesteps,
                get_intermediates=get_intermediates,
                guidance_fn=guidance_fn,
            )

    def sample(self, rng, batch_size, cond=None, sampling=None, **kw):
        """Sample and decode to {bbox, label, mask} (`layoutdm.py:77-88`)."""
        ids = self.sample_ids(rng, batch_size, cond, sampling, **kw)
        return self.tokenizer.decode(ids)
