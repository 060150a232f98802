"""Builders wiring configs -> tokenizer -> model (port of
``layoutdm_tpu/factory.py``; reference `main.py:79-97`)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from layoutdm_tpu_torch.configs import TrainConfig
from layoutdm_tpu_torch.data.datasets import LayoutData, load_dataset
from layoutdm_tpu_torch.tokenizer.bbox import (
    VAR_NAMES,
    BboxTokenizer,
    load_kmeans_centers,
)
from layoutdm_tpu_torch.tokenizer.clustering import fit_coordinate_clusters
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer
from layoutdm_tpu_torch.utils.device import require_device

def resolve_centers(
    cfg: TrainConfig, train_data: Optional[LayoutData] = None
) -> Optional[np.ndarray]:
    """Find or fit per-coordinate cluster centers for kmeans/percentile
    quantization, as the JAX package does: under
    ``<dataset dir>/../clustering_weights/`` the cached
    ``{name}_max{S}_{method}_train_clusters.npz``, else the reference's
    ``.pkl`` of the same stem, else fit on the train split's boxes and
    cache them as the ``.npz``."""
    method = cfg.data.bbox_quantization
    if method == "linear":
        return None
    base = os.path.join(
        os.path.dirname(cfg.dataset.dir.rstrip("/")), "clustering_weights"
    )
    stem = f"{cfg.dataset.name}_max{cfg.dataset.max_seq_length}_{method}_train_clusters"
    nb = cfg.data.num_bin_bboxes
    for ext in (".npz", ".pkl"):
        path = os.path.join(base, stem + ext)
        if os.path.exists(path):
            return load_kmeans_centers(path, nb)

    if train_data is None:
        train_data = load_dataset(
            cfg.dataset.name, cfg.dataset.dir, "train", cfg.dataset.max_seq_length
        )
    fitted = fit_coordinate_clusters(train_data.bbox[train_data.mask], (nb,), method)
    os.makedirs(base, exist_ok=True)
    np.savez(os.path.join(base, stem + ".npz"), **fitted)
    return np.stack([fitted[f"{k}-{nb}"] for k in VAR_NAMES])


def build_tokenizer(
    cfg: TrainConfig, train_data: Optional[LayoutData] = None
) -> LayoutSequenceTokenizer:
    bb = BboxTokenizer(
        num_bins=cfg.data.num_bin_bboxes,
        var_order=tuple(cfg.data.var_order.split("-")[1:]),
        shared_vocab=cfg.data.shared_bbox_vocab,
        quantization=cfg.data.bbox_quantization,
        centers=resolve_centers(cfg, train_data),
    )
    return LayoutSequenceTokenizer(
        bbox_tokenizer=bb,
        num_categories=cfg.dataset.num_categories,
        max_elements=cfg.dataset.max_seq_length,
        special_tokens=tuple(cfg.data.special_tokens),
        pad_until_max=cfg.data.pad_until_max,
    )


def build_model(
    cfg: TrainConfig, tokenizer=None, device="cuda",
    generator: Optional[torch.Generator] = None,
    fused_block: Optional[bool] = None, fused_ffn: Optional[bool] = None,
    attn_v2: Optional[bool] = None, smajor: Optional[bool] = None,
):
    """The model of ``cfg`` on ``device`` (CUDA unless asked for the CPU;
    raises when CUDA is missing): ``layoutdm`` (with ``q_type`` constrained,
    or vanilla for the ``vqdiffusion`` experiment; the flattened or the
    aggregated transformer), ``maskgit``, ``blt``, ``ruite``, ``autoreg`` /
    ``elem_wise_autoreg``, ``bart``, ``diffusionlm`` or ``bitdiffusion``.
    The denoiser's inference path: ``fused_block`` / ``fused_ffn`` select the fused kernels (K4 / K3), ``attn_v2`` the
    block-diagonal attention (K5) and ``smajor`` the S-major attention (K6);
    each defaults to the JAX package's own switch in the environment
    (``LAYOUTDM_TPU_FUSED_BLOCK=1``, ``LAYOUTDM_TPU_FUSED_FFN=1``,
    ``LAYOUTDM_TPU_ATTN_V2=1``, ``LAYOUTDM_TPU_SMAJOR=1``).  Where several
    are on, K4 wins over K5, and K5 over K6."""
    device = require_device(device)
    if tokenizer is None:
        tokenizer = build_tokenizer(cfg)
    name = cfg.model.name
    dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32
    switches = {
        key: os.environ.get(env) == "1" if value is None else value
        for key, env, value in (
            ("fused_block", "LAYOUTDM_TPU_FUSED_BLOCK", fused_block),
            ("fused_ffn", "LAYOUTDM_TPU_FUSED_FFN", fused_ffn),
            ("attn_v2", "LAYOUTDM_TPU_ATTN_V2", attn_v2),
            ("smajor", "LAYOUTDM_TPU_SMAJOR", smajor),
        )
    }
    kw = dict(dtype=dtype, device=device, generator=generator, **switches)
    if name == "layoutdm":
        from layoutdm_tpu_torch.models.layoutdm import LayoutDM

        return LayoutDM(cfg.backbone, tokenizer, cfg.model, **kw)
    if name == "maskgit":
        from layoutdm_tpu_torch.models.maskgit import MaskGIT

        return MaskGIT(cfg.backbone, tokenizer, cfg.model, **kw)
    if name == "blt":
        from layoutdm_tpu_torch.models.blt import BLT

        return BLT(cfg.backbone, tokenizer, cfg.model, **kw)
    if name in ("autoreg", "elem_wise_autoreg"):
        from layoutdm_tpu_torch.models.autoreg import ElemWiseAutoreg

        return ElemWiseAutoreg(cfg.backbone, tokenizer, cfg.model, **kw)
    if name == "ruite":
        from layoutdm_tpu_torch.models.ruite import RUITE

        return RUITE(cfg.backbone, tokenizer, cfg.model, **kw)
    if name == "bart":
        from layoutdm_tpu_torch.models.bart import BART

        return BART(cfg.backbone, tokenizer, cfg.model, **kw)
    if name in ("diffusionlm", "bitdiffusion"):
        from layoutdm_tpu_torch.models.continuous.models import LayoutContinuousDiffusion

        return LayoutContinuousDiffusion(cfg.backbone, tokenizer, cfg.model, **kw)
    raise KeyError(name)
