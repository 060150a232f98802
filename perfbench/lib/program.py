"""The system under test: the PyTorch port's LayoutDM, built from a
configuration file of the benchmark, on the program's default denoiser
path, with the weights the benchmark made."""

from __future__ import annotations

import os
from typing import Dict

import torch

from perfbench.reference.denoiser import widths

# (program config path, benchmark key): the program must run what the file states
AGREE = (
    ("dataset.num_categories", "num_categories"), ("dataset.max_seq_length", "max_elements"),
    ("data.num_bin_bboxes", "num_bins"), ("data.shared_bbox_vocab", "shared_bbox_vocab"),
    ("data.var_order", "var_order"), ("data.bbox_quantization", "bbox_quantization"),
    ("backbone.d_model", "d_model"), ("backbone.nhead", "nhead"),
    ("backbone.dim_feedforward", "dim_feedforward"), ("backbone.num_layers", "num_layers"),
    ("backbone.timestep_type", "timestep_type"), ("backbone.diffusion_step", "diffusion_step"),
    ("backbone.dropout", "dropout"), ("backbone.activation", "activation"),
    ("model.q_type", "q_type"), ("model.num_timesteps", "num_timesteps"),
    ("model.pos_emb", "pos_emb"), ("model.dtype", "dtype"), ("model.att_1", "att_1"),
    ("model.att_T", "att_T"), ("model.ctt_1", "ctt_1"), ("model.ctt_T", "ctt_T"),
    ("model.auxiliary_loss_weight", "auxiliary_loss_weight"), ("optimizer.lr", "lr"),
    ("training.weight_decay", "weight_decay"), ("training.grad_norm_clip", "grad_norm_clip"),
)


def train_config(cfg: Dict):
    """The program's config of ``cfg``; raises where it departs from it."""
    from layoutdm_tpu_torch.configs import build_train_config

    pc = build_train_config(cfg["experiment"], cfg["dataset"], list(cfg["program_overrides"]))
    for path, key in AGREE:
        obj = pc
        for part in path.split("."):
            obj = getattr(obj, part)
        if obj != cfg[key]:
            raise ValueError(f"the program's {path} is {obj!r}, "
                             f"the configuration states {cfg[key]!r}")
    if list(pc.data.special_tokens) != list(cfg["special_tokens"]) or \
            list(pc.optimizer.betas) != list(cfg["betas"]):
        raise ValueError("the program's special tokens or betas depart from the configuration")
    return pc


def build(cfg: Dict, params: Dict[str, torch.Tensor], device):
    """The model on ``device`` with ``params`` loaded (every name, every
    shape), on whatever denoiser path the program takes by default: the
    program's switches in the environment (``LAYOUTDM_TPU_*``) are cleared
    and none is passed."""
    from layoutdm_tpu_torch.factory import build_model

    for key in [k for k in os.environ if k.startswith("LAYOUTDM_TPU_")]:
        del os.environ[key]
    model = build_model(train_config(cfg), device=device)
    model.net.load_state_dict(params, strict=True)
    if model.backbone_cfg.d_model != widths(cfg)[0]:
        raise ValueError(f"the program runs {model.backbone_cfg.d_model} wide, the "
                         f"configuration {widths(cfg)[0]}")
    return model
