"""The system under test for the encoder-decoder cells: the PyTorch port's
BART, built from a configuration file of the benchmark through the
program's ``factory.build_model``, on its default path, with the weights
the benchmark made."""

from __future__ import annotations

import os
from typing import Dict

import torch

from perfbench.reference.encdec import widths

# (program config path, benchmark key): the program must run what the file states
AGREE = (
    ("model.name", "experiment"), ("dataset.name", "dataset"),
    ("dataset.num_categories", "num_categories"), ("dataset.max_seq_length", "max_elements"),
    ("data.num_bin_bboxes", "num_bins"), ("data.shared_bbox_vocab", "shared_bbox_vocab"),
    ("data.var_order", "var_order"), ("data.bbox_quantization", "bbox_quantization"),
    ("backbone.d_model", "d_model"), ("backbone.nhead", "nhead"),
    ("backbone.dim_feedforward", "dim_feedforward"), ("backbone.num_layers", "num_layers"),
    ("backbone.dropout", "dropout"), ("backbone.activation", "activation"),
    ("model.dtype", "dtype"), ("sampling.name", "sampling"),
    ("sampling.temperature", "temperature"),
)
# the positional embedding each ``pos_emb`` names (`models.nn.positional_embedding`)
POS_EMB = {"default": "PositionalEmbedding", "elem_attr": "ElementPositionalEmbedding"}


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
    if list(pc.data.special_tokens) != list(cfg["special_tokens"]):
        raise ValueError("the program's special tokens depart from the configuration")
    return pc


def build(cfg: Dict, params: Dict[str, torch.Tensor], device):
    """The model on ``device`` with ``params`` loaded (every name, every
    shape), on the program's default path: its switches in the
    environment (``LAYOUTDM_TPU_*``) are cleared and none is passed.
    Raises where what was built departs from the configuration: widths,
    timestep conditioning, positional embedding, decoder length."""
    from layoutdm_tpu_torch.factory import build_model

    for key in [k for k in os.environ if k.startswith("LAYOUTDM_TPU_")]:
        del os.environ[key]
    model = build_model(train_config(cfg), device=device)
    model.net.load_state_dict(params, strict=True)
    bb = model.backbone_cfg
    d, H, ff, L = widths(cfg)
    built = {"widths": (bb.d_model, bb.nhead, bb.dim_feedforward, bb.num_layers),
             "timestep_type": bb.timestep_type,
             "pos_emb": type(model.net.target_pos).__name__,
             "seq_len": model.seq_len}
    stated = {"widths": (d, H, ff, L), "timestep_type": cfg["timestep_type"],
              "pos_emb": POS_EMB[cfg["pos_emb"]], "seq_len": 5 * cfg["max_elements"] + 1}
    if built != stated:
        raise ValueError(f"the program built {built}, the configuration states {stated}")
    return model
