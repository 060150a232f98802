"""Weights carried across: the JAX package's flax param tree -> the port's
``state_dict``, and the port's job directory.

``params_from_flax`` inverts the key map of
``layoutdm_tpu/utils/torch_port.py::convert_categorical_transformer``: a
nested dict of numpy arrays (``cat_emb/embedding``, ``pos/elem_emb``,
``backbone/layer{i}/norm1/AdaNormCond_0/...``, ``attn/qkv/kernel`` (D, 3D),
``head/kernel`` ...) becomes `models.nn.CategoricalTransformer` keys.
Dense kernels are stored (in, out) by flax and (out, in) by torch.

A job directory holds ``config.json`` (the configs' ``to_dict``) and
``params.pt`` (the denoiser's state dict), each written to a temporary
name, fsynced and moved into place.  Reading the JAX package's msgpack
checkpoints directly waits: the GPU host has no flax.
"""

from __future__ import annotations

import io
import json
import os
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from layoutdm_tpu_torch import configs as _configs

CONFIG_FILE = "config.json"
PARAMS_FILE = "params.pt"

# flax module names that differ from the port's attribute names
_RENAME = {"AdaNormCond_0": "cond", "scale": "weight", "embedding": "weight"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``CategoricalTransformer`` params -> the port's state dict
    (float32 CPU tensors)."""
    sd = {}
    for path, value in _flatten(tree):
        arr = np.asarray(value, dtype=np.float32)
        parts = []
        for p in path:
            m = re.fullmatch(r"layer(\d+)", p)
            parts.extend(["layers", m.group(1)] if m else [_RENAME.get(p, p)])
        if path[-1] == "kernel":
            parts[-1] = "weight"
            arr = arr.T
        sd[".".join(parts)] = torch.tensor(arr)  # a copy, contiguous
    return sd


def write_atomic(path: str, data: bytes) -> None:
    """A kill mid-write never leaves a truncated file at ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_torch(obj, path: str) -> None:
    buf = io.BytesIO()
    torch.save(obj, buf)
    write_atomic(path, buf.getvalue())


def save_config(cfg, job_dir: str) -> None:
    os.makedirs(job_dir, exist_ok=True)
    text = json.dumps(_configs.to_dict(cfg), indent=2)
    write_atomic(os.path.join(job_dir, CONFIG_FILE), text.encode())


def save_params(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    save_torch({k: v.detach().to("cpu") for k, v in state_dict.items()}, path)


def save_job(cfg, state_dict: Mapping[str, torch.Tensor], job_dir: str) -> None:
    save_config(cfg, job_dir)
    save_params(state_dict, os.path.join(job_dir, PARAMS_FILE))


def load_job(job_dir: str):
    """-> (TrainConfig, state dict on the CPU)."""
    with open(os.path.join(job_dir, CONFIG_FILE)) as f:
        cfg = _configs.train_config_from_dict(json.load(f))
    sd = torch.load(
        os.path.join(job_dir, PARAMS_FILE), map_location="cpu", weights_only=True
    )
    return cfg, sd
