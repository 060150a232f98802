"""Weights carried across: the JAX package's flax param tree -> the port's
``state_dict``, and the port's job directory.

``params_from_flax`` maps a flax param tree, a nested dict of numpy
arrays (``cat_emb/embedding``, ``pos/elem_emb``,
``backbone/layer{i}/norm1/AdaNormCond_0/...``, ``attn/qkv/kernel`` (D, 3D),
``head/kernel``; BART's ``encoder/layer{i}`` and ``dec{i}/cross_attn/kv``;
DiffusionLM's ``rounder`` and ``token_emb`` ...), onto the port's module
names, which follow the flax tree: every family of `factory.build_model`
loads it.  Dense kernels are stored (in, out) by flax and (out, in) by
torch.

A job directory holds ``config.json`` (the configs' ``to_dict``),
``params.pt`` (the denoiser's state dict) and, from the trainer,
``aux_state.pt`` (the model's aux state beside the best weights: the
element-count histogram MaskGIT and BLT sample from, LayoutDM's Lt
buffers), each written to a temporary name, fsynced and moved into place.

`load_jax_job` reads a job of the JAX package's trainer (``config.json``,
``{best,final}_model.msgpack``, ``aux_state.msgpack``) with the port's own
msgpack reader (`utils.flax_msgpack`; the GPU host has no flax) and writes
it as a port job.
"""

from __future__ import annotations

import dataclasses
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
FINAL_PARAMS_FILE = "final_params.pt"
AUX_FILE = "aux_state.pt"

# flax module names that differ from the port's attribute names
_RENAME = {"AdaNormCond_0": "cond", "scale": "weight", "embedding": "weight"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params of any denoiser of the JAX package -> the port's state
    dict (float32 CPU tensors).  The port's modules carry the flax names,
    so one rule set maps every family."""
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


def with_own_buffers(sd: Mapping[str, torch.Tensor], net: torch.nn.Module) -> Dict:
    """``sd`` with ``net``'s own value for each saved buffer it lacks: a JAX
    tree holds no frozen constant (DiffusionLM's fixed codebook), which the
    model builds itself."""
    own = net.state_dict()
    return {**{k: own[k].detach().to("cpu") for k, _ in net.named_buffers()
               if k in own and k not in sd}, **sd}


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


def aux_to_dict(state) -> Dict[str, torch.Tensor]:
    """A model's aux state (a dataclass of tensors, or ``None``) as CPU
    tensors by field name."""
    if state is None:
        return {}
    return {f.name: getattr(state, f.name).detach().to("cpu")
            for f in dataclasses.fields(state)}


def aux_from_dict(template, blob: Mapping[str, Any]):
    """``blob`` as an aux state of ``template``'s type and device."""
    if template is None:
        return None
    fields = {}
    for f in dataclasses.fields(template):
        ref = getattr(template, f.name)
        fields[f.name] = torch.as_tensor(np.asarray(blob[f.name])).to(ref.device, ref.dtype)
    return type(template)(**fields)


def save_aux_state(state, job_dir: str) -> None:
    save_torch(aux_to_dict(state), os.path.join(job_dir, AUX_FILE))


def load_aux_state(template, job_dir: str):
    """The job's aux state in ``template``'s type, or ``template`` when the
    job has none (weights imported without one)."""
    path = os.path.join(job_dir, AUX_FILE)
    if template is None or not os.path.exists(path):
        return template
    return aux_from_dict(template, torch.load(path, map_location="cpu", weights_only=True))


def load_jax_job(job_dir: str, out_dir: str):
    """A job of the JAX package's trainer, written to ``out_dir`` as a port
    job: its ``config.json``; ``best_model.msgpack`` (and
    ``final_model.msgpack`` where there is one) through `params_from_flax`
    as ``params.pt`` (``final_params.pt``), with the frozen buffers of the
    model the config builds (`with_own_buffers`); its ``aux_state.msgpack``
    as ``aux_state.pt``.  Returns (TrainConfig, best state dict, aux state
    as arrays by field name, or ``None``)."""
    from layoutdm_tpu_torch.factory import build_model
    from layoutdm_tpu_torch.utils.flax_msgpack import read_flax_msgpack

    with open(os.path.join(job_dir, CONFIG_FILE)) as f:
        cfg = _configs.train_config_from_dict(json.load(f))
    net = build_model(cfg, device="cpu").net

    def read(name):
        return with_own_buffers(params_from_flax(read_flax_msgpack(
            os.path.join(job_dir, name))), net)

    sd = read("best_model.msgpack")
    save_job(cfg, sd, out_dir)
    if os.path.exists(os.path.join(job_dir, "final_model.msgpack")):
        save_params(read("final_model.msgpack"), os.path.join(out_dir, FINAL_PARAMS_FILE))
    aux_path = os.path.join(job_dir, "aux_state.msgpack")
    aux = read_flax_msgpack(aux_path) if os.path.exists(aux_path) else None
    if not isinstance(aux, Mapping):
        aux = None  # the zoo's dummy state, a scalar
    if aux is not None:
        save_torch({k: torch.as_tensor(np.asarray(v)) for k, v in aux.items()},
                   os.path.join(out_dir, AUX_FILE))
    return cfg, sd, aux
