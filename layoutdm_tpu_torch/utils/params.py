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
A job directory may be remote (``gs://``, ``s3://``, ``memory://`` ...,
any ``scheme://`` path), as in the JAX package (`train/checkpoint.py:22-60`,
after the reference's `common/util.py:47-64`): such paths go through
``fsspec``, imported only for them, and are written directly (object
stores commit an object on close).  Without ``fsspec`` a remote path
raises; a local one never imports it.  Every reader and writer of a job
directory (the trainer's checkpoints, `sample_cli`, the service) goes
through the helpers here.

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


def is_remote(path: str) -> bool:
    return "://" in path


def _fsspec(path: str):
    try:
        import fsspec
    except ImportError as e:
        raise RuntimeError(
            f"{path}: a remote job directory needs the fsspec package, "
            "which is not installed; use a local directory"
        ) from e
    return fsspec


def open_file(path: str, mode: str):
    """A local file, or a remote one through fsspec."""
    if is_remote(path):
        return _fsspec(path).open(path, mode).open()
    return open(path, mode)


def path_exists(path: str) -> bool:
    if is_remote(path):
        fs, inner = _fsspec(path).core.url_to_fs(path)
        return fs.exists(inner)
    return os.path.exists(path)


def ensure_dir(d: str) -> None:
    if not is_remote(d):
        os.makedirs(d, exist_ok=True)


def job_path(job_dir: str, name: str) -> str:
    return job_dir.rstrip("/") + "/" + name if is_remote(job_dir) else os.path.join(job_dir, name)


def write_atomic(path: str, data: bytes) -> None:
    """A kill mid-write never leaves a truncated file at ``path``: local
    files go through a temporary name and a rename, remote ones are written
    directly."""
    if is_remote(path):
        with open_file(path, "wb") as f:
            f.write(data)
        return
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


def load_torch(path: str):
    """A file of `save_torch`, its tensors on the CPU."""
    with open_file(path, "rb") as f:
        return torch.load(io.BytesIO(f.read()), map_location="cpu", weights_only=True)


def save_config(cfg, job_dir: str) -> None:
    ensure_dir(job_dir)
    text = json.dumps(_configs.to_dict(cfg), indent=2)
    write_atomic(job_path(job_dir, CONFIG_FILE), text.encode())


def load_config(job_dir: str):
    with open_file(job_path(job_dir, CONFIG_FILE), "r") as f:
        return _configs.train_config_from_dict(json.load(f))


def save_params(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    save_torch({k: v.detach().to("cpu") for k, v in state_dict.items()}, path)


def save_job(cfg, state_dict: Mapping[str, torch.Tensor], job_dir: str) -> None:
    save_config(cfg, job_dir)
    save_params(state_dict, job_path(job_dir, PARAMS_FILE))


def load_job(job_dir: str):
    """-> (TrainConfig, state dict on the CPU)."""
    return load_config(job_dir), load_torch(job_path(job_dir, PARAMS_FILE))


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
    save_torch(aux_to_dict(state), job_path(job_dir, AUX_FILE))


def load_aux_state(template, job_dir: str):
    """The job's aux state in ``template``'s type, or ``template`` when the
    job has none (weights imported without one)."""
    path = job_path(job_dir, AUX_FILE)
    if template is None or not path_exists(path):
        return template
    return aux_from_dict(template, load_torch(path))


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
