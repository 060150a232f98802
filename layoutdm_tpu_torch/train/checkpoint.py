"""Checkpoint IO of a training job directory (port of
``layoutdm_tpu/train/checkpoint.py``).

A job directory holds ``config.json`` (`utils.params.save_config`) and the
denoiser's weights in the format `utils.params.load_job` reads: ``params.pt`` are the best weights
(the ones the service loads, as the JAX service loads "best"),
``final_params.pt`` the last, ``aux_state.pt`` the model's aux state
saved with the best weights.  ``last_state.pt`` is the full train state
for resume: weights, AdamW state, the aux state (``LtState``,
``SeqLenState`` or none), step and the random generators' states.  Every
file goes through `utils.params`' writers and readers: a local file is
written to a temporary name, fsynced and moved into place, so a kill
mid-write never leaves a truncated checkpoint, and a ``scheme://`` job
directory goes through ``fsspec``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

# save_config and load_config are this module's surface too, as in the JAX package
from layoutdm_tpu_torch.utils.params import (  # noqa: F401
    FINAL_PARAMS_FILE,
    PARAMS_FILE,
    aux_from_dict,
    aux_to_dict,
    ensure_dir,
    job_path,
    load_config,
    load_torch,
    save_aux_state,
    save_config,
    save_torch,
)
from layoutdm_tpu_torch.utils.params import save_params as _save_params

PARAMS_FILES = {"best": PARAMS_FILE, "final": FINAL_PARAMS_FILE}
STATE_FILE = "last_state.pt"


def save_params(state_dict: Mapping[str, torch.Tensor], job_dir: str,
                best_or_final: str = "best", aux_state=None) -> str:
    """The weights; with ``aux_state``, the aux state beside them."""
    ensure_dir(job_dir)
    path = job_path(job_dir, PARAMS_FILES[best_or_final])
    _save_params(state_dict, path)
    if aux_state is not None:
        save_aux_state(aux_state, job_dir)
    return path


def load_params(job_dir: str, best_or_final: str = "best") -> Dict[str, torch.Tensor]:
    """The saved weights, on the CPU."""
    return load_torch(job_path(job_dir, PARAMS_FILES[best_or_final]))


def save_train_state(state, job_dir: str, generators: Dict[str, Mapping]) -> str:
    """``state``: a `train.step.TrainState`; ``generators``: named
    generator states (tensors and numbers) to restore on resume."""
    ensure_dir(job_dir)
    path = job_path(job_dir, STATE_FILE)
    save_torch({
        "params": {k: v.detach().to("cpu") for k, v in state.model.net.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "aux_state": aux_to_dict(state.lt_state),
        "step": state.step,
        "generators": dict(generators),
    }, path)
    return path


def load_train_state(state, job_dir: str) -> Dict[str, Mapping]:
    """Restore ``state`` in place from ``last_state.pt``; returns the saved
    generator states."""
    blob = load_torch(job_path(job_dir, STATE_FILE))
    state.model.net.load_state_dict(blob["params"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.lt_state = aux_from_dict(state.lt_state, blob["aux_state"])
    state.step = int(blob["step"])
    return blob["generators"]
