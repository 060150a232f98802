"""Checkpoint IO of a training job directory (port of
``layoutdm_tpu/train/checkpoint.py``).

A job directory holds ``config.json`` (`utils.params.save_config`) and the
denoiser's weights in the format `utils.params.load_job` reads: ``params.pt`` are the best weights
(the ones the service loads, as the JAX service loads "best"),
``final_params.pt`` the last, ``aux_state.pt`` the model's aux state
saved with the best weights.  ``last_state.pt`` is the full train state
for resume: weights, AdamW state, the aux state (``LtState``,
``SeqLenState`` or none), step and the random generators' states.  Every file is written to a temporary name, fsynced and
moved into place, so a kill mid-write never leaves a truncated checkpoint.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import torch

from layoutdm_tpu_torch.utils.params import (
    FINAL_PARAMS_FILE,
    PARAMS_FILE,
    aux_from_dict,
    aux_to_dict,
    save_aux_state,
    save_torch,
)
from layoutdm_tpu_torch.utils.params import save_params as _save_params

PARAMS_FILES = {"best": PARAMS_FILE, "final": FINAL_PARAMS_FILE}
STATE_FILE = "last_state.pt"


def save_params(state_dict: Mapping[str, torch.Tensor], job_dir: str,
                best_or_final: str = "best", aux_state=None) -> str:
    """The weights; with ``aux_state``, the aux state beside them."""
    os.makedirs(job_dir, exist_ok=True)
    path = os.path.join(job_dir, PARAMS_FILES[best_or_final])
    _save_params(state_dict, path)
    if aux_state is not None:
        save_aux_state(aux_state, job_dir)
    return path


def save_train_state(state, job_dir: str, generators: Dict[str, Mapping]) -> str:
    """``state``: a `train.step.TrainState`; ``generators``: named
    generator states (tensors and numbers) to restore on resume."""
    os.makedirs(job_dir, exist_ok=True)
    path = os.path.join(job_dir, STATE_FILE)
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
    blob = torch.load(
        os.path.join(job_dir, STATE_FILE), map_location="cpu", weights_only=True
    )
    state.model.net.load_state_dict(blob["params"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.lt_state = aux_from_dict(state.lt_state, blob["aux_state"])
    state.step = int(blob["step"])
    return blob["generators"]
