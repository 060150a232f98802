"""A copy of the benchmark in a temporary folder with a toy configuration
(``toy``: 1 layer, 58 wide, 5 elements, T=10) beside the real ones, so
that a test can drive a whole cell on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import time

import torch

from perfbench.lib import harness, registry

TOY = {"d_model": 64, "nhead": 2, "dim_feedforward": 64, "num_layers": 1, "max_elements": 5,
       "num_timesteps": 10, "diffusion_step": 10}


def toy_root(tmp: str, dtype: str = "float32") -> str:
    """The benchmark's folder copied under ``tmp`` (with the program beside
    it, as in a checkout) and a ``toy`` configuration; returns the folder."""
    pb = os.path.join(tmp, "perfbench")
    shutil.copytree(registry.ROOT, pb, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(registry.REPO, "BENCHMARK.json"), tmp)
    shutil.copytree(os.path.join(registry.REPO, "layoutdm_tpu_torch"),
                    os.path.join(tmp, "layoutdm_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    cfg = registry.config("layoutdm-rico25", pb)
    keys = {"d_model": "backbone.d_model", "nhead": "backbone.nhead",
            "dim_feedforward": "backbone.dim_feedforward", "num_layers": "backbone.num_layers",
            "max_elements": "dataset.max_seq_length", "num_timesteps": "model.num_timesteps",
            "diffusion_step": "backbone.diffusion_step"}
    cfg.update(TOY, name="toy", dtype=dtype)
    cfg["program_overrides"] = ["data.bbox_quantization=linear", f"model.dtype={dtype}"] + [
        f"{keys[k]}={v}" for k, v in TOY.items()]
    with open(os.path.join(pb, "configs", "toy.json"), "w") as f:
        json.dump(cfg, f)
    return pb


def context(pb: str, cell_name: str, seed: int = 2**31 + 11, seconds: float = 0.5,
            trace: bool = False, **cell) -> harness.Context:
    c = registry.cell(cell_name, pb)
    c.update(cell, config="toy")
    return harness.Context(cell=c, cfg=registry.config("toy", pb), seed=seed, seconds=seconds,
                           trace=trace, device=torch.device("cpu"), started=time.perf_counter(),
                           root=pb)


SAMPLE = {"batch": 8, "check_rows": 8}
TRAIN = {"batch": 16, "pool": 64, "staged": 8, "trace_steps": 2}
