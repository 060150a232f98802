"""The port's own copies of the JAX package's configs and registry: the
same dataclasses, a ``config.json`` that loads either way, a registry of
its own; and the entry points that run on CUDA unless asked for the CPU."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from layoutdm_tpu import configs as jconfigs
from layoutdm_tpu.registry import DATASET_LABELS as JAX_LABELS
from layoutdm_tpu.train import checkpoint as jax_ckpt
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch import registry as tregistry
from layoutdm_tpu_torch.factory import build_model, build_tokenizer
from layoutdm_tpu_torch.models.layoutdm import LayoutDM
from layoutdm_tpu_torch.serve_cli import LayoutService
from layoutdm_tpu_torch.utils.params import load_job, save_config, save_params

SMOKE_OVERRIDES = ["data.bbox_quantization=linear", "model.dtype=bfloat16"]
TINY = [
    "data.bbox_quantization=linear", "dataset.max_seq_length=5",
    "backbone.d_model=128", "backbone.nhead=2", "backbone.dim_feedforward=64",
    "backbone.num_layers=2", "model.num_timesteps=10", "backbone.diffusion_step=10",
]


@pytest.mark.parametrize("dataset", ["rico25", "publaynet", "synthetic"])
@pytest.mark.parametrize("overrides", [[], SMOKE_OVERRIDES, TINY])
def test_copied_configs_equal_the_jax_package(dataset, overrides):
    j = jconfigs.build_train_config("layoutdm", dataset, overrides)
    t = tconfigs.build_train_config("layoutdm", dataset, overrides)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.dataset.num_categories == j.dataset.num_categories
    assert sorted(tconfigs.EXPERIMENTS) == sorted(jconfigs.EXPERIMENTS)
    for name in tconfigs.EXPERIMENTS:
        assert dataclasses.asdict(tconfigs.build_train_config(name, dataset)) == (
            dataclasses.asdict(jconfigs.build_train_config(name, dataset)))


def _weights(cfg):
    return build_model(cfg, device="cpu").net.state_dict()


def test_config_json_loads_in_the_port_either_way(tmp_path):
    """A job whose config.json the JAX package wrote, and one the port
    wrote, both load through `load_job` into the same config; the port's
    file loads in the JAX package too."""
    jcfg = jconfigs.build_train_config("layoutdm", "synthetic", TINY + ["seed=3"])
    tcfg = tconfigs.build_train_config("layoutdm", "synthetic", TINY + ["seed=3"])
    sd = _weights(tcfg)
    jax_ckpt.save_config(jcfg, str(tmp_path / "jax"))
    save_config(tcfg, str(tmp_path / "port"))
    for d in ("jax", "port"):
        save_params(sd, str(tmp_path / d / "params.pt"))
        cfg, got = load_job(str(tmp_path / d))
        assert isinstance(cfg, tconfigs.TrainConfig)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert set(got) == set(sd)
    with open(tmp_path / "port" / "config.json") as f:
        back = jconfigs.train_config_from_dict(json.load(f))
    assert dataclasses.asdict(back) == dataclasses.asdict(jcfg)


def test_registry_is_the_ports_own(monkeypatch):
    monkeypatch.setitem(tregistry.DATASET_LABELS, "mydata", ("a", "b", "c"))
    cfg = tconfigs.build_train_config("layoutdm", "mydata")
    assert cfg.dataset.num_categories == 3
    assert "mydata" not in JAX_LABELS
    assert tregistry.DATASET_LABELS is tconfigs.DATASET_LABELS


def test_entry_points_default_to_cuda(tmp_path):
    """build_model, LayoutDM and LayoutService run on CUDA unless given
    device="cpu": on a host without CUDA they raise, and with
    device="cpu" they run."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the defaults would run there")
    cfg = tconfigs.build_train_config("layoutdm", "synthetic", TINY)
    tok = build_tokenizer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LayoutDM(cfg.backbone, tok, cfg.model)
    model = build_model(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    assert LayoutDM(cfg.backbone, tok, cfg.model, device="cpu").net.head.weight.is_cpu

    save_config(cfg, str(tmp_path))
    save_params(model.net.state_dict(), str(tmp_path / "params.pt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LayoutService(str(tmp_path), warm_tasks=())
    svc = LayoutService(str(tmp_path), max_batch_size=2, warm_tasks=(), device="cpu")
    try:
        out = svc.generate("unconditional", 2, seed=1, layout=None)
        assert len(out["layouts"]) == 2 and svc.info()["device"] == "cpu"
    finally:
        svc.close()


def test_jax_job_weights_serve_on_the_fused_path(tmp_path):
    """A JAX checkpoint bridged with params_from_flax feeds the fused path
    unchanged: the same flax tree serves both denoiser paths."""
    from layoutdm_tpu.factory import build_model as jax_build_model
    from layoutdm_tpu_torch.utils.params import params_from_flax, save_job

    jcfg = jconfigs.build_train_config("layoutdm", "synthetic", TINY)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jax_ckpt.save_config(jcfg, str(tmp_path / "jax"))
    with open(tmp_path / "jax" / "config.json") as f:
        cfg = tconfigs.train_config_from_dict(json.load(f))
    save_job(cfg, params_from_flax(jax.tree.map(np.asarray, params)), str(tmp_path / "port"))
    outs = []
    for fused in (False, True):
        svc = LayoutService(str(tmp_path / "port"), max_batch_size=2, warm_tasks=(),
                            device="cpu", fused_block=fused, fused_ffn=fused)
        try:
            assert ("K4" in svc.info()["denoiser"]) == fused
            outs.append(svc.generate("c", 2, seed=4, layout={
                "label": [1, 2], "bbox": [[0.5, 0.5, 0.2, 0.2], [0.3, 0.3, 0.1, 0.1]]}))
        finally:
            svc.close()
    assert outs[0]["layouts"] == outs[1]["layouts"]  # float32: the same tokens
