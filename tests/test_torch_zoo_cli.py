"""Every family of the port's baseline zoo (MaskGIT, BLT, RUITE, the
autoregressive LayoutTransformer, VQDiffusion, BART, DiffusionLM,
BitDiffusion) trained two steps by the CPU trainer and sampled by
`sample_cli`, as `tests/test_cli_models.py` does for the JAX package; the
MaskGIT and BitDiffusion jobs also behind the service (one request a run,
relation refused)."""

import glob
import os
import pickle

import numpy as np
import pytest

from layoutdm_tpu_torch import configs as tconfigs


@pytest.mark.parametrize("experiment,cond", [
    ("maskgit", "unconditional"), ("blt", "c"), ("ruite", "refinement"),
    ("autoreg", "unconditional"), ("vqdiffusion", "c"), ("bart", "partial"),
    ("diffusionlm", "unconditional"), ("bitdiffusion", "c"),
])
def test_cli_trains_and_samples_each_family(tmp_path, experiment, cond):
    from layoutdm_tpu_torch.sample_cli import main as sample_main
    from layoutdm_tpu_torch.serve_cli import LayoutService
    from layoutdm_tpu_torch.train.loop import train

    job = str(tmp_path / experiment)
    cfg = tconfigs.build_train_config(experiment, "synthetic", [
        f"job_dir={job}", f"dataset.dir={tmp_path}/datasets", "debug=true",
        "dataset.max_seq_length=4", "data.batch_size=16", "data.bbox_quantization=linear",
        "backbone.d_model=64", "backbone.nhead=2", "backbone.dim_feedforward=64",
        "backbone.num_layers=1", "model.num_timesteps=6", "backbone.diffusion_step=6",
        "training.sample_plot_epoch_interval=0",
    ])
    result = train(cfg, device="cpu")
    assert np.isfinite(result["best_val_loss"])
    assert os.path.exists(os.path.join(job, "aux_state.pt")) == (
        experiment in ("maskgit", "blt", "vqdiffusion"))
    out = str(tmp_path / "results")
    sample_main([f"job_dir={job}", f"result_dir={out}", f"cond={cond}", "num_timesteps=6",
                 "num_uncond_samples=8", "max_batch_size=8", "debug_num_samples=8",
                 "device=cpu"])
    (pkl,) = glob.glob(os.path.join(out, f"{cond}_*.pkl"))
    with open(pkl, "rb") as f:
        res = pickle.load(f)
    assert len(res["results"]) == 8
    for bbox, label in res["results"]:
        assert bbox.shape == label.shape + (4,) and np.isfinite(bbox).all()
    if experiment == "maskgit":  # a zoo lane: one request a run, no relation
        svc = LayoutService(job, max_batch_size=4, timestep_ladder=(2,), device="cpu")
        try:
            assert svc.info()["coalescing"] is False
            a = svc.generate("unconditional", 2, seed=41, layout=None)
            b = svc.generate("unconditional", 2, seed=41, layout=None)
            assert a["layouts"] == b["layouts"]
            assert all(1 <= len(x["label"]) <= 4 for x in a["layouts"])
            c = svc.generate("c", 1, seed=1, layout={"label": [1], "bbox": [[0.5, 0.5, 0.2, 0.2]]},
                             num_timesteps=2)
            assert c["layouts"][0]["label"] == [1]
            with pytest.raises(ValueError, match="guidance"):
                svc.generate("relation", 1, seed=1, layout={"label": [1, 2]},
                             relations=[{"src": 0, "dst": 1, "loc": "left"}])
        finally:
            svc.close()
    if experiment == "bitdiffusion":  # continuous lanes: one request a run, no relation
        svc = LayoutService(job, max_batch_size=4, device="cpu")
        try:
            assert svc.info()["coalescing"] is False
            a = svc.generate("c", 2, seed=5, layout={"label": [1], "bbox": [[0.5, 0.5, 0.2, 0.2]]})
            b = svc.generate("c", 2, seed=5, layout={"label": [1], "bbox": [[0.5, 0.5, 0.2, 0.2]]})
            assert a["layouts"] == b["layouts"] and len(a["layouts"]) == 2
            with pytest.raises(ValueError, match="guidance"):
                svc.generate("relation", 1, seed=1, layout={"label": [1, 2]},
                             relations=[{"src": 0, "dst": 1, "loc": "left"}])
        finally:
            svc.close()
