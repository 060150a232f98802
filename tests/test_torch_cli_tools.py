"""The port's user surfaces beside the model: the clustering CLI against
the JAX package's `bin/clustering_coordinates.py`, remote (``scheme://``)
job directories through fsspec's ``memory://`` filesystem, and a custom
dataset end to end (register -> ingest CLI -> train and sample through the
port's launchers -> eval), after `tests/test_custom_dataset.py`."""

import glob
import json
import os
import pickle
import runpy
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from layoutdm_tpu_torch.clustering_cli import main as clustering_main
from layoutdm_tpu_torch.train import checkpoint as ckpt
from layoutdm_tpu_torch.train.step import init_train_state, make_optimizer, train_step
from torch_port_helpers import layout_batch, port_layoutdm, tokenizers

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("algorithm", ["percentile", "kmeans"])
def test_clustering_cli_writes_the_jax_scripts_npz(tmp_path, monkeypatch, algorithm):
    args = ["synthetic", "--data_dir", str(tmp_path / "datasets"), "--max_seq_length", "5",
            "--algorithm", algorithm]
    got_path = clustering_main(args + ["--out_dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["clustering_coordinates.py", *args,
                                      "--out_dir", str(tmp_path / "jax")])
    runpy.run_path(str(REPO / "bin" / "clustering_coordinates.py"), run_name="__main__")
    name = f"synthetic_max5_{algorithm}_train_clusters.npz"
    assert os.path.basename(got_path) == name
    got, want = np.load(got_path), np.load(tmp_path / "jax" / name)
    assert set(got.files) == set(want.files) and len(got.files) == 4 * 8
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])


def test_memory_job_directory_round_trip():
    """config, weights and the full train state through ``memory://``."""
    from layoutdm_tpu_torch.configs import build_train_config

    job = "memory://port-job/run1"
    cfg = build_train_config("layoutdm", "synthetic", ["seed=3", f"job_dir={job}"])
    ckpt.save_config(cfg, job)
    assert ckpt.load_config(job) == cfg

    _, tt = tokenizers()
    model = port_layoutdm(tt, generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, make_optimizer(model.net), 1.0)
    gen = torch.Generator().manual_seed(1)
    train_step(state, model.preprocess(layout_batch(np.random.RandomState(0), 4)), gen)
    ckpt.save_params(model.net.state_dict(), job, "best", state.lt_state)
    ckpt.save_train_state(state, job, {"torch": gen.get_state()})
    for k, v in ckpt.load_params(job).items():
        assert torch.equal(v, model.net.state_dict()[k]), k

    other = port_layoutdm(tt, generator=torch.Generator().manual_seed(5))
    restored = init_train_state(other, make_optimizer(other.net), 1.0)
    gens = ckpt.load_train_state(restored, job)
    assert restored.step == 1 and torch.equal(gens["torch"], gen.get_state())
    assert torch.equal(restored.lt_state.history, state.lt_state.history)
    for k, v in other.net.state_dict().items():
        assert torch.equal(v, model.net.state_dict()[k]), k
    assert restored.optimizer.state_dict()["state"].keys() == \
        state.optimizer.state_dict()["state"].keys()


def test_sample_cli_and_service_read_a_memory_job(tmp_path):
    """`sample_cli` and the service load config, weights and aux state from
    a ``memory://`` job: the layouts of the same job written locally."""
    from layoutdm_tpu_torch.configs import SamplingConfig, build_train_config
    from layoutdm_tpu_torch.factory import build_model
    from layoutdm_tpu_torch.sample_cli import main as sample_main
    from layoutdm_tpu_torch.serve_cli import LayoutService

    cfg = build_train_config("layoutdm", "synthetic", [
        f"dataset.dir={tmp_path}/datasets", "dataset.max_seq_length=5",
        "data.bbox_quantization=linear", "backbone.d_model=64", "backbone.nhead=2",
        "backbone.dim_feedforward=32", "backbone.num_layers=1", "model.num_timesteps=4",
        "backbone.diffusion_step=4"])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(2)
    lt = model.init_state()
    lt.history.copy_(torch.as_tensor(rs.uniform(0.1, 2, lt.history.shape)))
    lt.count.fill_(10.0)  # a trained Lt state, read by the sampler's importance weights
    remote, local = "memory://port-sample/job", str(tmp_path / "job")
    for job in (remote, local):
        ckpt.save_config(cfg, job)
        ckpt.save_params(model.net.state_dict(), job, "best", lt)

    def sample(job):
        (path,) = sample_main([f"job_dir={job}", f"result_dir={tmp_path / 'r'}", "cond=c",
                               "device=cpu", "debug_num_samples=4", "max_batch_size=4",
                               "num_timesteps=4"])
        with open(path, "rb") as f:
            return pickle.load(f)["results"]

    assert pickle.dumps(sample(remote)) == pickle.dumps(sample(local))
    svc = LayoutService(remote, max_batch_size=4, warm_tasks=(),
                        sampling=SamplingConfig(name="deterministic"), device="cpu")
    try:
        assert torch.equal(svc.state.history, lt.history)
        for k, v in model.net.state_dict().items():
            assert torch.equal(svc.model.net.state_dict()[k], v), k
    finally:
        svc.close()


def test_remote_needs_fsspec_and_local_never_imports_it(tmp_path, monkeypatch):
    code = textwrap.dedent(f"""
        import sys
        from layoutdm_tpu_torch.configs import build_train_config
        from layoutdm_tpu_torch.train import checkpoint as ckpt
        ckpt.save_config(build_train_config("layoutdm", "synthetic", []), {str(tmp_path)!r})
        ckpt.load_config({str(tmp_path)!r})
        assert "fsspec" not in sys.modules
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    monkeypatch.setitem(sys.modules, "fsspec", None)  # as if it were not installed
    with pytest.raises(RuntimeError, match="needs the fsspec package"):
        ckpt.load_config("memory://port-job/none")


TOY_MODULE = textwrap.dedent(
    '''
    """Toy custom dataset for the port: three-label posters."""
    import json, os
    import numpy as np
    from layoutdm_tpu_torch.registry import register_dataset


    def parse(raw_dir, max_seq_length):
        with open(os.path.join(raw_dir, "layouts.json")) as f:
            raw = json.load(f)
        out = []
        for item in raw:
            bbox = np.asarray(item["bbox"], np.float32)
            label = np.asarray(item["label"], np.int32)
            if 0 < len(label) <= max_seq_length:
                out.append((bbox, label, item.get("name", "")))
        return out


    register_dataset("toyports", labels=("header", "body", "image"), canvas=(400, 600),
                     parser=parse)
    '''
)


def _write_raw(raw_dir: str, n: int = 96, max_elements: int = 4) -> None:
    rng = np.random.RandomState(7)
    os.makedirs(raw_dir, exist_ok=True)
    items = []
    for i in range(n):
        k = rng.randint(1, max_elements + 1)
        label = rng.randint(0, 3, size=k)
        bbox = np.stack([np.clip(0.5 + 0.1 * rng.randn(k), 0.1, 0.9),
                         np.sort(rng.rand(k)).clip(0.05, 0.95),
                         np.clip(0.2 + 0.2 * label, 0.05, 0.95),
                         np.clip(0.05 + 0.05 * label, 0.02, 0.5)], axis=1)
        items.append({"bbox": bbox.tolist(), "label": label.tolist(), "name": f"p{i}"})
    items.append({"bbox": [], "label": [], "name": "empty"})  # skipped by the parser
    with open(os.path.join(raw_dir, "layouts.json"), "w") as f:
        json.dump(items, f)


def test_custom_dataset_register_ingest_train_sample_eval(tmp_path, capsys):
    from layoutdm_tpu_torch.data.ingest import main as ingest_main
    from layoutdm_tpu_torch.eval_cli import main as eval_main

    module = tmp_path / "toy_port_dataset.py"
    module.write_text(TOY_MODULE)
    data_dir = tmp_path / "datasets"
    _write_raw(str(data_dir / "toyports-max4" / "raw"))
    assert ingest_main(["toyports", "--data_dir", str(data_dir), "--max_seq_length", "4",
                        "--register_module", str(module)]) == 0
    proc = data_dir / "toyports-max4" / "processed"
    sizes = [len(np.load(proc / f"{s}.npz")["mask"]) for s in ("train", "val", "test")]
    assert sum(sizes) == 96 and sizes[0] == int(96 * 0.85)

    # train and sample through the port's launchers (bin/train.sh's arguments)
    job, results = tmp_path / "job", tmp_path / "results"
    run = dict(cwd=REPO, capture_output=True, text=True, timeout=300)
    out = subprocess.run(
        ["bash", "bin/train_torch.sh", "toyports", "layoutdm", f"job_dir={job}",
         f"dataset.register_module={module}", f"dataset.dir={data_dir}", "debug=true",
         "device=cpu", "dataset.max_seq_length=4", "data.batch_size=16",
         "data.bbox_quantization=linear", "backbone.d_model=64", "backbone.nhead=2",
         "backbone.dim_feedforward=32", "backbone.num_layers=1", "model.num_timesteps=4",
         "backbone.diffusion_step=4", "training.sample_plot_epoch_interval=0"], **run)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(job / "config.json") as f:
        persisted = json.load(f)
    assert persisted["dataset"]["name"] == "toyports"
    assert persisted["dataset"]["register_module"] == str(module)
    assert np.isfinite(json.loads((job / "result.json").read_text())["best_val_loss"])

    out = subprocess.run(
        ["bash", "bin/test_torch.sh", str(job), str(results), "cond=c", "device=cpu",
         "num_timesteps=4", "max_batch_size=8", "debug_num_samples=8"], **run)
    assert out.returncode == 0, out.stderr[-2000:]
    (pkl,) = glob.glob(str(results / "c_*.pkl"))
    with open(pkl, "rb") as f:
        res = pickle.load(f)
    assert len(res["results"]) == 8
    assert all(label.max(initial=0) < 3 for _, label in res["results"])

    capsys.readouterr()
    eval_main([str(results), "--dataset", "toyports", "--data_dir", str(data_dir),
               "--max_seq_length", "4", "--device", "cpu"])
    assert "maximum_iou" in capsys.readouterr().out
