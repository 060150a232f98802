"""The port's batch sampling CLI (`layoutdm_tpu_torch.sample_cli`) on the
CPU over the synthetic dataset at a tiny width: every task writes the JAX
CLI's pickle (file name, keys and types, as `layoutdm_tpu/sample_cli.py`
writes them and `tests/test_cli.py` reads them), a seed gives the same
layouts twice, relation reports a violation rate, and the CLI runs on CUDA
unless told otherwise."""

import glob
import os
import pickle

import numpy as np
import pytest

from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.sample_cli import main, run_sampling
from layoutdm_tpu_torch.train.loop import main as train_main

TASKS = ["unconditional", "c", "cwh", "partial", "refinement", "relation"]
N = 6


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A job of the port's trainer (two debug epochs); T = 20, so relation
    guidance (t >= 10) runs."""
    root = tmp_path_factory.mktemp("sample_cli")
    train_main([
        "layoutdm", "synthetic", "debug=true", "device=cpu", f"job_dir={root}/job",
        f"dataset.dir={root}/datasets", "dataset.max_seq_length=5",
        "backbone.d_model=128", "backbone.nhead=2", "backbone.dim_feedforward=64",
        "backbone.num_layers=2", "model.num_timesteps=20", "backbone.diffusion_step=20",
        "training.sample_plot_epoch_interval=0",
    ])
    return f"{root}/job"


def _args(job, result_dir, cond):
    return [f"job_dir={job}", f"result_dir={result_dir}", f"cond={cond}", "device=cpu",
            f"debug_num_samples={N}", f"num_uncond_samples={N}", "max_batch_size=4",
            "num_timesteps=20"]


@pytest.mark.parametrize("cond", TASKS)
def test_every_task_writes_the_jax_pickle(job, tmp_path, cond):
    (path,) = main(_args(job, str(tmp_path / "a"), cond))
    assert os.path.basename(path) == f"{cond}_test_seed_0.pkl"
    assert glob.glob(str(tmp_path / "a" / "*.pkl")) == [path]
    with open(path, "rb") as f:
        res = pickle.load(f)
    keys = {"results", "inputs", "train_cfg", "test_cfg", "ms_per_sample"}
    assert set(res) == keys | ({"violation_rate"} if cond == "relation" else set())
    assert len(res["results"]) == N
    for bbox, label in res["results"]:
        assert isinstance(bbox, np.ndarray) and bbox.dtype == np.float32
        assert isinstance(label, np.ndarray) and label.dtype == np.int32
        assert bbox.shape == (len(label), 4) and ((bbox >= 0) & (bbox <= 1)).all()
    assert len(res["inputs"]) == (N if cond in ("partial", "refinement") else 0)
    assert isinstance(res["train_cfg"], dict) and res["test_cfg"]["cond"] == cond
    assert isinstance(res["ms_per_sample"], float) and res["ms_per_sample"] > 0
    if cond == "relation":
        assert 0.0 <= res["violation_rate"] <= 1.0
    if cond == "c":
        # the categories are kept
        assert [sorted(lab.tolist()) for _, lab in res["results"]] == [
            sorted(lab.tolist()) for _, lab in _ground_truth(job)]

    # the same seed gives the same layouts
    (again,) = main(_args(job, str(tmp_path / "b"), cond))
    with open(again, "rb") as f:
        res2 = pickle.load(f)
    for (b1, l1), (b2, l2) in zip(res["results"], res2["results"]):
        np.testing.assert_array_equal(b1, b2)
        np.testing.assert_array_equal(l1, l2)


def _ground_truth(job):
    from layoutdm_tpu_torch.data.datasets import load_dataset
    from layoutdm_tpu_torch.utils.params import load_job

    cfg, _ = load_job(job)
    data = load_dataset(cfg.dataset.name, cfg.dataset.dir, "test", cfg.dataset.max_seq_length)
    return [(data.bbox[i][data.mask[i]], data.label[i][data.mask[i]]) for i in range(N)]


def test_cuda_by_default_and_no_trace(job, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([f"job_dir={job}", f"result_dir={tmp_path}", "cond=c"])
    # trace_dir is ported: the run writes a profiler trace there
    cfg = tconfigs.TestConfig(job_dir=job, cond="c", trace_dir=str(tmp_path / "trace"),
                              debug_num_samples=2, max_batch_size=2, num_timesteps=2)
    run_sampling(cfg, job, device="cpu")
    assert [p.name for p in (tmp_path / "trace").iterdir()] == [f"trace_{os.getpid()}.json"]
