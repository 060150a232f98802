"""The port's product-API demo (`layoutdm_tpu_torch.demo`, counterpart of
``notebooks/demo.py``) on the CPU at a tiny width: the seven files, one
GIF frame a diffusion step, and the ground truth's encode / decode round
trip equal to the JAX tokenizer's on the same synthetic test rows."""

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from layoutdm_tpu.configs import build_train_config as jax_build_train_config
from layoutdm_tpu.data.datasets import load_dataset as jax_load_dataset
from layoutdm_tpu.factory import build_tokenizer as jax_build_tokenizer
from layoutdm_tpu_torch import demo
from layoutdm_tpu_torch.configs import build_train_config
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.utils.params import save_job

T = 10
TINY = ["backbone.d_model=64", "backbone.nhead=2", "backbone.dim_feedforward=64",
        "backbone.num_layers=1", f"model.num_timesteps={T}", f"backbone.diffusion_step={T}"]
GIF_FRAME_MS = 80  # `utils.visualization.save_gif`'s duration a frame


def _check_outputs(out, out_dir):
    for name in demo.FILES:
        assert (out_dir / name).stat().st_size > 0, name
    assert set(out["files"]) == {p.name for p in out_dir.iterdir()}
    # one frame a step: the GIF writer merges equal consecutive frames and
    # adds up their durations
    assert out["gif_frames"] == out["num_timesteps"] == T
    gif = Image.open(out_dir / "diffusion.gif")
    assert sum(f.info["duration"] for f in ImageSequence.Iterator(gif)) == T * GIF_FRAME_MS


def test_untrained_demo_writes_every_file_and_round_trips_like_jax(tmp_path):
    out = demo.main(["--untrained", "--device", "cpu", "--out_dir", str(tmp_path), *TINY])
    _check_outputs(out, tmp_path)
    # the JAX tokenizer's encode / decode of the same rows (the demo's config)
    cfg = jax_build_train_config("layoutdm", "synthetic", demo.UNTRAINED)
    cfg.data.pad_until_max = True
    tok = jax_build_tokenizer(cfg)
    data = jax_load_dataset("synthetic", cfg.dataset.dir, "test", cfg.dataset.max_seq_length)
    want = tok.decode(np.asarray(tok.encode(data.slice(np.arange(4)))["seq"]))
    assert set(out["roundtrip"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(out["roundtrip"][k], np.asarray(v), err_msg=k)


def test_demo_loads_a_job(tmp_path):
    """``--job_dir``: the job's config and weights (overrides are ignored)."""
    cfg = build_train_config("layoutdm", "synthetic", demo.UNTRAINED + TINY)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    save_job(cfg, model.net.state_dict(), str(tmp_path / "job"))
    out_dir = tmp_path / "out"
    out = demo.main(["--job_dir", str(tmp_path / "job"), "--device", "cpu",
                     "--out_dir", str(out_dir), "--num_samples", "2", "backbone.num_layers=3"])
    _check_outputs(out, out_dir)


def test_demo_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(["--untrained", "--out_dir", str(tmp_path), *TINY])
