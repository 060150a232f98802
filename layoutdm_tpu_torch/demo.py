"""Product-API demo (counterpart of ``notebooks/demo.py``, the
``demo.ipynb`` walkthrough): load a trained job or random weights,
encode and decode ground-truth layouts, sample unconditionally, sample
each conditional task from one condition broadcast to N samples, and write
a GIF of the intermediate diffusion states.

    python -m layoutdm_tpu_torch.demo --job_dir <job> [--out_dir tmp/demo]
    python -m layoutdm_tpu_torch.demo --untrained [key=value ...]   # random weights, synthetic data

Writes ``gt_roundtrip.png``, ``unconditional.png``, ``c.png``, ``cwh.png``,
``partial.png``, ``refinement.png`` and ``diffusion.gif`` (one frame a
step) under ``--out_dir``.  The chains draw from a ``torch.Generator`` on
the model's device seeded 0, the conditions' draws (partial, refinement)
from one on the CPU seeded 0, as `tasks.get_cond` takes them; the JAX
package's random streams are not reproduced.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

TASKS = ("c", "cwh", "partial", "refinement")
UNTRAINED = ["data.bbox_quantization=linear", "dataset.max_seq_length=8"]
FILES = ("gt_roundtrip.png", "unconditional.png", *(f"{t}.png" for t in TASKS),
         "diffusion.gif")


def _numpy(layouts: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in layouts.items()}


def main(argv=None) -> Dict:
    """Runs the demo; returns the output directory and files, the decoded
    round trip of the ground truth, the GIF's frame count and the model's
    steps and layers."""
    from layoutdm_tpu_torch.configs import SamplingConfig, build_train_config
    from layoutdm_tpu_torch.data.datasets import load_dataset
    from layoutdm_tpu_torch.factory import build_model, build_tokenizer
    from layoutdm_tpu_torch.tasks import get_cond, to_sampler_cond
    from layoutdm_tpu_torch.train.checkpoint import load_params
    from layoutdm_tpu_torch.utils.params import load_config
    from layoutdm_tpu_torch.utils.visualization import save_gif, save_image

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--job_dir", default=None)
    p.add_argument("--out_dir", default="tmp/demo")
    p.add_argument("--untrained", action="store_true")
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("overrides", nargs="*", help="key=value config overrides (untrained mode)")
    a = p.parse_args(argv)
    if not (a.job_dir or a.untrained):
        p.error("--job_dir or --untrained required")

    # config, tokenizer, model and weights
    if a.job_dir:
        cfg = load_config(a.job_dir)
    else:
        cfg = build_train_config("layoutdm", "synthetic", UNTRAINED + list(a.overrides))
    cfg.data.pad_until_max = True
    cfg.dataset.ensure_registered()
    tokenizer = build_tokenizer(cfg)
    model = build_model(cfg, tokenizer, a.device, generator=torch.Generator().manual_seed(0))
    if a.job_dir:
        model.net.load_state_dict(load_params(a.job_dir, "best"))
    os.makedirs(a.out_dir, exist_ok=True)
    sampling = SamplingConfig(name="random")
    gen = torch.Generator(device=model.device).manual_seed(0)
    cond_gen = torch.Generator().manual_seed(0)
    n, K = a.num_samples, cfg.dataset.num_categories

    def save(layouts, name):
        save_image(_numpy(layouts), os.path.join(a.out_dir, name), K)

    # encode -> decode ground-truth samples
    data = load_dataset(cfg.dataset.name, cfg.dataset.dir, "test", cfg.dataset.max_seq_length)
    roundtrip = tokenizer.decode(tokenizer.encode(data.slice(np.arange(n)))["seq"])
    save(roundtrip, "gt_roundtrip.png")

    # unconditional generation
    save(model.sample(gen, n, sampling=sampling), "unconditional.png")

    # one condition -> N samples, per task
    one = data.slice(np.arange(1))
    for task in TASKS:
        cond = get_cond(one, tokenizer, task, generator=cond_gen)
        sc = to_sampler_cond(cond, tokenizer, sampling, batch_size=n)
        save(model.sample(gen, n, cond=sc, sampling=sampling), f"{task}.png")

    # GIF of the intermediate diffusion states
    _, inter = model.sample_ids(gen, 1, sampling=sampling, get_intermediates=True)
    frames = [_numpy(tokenizer.decode(step_ids)) for step_ids in inter]
    save_gif(frames, os.path.join(a.out_dir, "diffusion.gif"), K)
    print(f"demo outputs in {a.out_dir}")
    return {"out_dir": a.out_dir, "files": list(FILES), "roundtrip": _numpy(roundtrip),
            "gif_frames": len(frames), "num_timesteps": model.q.num_timesteps,
            "num_layers": model.backbone_cfg.num_layers}


if __name__ == "__main__":
    main()
