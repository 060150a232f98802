"""Train the FIDNetV3 feature extractor (port of
``layoutdm_tpu/eval/fidnet_train.py``; reference `fid/train.py:30-210`).

    python -m layoutdm_tpu_torch.eval.fidnet_train <dataset> [--device cuda|cpu]

Objective parity: discriminate noise-added layouts (BCE) and reconstruct
labels (CE) and boxes (10x MSE) from the CLS feature; Adam 3e-4, batch 64,
200k iterations, AddNoiseToBBox(p=0.5) + LexicographicOrder transform, and
a validation sweep every ``log_every`` iterations.  The best weights go to
``{out_dir}/{name}-max{S}/model_best.pth.tar`` as ``{"state_dict": ...}``
under the reference's parameter names, which ``eval.fidnet.load_fidnet_v3``
of this package and ``load_torch_fidnet`` of the JAX package both read.
Runs on CUDA unless given ``--device cpu``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from layoutdm_tpu_torch.data.datasets import load_dataset
from layoutdm_tpu_torch.data.loader import batch_iterator
from layoutdm_tpu_torch.data.transforms import AddNoiseToBBox, LexicographicOrder
from layoutdm_tpu_torch.eval.fidnet import FIDNetV3
from layoutdm_tpu_torch.utils.device import require_device

logger = logging.getLogger(__name__)


def fid_transform(rng: np.random.RandomState, batch):
    out = dict(batch)
    noise_added = rng.rand(batch["bbox"].shape[0]) < 0.5
    noisy = AddNoiseToBBox()(rng, batch)
    out["bbox"] = np.where(
        noise_added[:, None, None], noisy["bbox"], batch["bbox"]
    )
    out = LexicographicOrder()(rng, out)
    out["is_real"] = noise_added.astype(np.float32)  # parity: fid/train.py:95
    return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {
        "bbox": torch.as_tensor(batch["bbox"], dtype=torch.float32, device=device),
        "label": torch.as_tensor(batch["label"], device=device).long(),
        "mask": torch.as_tensor(batch["mask"], device=device).bool(),
        "is_real": torch.as_tensor(batch["is_real"], dtype=torch.float32, device=device),
    }


def fid_loss(model: FIDNetV3, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The JAX package's loss (`fidnet_train.py:42-54`) on a device batch."""
    mask = batch["mask"]
    logit, logit_cls, bbox_pred = model(batch["bbox"], batch["label"], ~mask)
    bce = F.binary_cross_entropy_with_logits(logit, batch["is_real"], reduction="none")
    ce = F.cross_entropy(logit_cls.flatten(0, 1), batch["label"].flatten(),
                         reduction="none").view(mask.shape)
    n = mask.sum().clamp(min=1)
    ce = torch.where(mask, ce, 0.0).sum() / n
    mse = ((bbox_pred - batch["bbox"]) ** 2).sum(-1)
    mse = torch.where(mask, mse, 0.0).sum() / n
    total = bce.mean() + ce + 10.0 * mse
    return total, {"bce": bce.mean(), "label": ce, "bbox": mse}


def train_step(model: FIDNetV3, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    total, parts = fid_loss(model, batch)
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    optimizer.step()
    return {"loss": total.detach(), **{k: v.detach() for k, v in parts.items()}}


def _save(model: FIDNetV3, path: str) -> None:
    tmp = path + ".tmp"
    torch.save({"state_dict": model.state_dict()}, tmp)
    os.replace(tmp, path)


def train_fidnet(
    dataset_name: str,
    data_dir: str,
    out_dir: str,
    max_seq_length: int = 25,
    batch_size: int = 64,
    iterations: int = 200_000,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 500,
    device="cuda",
) -> Tuple[FIDNetV3, List[Tuple[int, float]]]:
    """Train, checkpoint the best weights, and return the model with its
    (iteration, validation loss) history."""
    device = require_device(device)
    train_data = load_dataset(dataset_name, data_dir, "train", max_seq_length)
    val_data = load_dataset(dataset_name, data_dir, "test", max_seq_length)
    num_labels = len(train_data.labels)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FIDNetV3(num_labels=num_labels, max_bbox=max_seq_length, device="cpu")
    model.to(device).train()
    rng_np = np.random.RandomState(seed)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)

    ckpt_dir = os.path.join(out_dir, f"{dataset_name}-max{max_seq_length}")
    os.makedirs(ckpt_dir, exist_ok=True)
    best_path = os.path.join(ckpt_dir, "model_best.pth.tar")
    best = float("inf")
    history = []
    it = 0
    while it < iterations:
        for batch in batch_iterator(train_data, batch_size, rng_np, fid_transform):
            train_step(model, optimizer, to_device(batch, device))
            it += 1
            if it % log_every == 0:
                # validation sweep (`fid/train.py:150-199`)
                with torch.no_grad():
                    vals = [
                        float(fid_loss(model, to_device(vb, device))[0])
                        for vb in batch_iterator(
                            val_data, batch_size, rng_np, fid_transform,
                            shuffle=False, drop_last=False,
                        )
                    ]
                vloss = float(np.mean(vals))
                logger.info("iter %d val_loss %.4f", it, vloss)
                history.append((it, vloss))
                if vloss < best:
                    best = vloss
                    _save(model, best_path)
            if it >= iterations:
                break
    # always leave a checkpoint, even for runs shorter than log_every
    if not os.path.exists(best_path):
        _save(model, best_path)
    return model, history


def main(argv=None):
    import argparse

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("dataset")
    p.add_argument("--data_dir", default="download/datasets")
    p.add_argument("--out_dir", default="download/fid_weights/FIDNetV3")
    p.add_argument("--max_seq_length", type=int, default=25)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--iteration", type=int, default=200_000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument(
        "--register_module",
        default="",
        help="module/.py registering a custom dataset (docs/custom_dataset.md)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    require_device(a.device)
    if a.register_module:
        from layoutdm_tpu_torch.registry import import_registrations

        import_registrations(a.register_module)
    return train_fidnet(
        a.dataset, a.data_dir, a.out_dir, a.max_seq_length, a.batch_size,
        a.iteration, a.lr, device=a.device,
    )


if __name__ == "__main__":
    main()
