"""Headline bench: Rico25 unconditional sampling throughput at T=100 on
one card, with its FLOP count and MFU (port of ``bench.py``).

    python -m layoutdm_tpu_torch.bench [--seed 0] [--out DIR] [key=value ...]

The flagship LayoutDM (Rico25: 25 categories, 25 elements, linear
quantization with 32 bins, 512 / 8 / 2048 shrunk 29/32 to 464 / 8 / 1856,
4 layers, constrained Q, T=100; bf16, random weights from ``--seed``)
samples unconditionally with the random sampler.  The denoiser path is
the JAX package's switches in the environment, as `factory.build_model`
reads them (``LAYOUTDM_TPU_FUSED_BLOCK`` / ``_FUSED_FFN``, ``_ATTN_V2``,
``_SMAJOR``); ``LAYOUTDM_TPU_INT8=1`` swaps the denoiser for the int8
serving mirror (``models.int8_serving``) and names the metric ``_int8``.

Rows (one JSON line each, `common.row`):

- the headline: layouts/s at B=1024 in the generator regime (whole-batch
  noise from one ``torch.Generator``, as the JAX bench draws it), one
  warm-up chain, then 3 timed chains; ``value`` is the median run.
  ``achieved_tflops`` is that rate times `flops.flops_per_layout`,
  ``mfu`` its share of the 989 TFLOP/s bf16 peak, ``mfu_vs_gemm_ceiling``
  its share of `flops.measure_gemm_ceiling` at the same batch;
- ``per_row_seed``: the same chain in the service's per-row-seed regime
  (each row's noise hashed from its own seed, `ops.samplers.row_gumbel`);
- ``train`` (without int8): the train step at B=1024, 20 steps a run;
- ``publaynet_scale`` (without int8): 5 categories, 100 elements (S=500
  tokens, V=135), B=256.

The batch is fixed: an out-of-memory error fails the run.  ``key=value``
config fields on the command line (or `run`'s ``overrides``) change both
models, as for a rehearsal at toy widths on the CPU.
"""

from __future__ import annotations

import argparse
import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from layoutdm_tpu_torch.bench.common import (
    CPU_REFERENCE_LAYOUTS_PER_SEC,
    DEFAULT_OUT,
    card,
    emit,
    mfu_fields,
    on_card,
    random_layouts,
    require_device,
    row,
    timed_runs,
    write_rows,
)
from layoutdm_tpu_torch.bench.flops import (
    flops_per_layout,
    measure_gemm_ceiling,
    train_flops_per_sample,
)
from layoutdm_tpu_torch.configs import SamplingConfig, build_train_config


def flagship_config(dataset: str = "rico25", max_elements: int = 25,
                    overrides: Sequence[str] = (), dtype: str = "bfloat16"):
    """The flagship's config (`bench.py:40-59`): the ``layoutdm`` overlay
    (512 / 8 / 2048, 4 layers, dropout 0, adalayernorm, T=100), linear
    quantization (the repo carries no clustering weights); ``dataset``
    sets the categories (rico25: 25, publaynet: 5)."""
    return build_train_config("layoutdm", dataset, [
        "data.bbox_quantization=linear", f"model.dtype={dtype}",
        f"dataset.max_seq_length={max_elements}", *overrides,
    ])


def build_flagship(cfg, device, seed: int = 0):
    from layoutdm_tpu_torch.factory import build_model

    return build_model(cfg, device=device, generator=torch.Generator().manual_seed(seed))


def use_int8(model, cfg) -> bool:
    from layoutdm_tpu_torch.models.int8_serving import can_use_int8, make_int8_predict_start

    if not can_use_int8(model.backbone_cfg, cfg.model.pos_emb):
        return False
    model._predict_start = make_int8_predict_start(model)
    return True


def chain_rows_per_s(model, batch: int, runs: int, device, seed: int,
                     per_row: bool = False) -> Dict:
    """Layouts/s of ``runs`` unconditional chains of the random sampler
    after one warm-up chain, and the last timed chain's ids.  ``per_row``
    draws each row's noise from its own seed (the service's regime), else
    the whole batch's from one generator."""
    sampling = SamplingConfig(name="random")
    last = {}

    def chain(i):
        if per_row:
            rng = torch.arange(batch, dtype=torch.int64) + (seed + i) * batch
        else:
            rng = torch.Generator(device=device).manual_seed(seed + i)
        ids = model.sample_ids(rng, batch, sampling=sampling)
        if ids.shape != (batch, model.seq_len):
            raise AssertionError(f"chain gave ids of shape {tuple(ids.shape)}")
        last["ids"] = ids

    rates = [batch / s for s in timed_runs(chain, runs, warmup=1, device=device)["runs"]]
    return {"runs": rates, "value": statistics.median(rates), "ids": last["ids"]}


def sampling_row(model, metric: str, batch: int, runs: int, device, info: Dict,
                 seed: int, regime: str = "generator", path: Optional[str] = None,
                 ceiling: bool = True) -> Dict:
    r = chain_rows_per_s(model, batch, runs, device, seed, per_row=regime == "per_row_seed")
    flops = flops_per_layout(model)
    gemm = measure_gemm_ceiling(batch, model, device) if ceiling and on_card(device) else None
    return row(
        device, info, r["runs"], "layouts/s",
        metric=metric, value=r["value"], unit="layouts/s",
        vs_baseline=r["value"] / CPU_REFERENCE_LAYOUTS_PER_SEC, batch=batch,
        seq_tokens=model.seq_len, num_timesteps=model.q.num_timesteps,
        est_gflops_per_layout=flops / 1e9, **mfu_fields(flops, r["value"], gemm),
        path=path or model.denoiser_path, regime=regime,
    )


def train_row(cfg, device, info: Dict, batch: int = 1024, n_steps: int = 20,
              runs: int = 3, seed: int = 0, metric="rico25_train_samples_per_sec_chip") -> Dict:
    """The flagship train step (AdamW, clipping, the Lt state; K1 forward,
    K2 backward): ``runs`` runs of ``n_steps`` steps on one batch of
    random layouts after one warm-up run; samples/s of the median run."""
    from layoutdm_tpu_torch.train.step import init_train_state, make_optimizer

    model = build_flagship(cfg, device, seed)
    optimizer = make_optimizer(model.net, cfg.optimizer.lr, cfg.training.weight_decay,
                               tuple(cfg.optimizer.betas))
    state = init_train_state(model, optimizer, cfg.training.grad_norm_clip)
    rs = np.random.RandomState(seed + 1)
    tokens = model.preprocess(random_layouts(rs, batch, cfg.dataset.max_seq_length,
                                             cfg.dataset.num_categories))
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    if on_card(device):
        torch.cuda.reset_peak_memory_stats()
    t = train_rates(state, [tokens], gen, batch, n_steps, runs, device)
    loss, rates, sps = t["losses"], t["runs"], t["value"]
    flops = train_flops_per_sample(model)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card(device) else None
    gemm = measure_gemm_ceiling(batch, model, device) if on_card(device) else None
    return row(
        device, info, rates, "samples/s",
        metric=metric, value=sps, unit="samples/s", batch=batch, ms_per_step=1e3 * batch / sps,
        steps_per_run=n_steps, est_gflops_per_sample=flops / 1e9, **mfu_fields(flops, sps, gemm),
        peak_memory_gib=peak, final_loss=loss[-1], path="train (K1 forward, K2 backward)",
    )


def train_rates(state, batches: List, gen, batch: int, n_steps: int, runs: int,
                device) -> Dict:
    """Samples/s of ``runs`` runs of ``n_steps`` train steps (cycling
    through ``batches``, each of ``batch`` rows) after one warm-up run,
    host clock around each run ending in a synchronise; the median run
    and every step's loss, which must be finite."""
    from layoutdm_tpu_torch.train.step import train_step

    losses = []

    def steps(_):
        for i in range(n_steps):
            losses.append(train_step(state, batches[i % len(batches)], gen)["loss"])

    t = timed_runs(steps, runs, warmup=1, device=device)
    loss = [float(v) for v in losses]
    if not np.isfinite(loss).all():
        raise AssertionError(f"train losses {loss}")
    rates = [batch * n_steps / s for s in t["runs"]]
    return {"runs": rates, "value": statistics.median(rates), "losses": loss}


def run(device="cuda", batch: int = 1024, runs: int = 3, seed: int = 0,
        train_batch: int = 1024, train_steps: int = 20, publaynet_batch: int = 256,
        overrides: Sequence[str] = (), out: Optional[str] = None) -> List[Dict]:
    """The headline's rows, each printed as it is measured; ``overrides``
    (``key=value`` config fields, both models) shrink them for a CPU
    rehearsal."""
    device = require_device(device)
    info = card(device)
    cfg = flagship_config(overrides=overrides)
    model = build_flagship(cfg, device, seed)
    int8 = use_int8(model, cfg)
    suffix = "_int8" if int8 else ""
    path = f"int8 mirror ({model.denoiser_path} attention)" if int8 else model.denoiser_path
    metric = f"rico25_uncond_layouts_per_sec_chip_T{model.q.num_timesteps}"
    rows = [emit(sampling_row(model, metric + suffix, batch, runs, device, info,
                              seed + 2, path=path))]
    rows.append(emit(sampling_row(model, metric + suffix + "_per_row_seed", batch, runs,
                                  device, info, seed + 2, regime="per_row_seed", path=path,
                                  ceiling=False)))
    del model
    if not int8:
        rows.append(emit(train_row(cfg, device, info, train_batch, train_steps, runs, seed)))
        pcfg = flagship_config("publaynet", 100, overrides)
        pmodel = build_flagship(pcfg, device, seed)
        rows.append(emit(sampling_row(
            pmodel, f"publaynet_scale_uncond_layouts_per_sec_chip_T"
            f"{pmodel.q.num_timesteps}", publaynet_batch, runs, device, info, seed + 2)))
        del pmodel
    if out:
        write_rows(out, "headline", rows)
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="of the random weights and noise")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("overrides", nargs="*", help="key=value config fields")
    a = ap.parse_args(argv)
    return run(a.device, seed=a.seed, overrides=a.overrides, out=a.out)


if __name__ == "__main__":
    main()
