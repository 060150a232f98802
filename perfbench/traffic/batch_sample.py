"""Batch sampling, as ``sample_cli`` runs it: ``LayoutDM.sample`` with one
``torch.Generator`` on the card, unconditional, the cell's ``batch`` rows a
chain at the trained T, chains back to back, every chain's layouts decoded
and copied to the host.

Cell parameters: ``batch``, ``check_rows`` (rows of each chain the
reference follows, drawn from the seed).  End to end: ``layouts_per_s``,
the layouts of every chain the window ran over the whole window, and
``setup_s``.  With ``--trace 1`` one more chain runs inside the profiler
after the window."""

from __future__ import annotations

import sys
import tempfile
import time

import numpy as np
import torch

from perfbench.lib import checks, faults, program
from perfbench.lib.harness import Context, Outcome
from perfbench.lib.stretch import Stretch
from perfbench.lib.tap import ChainTap
from perfbench.reference import denoiser, diffusion
from perfbench.reference.tasks import unconditional
from perfbench.reference.tokens import Vocab


def sampling():
    from layoutdm_tpu_torch.configs import SamplingConfig

    return SamplingConfig(name="random")


def run(ctx: Context, control=None, fault=None) -> Outcome:
    """``control(model)``, where given, switches the program to a path of
    lower precision before set-up ends (the comparison's control);
    ``fault(model)`` plants a fault (`lib/faults.py`)."""
    dev, cfg, B = ctx.device, ctx.cfg, ctx.cell["batch"]
    s_weights, s_rows, s_warm, s_chain = ctx.seeds(4)
    vocab = Vocab.of(cfg)
    params = denoiser.make_params(cfg, vocab.size, s_weights, dev)
    model = program.build(cfg, params, dev)
    if control is not None:
        control(model)
    if fault is not None:
        fault(model)
    rs = np.random.default_rng(s_rows)
    R = ctx.cell["check_rows"]
    tap = ChainTap(model, rows=lambda b: np.sort(rs.choice(b, R, replace=False)))
    tap.on = False
    cfg_s = sampling()
    model.sample(torch.Generator(device=dev).manual_seed(s_warm), B, sampling=cfg_s)
    sync(dev)
    setup_s = time.perf_counter() - ctx.started

    gen = torch.Generator(device=dev).manual_seed(s_chain)
    tap.on = True
    hosts = []
    t0 = time.perf_counter()
    while True:
        out = model.sample(gen, B, sampling=cfg_s)
        hosts.append({k: v.cpu() for k, v in out.items()})
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window = time.perf_counter() - t0
    tap.on = False
    done = B * len(hosts)
    missed = tap.faults(len(hosts), cfg["num_timesteps"])
    for m in missed:
        print(f"batch_sample: {m}; the chain's calls changed and the tap has to follow",
              file=sys.stderr)
    answers = [{k: v[torch.as_tensor(rec["rows"])] for k, v in host.items()}
               for host, rec in zip(hosts, tap.records)]
    del hosts
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    trace = None
    if ctx.trace:
        stretch = Stretch(tempfile.mkdtemp(prefix="perfbench-trace-"))
        stretch.start()
        model.sample(gen, B, sampling=cfg_s)
        trace = stretch.stop()
    tap.remove()
    records = tap.records
    del model, tap, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    compared = judge_chains(cfg, params, records, answers, dev)
    compared["chains_unchecked"] = done // B - len(answers)
    counters = {"layouts_per_s": done / window, "batch": B, "seq_len": vocab.seq_len,
                "layers": cfg["num_layers"], "chains": len(records)}
    return Outcome(e2e={"layouts_per_s": done / window, "setup_s": setup_s},
                   attempted=done, failed=0, memory_peak_bytes=peak, compared=compared,
                   counters=counters, trace=trace)


def judge_chains(cfg, params, records, answers, dev):
    """The reference follows each recorded chain's rows step by step and
    decodes what they returned."""
    vocab = Vocab.of(cfg)
    diff = diffusion.Diffusion(cfg, dev)
    results, mismatch = [], 0
    with torch.no_grad(), checks.reference_precision():
        for rec, ans in zip(records, answers):
            R = len(rec["rows"])
            steps = torch.stack(rec["steps"])
            shape = (rec["batch"], vocab.seq_len, vocab.size)
            c = unconditional(vocab, R).to(dev)
            noise_of = checks.generator_noise_of(rec["states"], rec["rows"], shape, dev)
            results.append(checks.chain_gaps(diff, params, cfg, steps, rec["final"], c, noise_of))
            mismatch += checks.decode_mismatch(vocab.decode(rec["final"].long()), ans)
    out = checks.merge(results)
    out["decode_mismatch"] = mismatch
    return out


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)



def int8_control(model) -> None:
    """The program's own int8 serving path (static int8 GEMMs, K1) in place
    of its bf16 denoiser: the control the comparison has to fail."""
    import os

    from layoutdm_tpu_torch.models.int8_serving import can_use_int8, make_int8_predict_start

    os.environ["LAYOUTDM_TPU_INT8"] = "1"
    try:
        if not can_use_int8(model.backbone_cfg, "elem_attr"):
            raise ValueError("the int8 path does not take this configuration")
        model._predict_start = make_int8_predict_start(model)
    finally:
        os.environ.pop("LAYOUTDM_TPU_INT8")


CONTROLS = {"int8": int8_control}
FAULTS = {"frozen": faults.frozen, "token": faults.token}
