"""Training, as the port's trainer feeds its step: ``train/step.py``
``train_step`` (AdamW, clipping, the Lt state) on batches that the port's
loader (``data/loader.py`` ``batch_iterator``, shuffled, with the
configuration's ``RandomOrder`` transform) cuts from an in-memory pool of
layouts drawn from the seed, through ``model.preprocess``.

Cell parameters: ``batch``, ``pool`` (layouts in the pool), ``staged``
(batches the loader prepares in set-up), ``trace_steps``.  Set-up runs the
loader and ``preprocess`` for ``staged`` batches (two epochs of the pool)
and drives the train state through its first three steps on the first
three (no layout twice); those steps are recorded and the reference
follows them; then the same state trains through the window on the staged
device batches in turn, so the window times ``train_step`` alone.  The
loader stays out of the window: run inside it, its synchronous copy of
each batch to the card put the host's loader work on every step's path
and swung the rate by up to 11% between runs of one seed.  End to end:
``train_samples_per_s`` (rows of every step the window ran over the whole
window) and ``setup_s``.  With ``--trace 1`` the cell's ``trace_steps``
steps run after the window under `lib.stretch.traced_steps`, behind
``TRACE_WARMUP`` steps the profiler keeps nothing of."""

from __future__ import annotations

import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.lib import program
from perfbench.lib.harness import Context, Outcome
from perfbench.lib.stretch import traced_steps
from perfbench.reference import denoiser, diffusion
from perfbench.reference.tokens import Vocab

CHECKED_STEPS = 3
TRACE_WARMUP = 3


def pool_layouts(rs: np.random.Generator, n: int, E: int, C: int) -> Dict[str, np.ndarray]:
    """``n`` layouts of 1..E elements (valid ones first), categories
    uniform, boxes uniform in the canvas."""
    k = rs.integers(1, E + 1, n)
    mask = np.arange(E)[None] < k[:, None]
    xy = rs.random((n, E, 2)) * 0.75
    wh = 0.05 + rs.random((n, E, 2)) * (1.0 - xy - 0.05).clip(0.0, 0.9)
    bbox = np.where(mask[..., None], np.concatenate([xy, wh], -1), 0.0).astype(np.float32)
    label = np.where(mask, rs.integers(0, C, (n, E)), 0).astype(np.int32)
    return {"bbox": bbox, "label": label, "mask": mask}


class StepTap:
    """Records what the first steps feed the denoiser: the loader's batch
    (``preprocess``'s input), the corrupted ids and timesteps
    (``_predict_start``'s, called once a step), and the embedding dropout's
    keep mask.  A step that no longer calls them so fails the comparison
    (``steps_unrecorded``): the tap has to follow such a change first."""

    def __init__(self, model):
        self.model = model
        self.batches: List[Dict] = []
        self.inputs: List[Dict] = []
        self._pre, self._ps = model.preprocess, model._predict_start
        model.preprocess = self._preprocess
        model._predict_start = self._predict_start

    def remove(self) -> None:
        self.model.preprocess, self.model._predict_start = self._pre, self._ps

    def _preprocess(self, batch, *a, **k):
        self.batches.append({key: np.array(v) for key, v in batch.items()})
        return self._pre(batch, *a, **k)

    def _predict_start(self, ids, t, dropout=None):
        rec = {"xt": ids.detach().clone(), "t": t.detach().clone(), "keep": None}
        self.inputs.append(rec)
        if dropout is None:
            return self._ps(ids, t)
        inner = dropout

        class Keep(type(dropout)):
            def __init__(self):  # a view on ``inner``'s draws
                pass

            def __call__(self, x, rate, cols=None):
                y = inner(x, rate, cols)
                if rate > 0 and rec["keep"] is None:
                    rec["keep"] = (y != 0) | (x == 0)
                return y

        return self._ps(ids, t, Keep())


def run(ctx: Context, control=None, fault=None) -> Outcome:
    """``control``: the reference in a lower precision stands in the
    program's place for the compared numbers; ``fault(model, state)``
    plants a fault in the program before its first step."""
    from layoutdm_tpu_torch.data.datasets import LayoutData
    from layoutdm_tpu_torch.data.loader import batch_iterator
    from layoutdm_tpu_torch.data.transforms import compose_transform
    from layoutdm_tpu_torch.train.step import init_train_state, make_optimizer, train_step

    dev, cfg, cell = ctx.device, ctx.cfg, ctx.cell
    B = cell["batch"]
    s_weights, s_pool, s_loader, s_gen = ctx.seeds(4)
    vocab = Vocab.of(cfg)
    params = denoiser.make_params(cfg, vocab.size, s_weights, dev)
    pc = program.train_config(cfg)
    model = program.build(cfg, params, dev)
    opt = make_optimizer(model.net, pc.optimizer.lr, pc.training.weight_decay,
                         tuple(pc.optimizer.betas))
    state = init_train_state(model, opt, pc.training.grad_norm_clip)
    pool = pool_layouts(np.random.default_rng(s_pool), cell["pool"], cfg["max_elements"],
                        cfg["num_categories"])
    data = LayoutData("perfbench", pool["bbox"], pool["label"], pool["mask"],
                      tuple(str(i) for i in range(cfg["num_categories"])))
    transform = compose_transform(list(pc.data.transforms))
    rng_np = np.random.RandomState(s_loader)
    gen = torch.Generator(device=dev).manual_seed(s_gen)

    def feed():
        while True:
            for batch in batch_iterator(data, B, rng_np, transform, drop_last=True):
                yield model.preprocess(batch, gen)

    tap = StepTap(model)
    if fault is not None:
        fault(model, state)
    batches = feed()
    staged = [next(batches) for _ in range(cell["staged"])]
    losses = []
    for k in range(CHECKED_STEPS):
        losses.append(train_step(state, staged[k], gen)["loss"])
        if k == 0:
            b1 = pc.optimizer.betas[0]
            first_grad = {n: opt.state[p]["exp_avg"] / (1 - b1) if p in opt.state else
                          torch.zeros_like(p) for n, p in model.net.named_parameters()}
    after = {n: p.detach().clone() for n, p in model.net.named_parameters()}
    tap.remove()
    losses = [float(v) for v in losses]
    sync(dev)
    setup_s = time.perf_counter() - ctx.started

    steps = CHECKED_STEPS
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        train_step(state, staged[steps % len(staged)], gen)
        steps += 1
    steps -= CHECKED_STEPS
    sync(dev)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = None
    if ctx.trace:
        trace = traced_steps(tempfile.mkdtemp(prefix="perfbench-trace-"),
                             lambda k: train_step(state, staged[k % len(staged)], gen),
                             TRACE_WARMUP, cell["trace_steps"])
        trace["steps"] = cell["trace_steps"]
    del model, state, opt, batches, staged
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    compared = judge(cfg, params, pool, tap, losses, first_grad, after, dev, control)
    left_out = compared.pop("leaves_left_out", None)
    print(f"train: leaves left out of the change (reference gradient under 1e-3 of the "
          f"median leaf's): {left_out}; losses {losses}", file=sys.stderr)
    rate = B * steps / window
    return Outcome(e2e={"train_samples_per_s": rate, "setup_s": setup_s},
                   attempted=B * steps, failed=0, memory_peak_bytes=peak, compared=compared,
                   counters={"train_samples_per_s": rate, "batch": B, "seq_len": vocab.seq_len,
                             "steps": steps, "leaves_left_out": left_out, "losses": losses},
                   trace=trace)


def _signature(label, bbox, mask) -> List[tuple]:
    return sorted((int(c), *np.round(b, 5).tolist()) for c, b, m in zip(label, bbox, mask) if m)


def judge(cfg, params, pool, tap: StepTap, losses, first_grad, after, dev, control=None) -> Dict:
    """The reference follows the recorded steps from the same weights;
    each step's loss, the first (clipped) gradient by leaf and the three
    steps' change by leaf are compared, and the stages the reference takes
    from the program are checked by themselves: each batch row is a pool
    layout, its elements reordered, no pool layout twice; every corrupted
    token is one the forward process can give at its timestep, and every
    row of the batch reached the denoiser."""
    from perfbench.reference.train import Trainer

    vocab = Vocab.of(cfg)
    out = {"steps_unrecorded": int(len(tap.batches) < CHECKED_STEPS
                                   or len(tap.inputs) != CHECKED_STEPS)}
    if out["steps_unrecorded"]:
        print(f"train: {CHECKED_STEPS} steps ran, the taps saw {len(tap.batches)} batches "
              f"and {len(tap.inputs)} calls of _predict_start; the step's calls changed and "
              f"the tap has to follow", file=sys.stderr)
        return dict(out, loss_rel_gap=float("inf"), grad_leaf_gap=float("inf"),
                    change_leaf_gap=float("inf"))
    sigs = {}
    for i in range(pool["mask"].shape[0]):
        sigs.setdefault(tuple(_signature(pool["label"][i], pool["bbox"][i], pool["mask"][i])),
                        []).append(i)
    used, unmatched = set(), 0
    for b in tap.batches[:CHECKED_STEPS]:
        for r in range(b["mask"].shape[0]):
            cands = [i for i in sigs.get(tuple(_signature(b["label"][r], b["bbox"][r],
                                                          b["mask"][r])), []) if i not in used]
            if cands:
                used.add(cands[0])
            else:
                unmatched += 1
    out["batch_rows_unmatched"] = unmatched

    from perfbench.lib.checks import reference_precision

    with reference_precision():
        ref = Trainer(cfg, params, dev)
        side = Trainer(cfg, params, dev, lowp=control) if control else None
        diff = diffusion.Diffusion(cfg, dev)
        impossible, unfed, ref_losses, side_losses = 0, 0, [], []
        for b, inp in zip(tap.batches[:CHECKED_STEPS], tap.inputs[:CHECKED_STEPS]):
            x0 = vocab.encode(*(torch.as_tensor(b[k], device=dev)
                                for k in ("label", "bbox", "mask")))
            xt, t = inp["xt"].long(), inp["t"].long()
            unfed += x0.shape[0] - xt.shape[0]  # rows of the batch the step left out
            x0 = x0[: xt.shape[0]]
            with torch.no_grad():
                lp = diff.forward_log_probs(x0, t).gather(-1, xt[..., None])[..., 0]
                impossible += int((lp < -50).sum()) + int(((t < 0) | (t >= diff.T)).sum())
            ref_losses.append(ref.step(x0, xt, t, inp["keep"]))
            if side is not None:
                side_losses.append(side.step(x0, xt, t, inp["keep"]))
    out["corruption_impossible"] = impossible
    out["rows_unfed"] = unfed
    if side is not None:  # the control: the lower-precision reference's numbers
        losses = side_losses
        first_grad = side.grads[0]
        after = {k: v.detach() for k, v in side.p.items()}
    out["loss_rel_gap"] = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g_ref = {k: v.norm().item() for k, v in ref.grads[0].items()}
    g_med = float(np.median(list(g_ref.values())))
    out["grad_leaf_gap"] = max(abs(first_grad[k].float().norm().item() - g_ref[k])
                               / max(g_ref[k], g_med) for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: (ref.p[k].detach() - params[k]).norm().item() for k in moved}
    d_med = float(np.median(list(d_ref.values())))
    out["change_leaf_gap"] = max(abs((after[k].float() - params[k]).norm().item() - d_ref[k])
                                 / max(d_ref[k], d_med) for k in moved)
    out["leaves_left_out"] = len(g_ref) - len(moved)
    return out


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def half_batch(model, state) -> None:
    """Fault: the loss over the first half of the batch alone."""
    loss = model.loss

    def half(tokens, *a, **k):
        return loss({key: v[: v.shape[0] // 2] for key, v in tokens.items()}, *a, **k)

    model.loss = half


def frozen_step(model, state) -> None:
    """Fault: a step that leaves the parameters as they were."""
    state.optimizer.step = lambda *a, **k: None


CONTROLS = {"fp8": "fp8"}
FAULTS = {"half_batch": half_batch, "frozen_step": frozen_step}
