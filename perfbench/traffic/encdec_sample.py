"""Batch conditional sampling through an encoder-decoder, as ``sample_cli``
runs the ``c`` task (categories given, sizes and positions generated):
``BART.sample`` with one ``torch.Generator`` on the card, the program's
cached decode (an encoder pass, then a token a step), chains of the
cell's ``batch`` rows back to back, every chain's layouts decoded and
copied to the host.

Conditions: ``conditions`` pools of ``batch`` layouts drawn from the seed
(`traffic.train.pool_layouts`: 1 to E elements, categories uniform), each
through the program's own ``tasks.get_cond(..., "c", model_type="bart")``
and ``to_sampler_cond``, staged on the card in set-up; the chains take
them in turn.  The window times ``model.sample`` alone.

Cell parameters: ``batch``, ``check_rows`` (rows of each chain the
reference follows, drawn from the seed), ``conditions``.  End to end:
``layouts_per_s`` (the layouts of every chain the window ran over the
whole window) and ``setup_s``.  With ``--trace 1`` one more chain runs
inside the profiler after the window, and another under the per-phase
stretch (`lib.phases`), whose spans the per-layer metrics read.

The comparison (`judge_chains`): a tap (`DecodeTap`) records, for the
checked rows, the logits each cached step returned, the generator's
state before the step's draw, and the tokens the chain returned.  The
plain reference (`reference/encdec.py`) runs one teacher-forced pass
over [BOS, the program's tokens] from its own encoding of the condition
and compares logits (``logit_gap_max``), replays each draw
(``token_gap_mean``), and checks exactly the forced tokens, the steps
and the decode."""

from __future__ import annotations

import dataclasses
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.lib import checks, encdec as program, phases
from perfbench.lib.harness import Context, Outcome
from perfbench.lib.stretch import Stretch
from perfbench.reference import encdec, noise
from perfbench.traffic.train import pool_layouts


def decode_steps() -> int:
    """The program's count of cached decode steps (`models.bart.DECODE_STEPS`)."""
    import layoutdm_tpu_torch.models.bart as bart

    return bart.DECODE_STEPS


class DecodeTap:
    """Wraps the model's ``sample_ids`` (once a chain: the rows to follow,
    the condition, the tokens returned) and its net's ``decode_step``
    (once a cached step: the step's logits of those rows, and the
    generator's state, which the step's draw starts from).  A chain whose
    calls it no longer sees (a decode captured in a CUDA graph, say)
    fails the comparison (``steps_missing``, ``chains_unchecked``): the
    tap has to follow such a change first."""

    def __init__(self, model, rows: Callable[[int], np.ndarray]):
        self.model = model
        self.rows = rows
        self.records: List[Dict] = []
        self.on = True
        self._cur: Optional[Dict] = None
        self._sample_ids = model.sample_ids
        self._step = model.net.decode_step
        model.sample_ids = self._sample
        model.net.decode_step = self._decode_step

    def remove(self) -> None:
        self.model.sample_ids = self._sample_ids
        self.model.net.decode_step = self._step

    def _sample(self, rng, batch_size, cond=None, *args, **kw):
        if not self.on:
            return self._sample_ids(rng, batch_size, cond, *args, **kw)
        if not isinstance(rng, torch.Generator):
            raise TypeError("the decode tap follows a chain drawn from one torch.Generator")
        picked = self.rows(batch_size)
        idx = torch.as_tensor(picked, device=self.model.device)
        cur = {"rows": [int(r) for r in picked], "batch": batch_size, "cond": cond,
               "logits": [], "states": [], "gen": rng, "idx": idx}
        self._cur = cur
        try:
            ids = self._sample_ids(rng, batch_size, cond, *args, **kw)
        finally:
            self._cur = None
        cur["final"] = ids.index_select(0, idx)
        del cur["gen"], cur["idx"]
        self.records.append(cur)
        return ids

    def _decode_step(self, tok, cache):
        cur = self._cur
        out = self._step(tok, cache)
        if cur is not None:
            cur["states"].append(cur["gen"].get_state())
            cur["logits"].append(out[:, 0].index_select(0, cur["idx"]))
        return out


def run(ctx: Context, control=None, fault=None) -> Outcome:
    """The comparison's controls (`CONTROLS`): a precision name (``"fp8"``)
    puts the reference computed in it in the program's place, its logits
    and its draws along each chain the program ran; ``control(model)``
    rounds the program's decode before set-up ends.  ``fault(model)``
    plants a fault underneath the tap."""
    from layoutdm_tpu_torch.tasks import get_cond, to_sampler_cond

    import layoutdm_tpu_torch.models.bart as bart

    if not hasattr(bart, "DECODE_STEPS"):
        raise RuntimeError("the program counts no cached decode steps "
                           "(models.bart.DECODE_STEPS), which the comparison reads")
    dev, cfg, cell = ctx.device, ctx.cfg, ctx.cell
    B, R = cell["batch"], cell["check_rows"]
    s_weights, s_pool, s_rows, s_warm, s_chain = ctx.seeds(5)
    vocab = encdec.Vocab.of(cfg)
    params = encdec.make_params(cfg, vocab.size, s_weights, dev)
    model = program.build(cfg, params, dev)
    sampling = program.train_config(cfg).sampling
    lowp = control if isinstance(control, str) else None
    if callable(control):
        control(model)
    if fault is not None:
        fault(model)
    rs_pool = np.random.default_rng(s_pool)
    pools = [pool_layouts(rs_pool, B, cfg["max_elements"], cfg["num_categories"])
             for _ in range(cell["conditions"])]
    conds = [to_sampler_cond(get_cond(p, model.tokenizer, "c", model_type="bart"),
                             model.tokenizer, sampling, device=dev) for p in pools]
    rs = np.random.default_rng(s_rows)
    tap = DecodeTap(model, rows=lambda b: np.sort(rs.choice(b, R, replace=False)))
    tap.on = False
    model.sample(torch.Generator(device=dev).manual_seed(s_warm), B, cond=conds[0],
                 sampling=sampling)
    sync(dev)
    setup_s = time.perf_counter() - ctx.started

    gen = torch.Generator(device=dev).manual_seed(s_chain)
    steps_before = decode_steps()
    tap.on = True
    hosts = []
    t0 = time.perf_counter()
    while True:
        out = model.sample(gen, B, cond=conds[len(hosts) % len(conds)], sampling=sampling)
        hosts.append({k: v.cpu() for k, v in out.items()})
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window = time.perf_counter() - t0
    tap.on = False
    chains = len(hosts)
    steps_counted = decode_steps() - steps_before
    answers = [{k: v[torch.as_tensor(rec["rows"])] for k, v in host.items()}
               for host, rec in zip(hosts, tap.records)]
    del hosts
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    trace = None
    if ctx.trace:
        stretch = Stretch(tempfile.mkdtemp(prefix="perfbench-trace-"))
        stretch.start()
        model.sample(gen, B, cond=conds[0], sampling=sampling)
        trace = stretch.stop()
        before = decode_steps()
        trace["phases"] = phases._profiled(
            lambda: model.sample(gen, B, cond=conds[0], sampling=sampling), dev)
        trace["phases"]["decode_steps"] = decode_steps() - before
        print(f"phases: {trace['phases']}", file=sys.stderr)
    tap.remove()
    records = tap.records
    for rec in records:
        rec["cond"] = next((i for i, c in enumerate(conds) if c is rec["cond"]), None)
    del model, tap, out, conds
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    L = vocab.gen_len
    compared = judge_chains(cfg, params, vocab, pools, records, answers, dev, lowp)
    compared["steps_missing"] += abs(steps_counted - L * chains)
    compared["chains_unchecked"] = chains - len(answers)
    counters = {"layouts_per_s": B * chains / window, "batch": B, "chains": len(records)}
    return Outcome(e2e={"layouts_per_s": B * chains / window, "setup_s": setup_s},
                   attempted=B * chains, failed=0, memory_peak_bytes=peak, compared=compared,
                   counters=counters, trace=trace)


def judge_chains(cfg: Dict, params: Dict, vocab: encdec.Vocab, pools: List[Dict],
                 records: List[Dict], answers: List[Dict], dev,
                 lowp: Optional[str] = None) -> Dict:
    """The reference follows each recorded chain's rows: its own encoding
    of their condition, one teacher-forced pass over [BOS, the tokens the
    program returned], each step's draw replayed from the generator's
    state.

    ``logit_gap_max``: the largest, over the decoded positions, of the RMS
    difference between the program's cached-decode logits and the
    reference's at that position (over every checked row and the
    vocabulary), over the reference's logit scale: the RMS of its logits
    about each token's mean over the checked rows and positions, the part
    the inputs move (the rest, an offset every position shares, is about
    four fifths of the logits' RMS at random weights and carries no
    error).  The program's error is alike at every position; rounding the
    caches adds most where the self cache holds few keys.
    ``token_gap_mean``: over every drawn (not forced) token, by how much
    its score (the reference's logits, illegal tokens at -inf, plus the
    replayed Gumbel noise) lies below the best score.  Exact:
    ``forced_mismatch`` (tokens the condition fixes that came back
    otherwise), ``steps_missing`` (steps the tap did not see),
    ``decode_mismatch`` (elements whose validity, category or box differ
    between the reference's decoding of the tokens and the program's
    answer).

    ``lowp`` (the control): the reference computed in that precision
    stands in for the program, teacher-forced along the same tokens: its
    logits in place of the recorded ones, and at each drawn position its
    own choice under the replayed noise in place of the program's."""
    L, V = vocab.gen_len, vocab.size
    legal = vocab.legal().to(dev)
    out = {"logit_gap_max": float("inf"), "token_gap_mean": float("inf"), "forced_mismatch": 0,
           "steps_missing": 0, "decode_mismatch": 0}
    gap, draws, rows_seen = 0.0, 0, 0
    d2 = torch.zeros(L, dtype=torch.float64, device=dev)  # squared differences by position
    r1 = torch.zeros(V, dtype=torch.float64, device=dev)  # the reference's sums by token
    r2 = torch.zeros(V, dtype=torch.float64, device=dev)
    with torch.no_grad(), checks.reference_precision():
        for rec, ans in zip(records, answers):
            if rec["cond"] is None or len(rec["logits"]) != L:
                out["steps_missing"] += abs(L - len(rec["logits"])) or L
                continue
            rows = torch.as_tensor(rec["rows"])
            pool = pools[rec["cond"]]
            label = torch.as_tensor(pool["label"])[rows].to(dev)
            mask = torch.as_tensor(pool["mask"])[rows].to(dev)
            enc_ids, forced, forced_ids = vocab.c_task(label, mask)
            tokens = rec["final"].long()
            bos = torch.full((len(rows), 1), vocab.bos, dtype=torch.long, device=dev)
            dec_ids = torch.cat([bos, tokens[:, :-1]], 1)
            ref = encdec.forward(params, cfg, enc_ids, dec_ids)
            got = (encdec.forward(params, cfg, enc_ids, dec_ids, lowp) if lowp
                   else torch.stack(rec["logits"], 1).float())
            d2 += (got - ref).double().pow(2).sum((0, 2))
            r1 += ref.double().sum((0, 1))
            r2 += ref.double().pow(2).sum((0, 1))
            rows_seen += len(rows)
            g = torch.stack([noise.generator_noise(s, (rec["batch"], V), dev)
                             .index_select(0, rows.to(dev)) for s in rec["states"]], 1)
            score = torch.where(legal[None], ref, -torch.inf) + g
            picked = tokens
            if lowp:
                own = (torch.where(legal[None], got, -torch.inf) + g).argmax(-1)
                picked = torch.where(forced, tokens, own)
            chosen = score.gather(-1, picked[..., None])[..., 0]
            free = ~forced
            gap += float((score.max(-1).values - chosen)[free].double().sum())
            draws += int(free.sum())
            out["forced_mismatch"] += int((tokens != forced_ids)[forced].sum())
            out["decode_mismatch"] += checks.decode_mismatch(vocab.decode(tokens), ans)
    if rows_seen:
        n = rows_seen * L
        scale = (r2 / n - (r1 / n) ** 2).mean().sqrt()
        out["logit_gap_max"] = float((d2 / (rows_seen * V)).sqrt().max() / scale)
    if draws:
        out["token_gap_mean"] = gap / draws
    return out


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _round_fp8_(t: torch.Tensor) -> None:
    t.copy_(t.to(torch.float8_e4m3fn).to(t.dtype))


def fp8_cache_control(model) -> None:
    """The program's decode with its self and cross key/value caches
    rounded to float8 e4m3 (unscaled: the keys and values are O(1)): the
    cross caches once projected, each self cache's filled prefix before
    every step.  It fails ``logit_gap_max`` and not ``token_gap_mean``;
    the reference in float8 (``"fp8"``) fails both."""
    net = model.net
    new_cache, step = net.new_cache, net.decode_step

    def rounded_cache(batch, memory):
        cache = new_cache(batch, memory)
        for t in cache.cross_keys + cache.cross_values:
            _round_fp8_(t)
        return cache

    def rounded_step(tok, cache):
        for t in cache.keys + cache.values:
            _round_fp8_(t[:, :cache.index])
        return step(tok, cache)

    net.new_cache, net.decode_step = rounded_cache, rounded_step


def cache_position_fault(model) -> None:
    """Every step writes and reads its cache one position on, and embeds
    its token there (the cache's position starts at 1, not 0)."""
    new_cache = model.net.new_cache

    def shifted(batch, memory):
        cache = new_cache(batch, memory)
        cache.index = 1
        return cache

    model.net.new_cache = shifted


def cross_row_fault(model) -> None:
    """Each row attends to the next row's cross keys and values."""
    new_cache = model.net.new_cache

    def rolled(batch, memory):
        cache = new_cache(batch, memory)
        cache.cross_keys = [k.roll(1, 0) for k in cache.cross_keys]
        cache.cross_values = [v.roll(1, 0) for v in cache.cross_values]
        return cache

    model.net.new_cache = rolled


def unforced_fault(model) -> None:
    """The first element's category is drawn, not forced as given."""
    sample_ids = model.sample_ids

    def unforced(rng, batch_size, cond=None, *args, **kw):
        strong = cond.strong_mask.clone()
        strong[:, 1] = False
        return sample_ids(rng, batch_size, dataclasses.replace(cond, strong_mask=strong),
                          *args, **kw)

    model.sample_ids = unforced


def noise_fault(model) -> None:
    """Each chain draws its tokens from a copy of its generator one draw
    on, so the noise drawn is not the noise the generator's state gives."""
    sample_ids = model.sample_ids

    def ahead(rng, batch_size, cond=None, *args, **kw):
        own = torch.Generator(device=rng.device)
        own.set_state(rng.get_state())
        torch.rand(1, generator=own, device=rng.device)
        return sample_ids(own, batch_size, cond, *args, **kw)

    model.sample_ids = ahead


CONTROLS = {"fp8": "fp8", "fp8_cache": fp8_cache_control}
FAULTS = {"cache_position": cache_position_fault, "cross_row": cross_row_fault,
          "unforced": unforced_fault, "noise": noise_fault}
