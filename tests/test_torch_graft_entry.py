"""The port's graft entry points (`layoutdm_tpu_torch.graft_entry`) on the
CPU, against the JAX package's `__graft_entry__.py`: the flagship
denoiser's forward on the JAX entry's weights; the dry run over four gloo
ranks (its data-parallel loss is the one-process step's, every rank
contributes to the chain and the features, the TP ranks hold half of
``linear1``, the summary line is printed); a deterministic chain and the
FIDNetV3 features split over four gloo ranks (`torch_graft_worker.run`)
against the JAX programs jitted with the same batch sharding over four of
the eight virtual CPU devices; and the refusals without a card."""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from layoutdm_tpu import tasks as jtasks
from layoutdm_tpu.configs import SamplingConfig
from layoutdm_tpu.eval import fidnet as jfid
from layoutdm_tpu.models.diffusion.sampler import sample_chain
from layoutdm_tpu_torch import graft_entry
from layoutdm_tpu_torch.eval import fidnet as tfid
from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond
from layoutdm_tpu_torch.train.step import init_train_state, make_optimizer, train_step
from layoutdm_tpu_torch.utils.params import params_from_flax
from torch_graft_worker import run
from torch_port_helpers import (
    BACKBONE,
    MAX_ELEMENTS,
    NUM_BINS,
    NUM_CATEGORIES,
    NUM_TIMESTEPS,
    layout_batch,
    layoutdm_pair,
)

LOGIT_TOL = 1e-4  # float32, 4 layers at d_model 464, summation order only
TOL = 1e-4  # tests/test_torch_fidnet.py
LOSS_TOL = dict(rtol=2e-5, atol=1e-5)  # tests/test_torch_parallel.py
WORLD = 4
B = 8  # two rows a rank
FID_LABELS = FID_MAX_BBOX = 25  # the dry run's FIDNetV3


@pytest.fixture(scope="module")
def dryrun():
    """`dryrun_multichip(4, "cpu")` once, with what its ranks print to fd 1."""
    with tempfile.TemporaryFile("w+") as log:
        saved = os.dup(1)
        os.dup2(log.fileno(), 1)
        try:
            out = graft_entry.dryrun_multichip(WORLD, device="cpu")
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        log.seek(0)
        return out, log.read()


def test_entry_logits_equal_the_jax_entry():
    """The flagship denoiser (vocab 155, 125 tokens, d_model 464, 4
    layers, float32) against the JAX entry's forward (`__graft_entry__.py:
    16-17`, ``model._apply_net`` of `bench.build_flagship`) on the same
    weights (initialised under jit: the entry's eager init takes ~10 s on
    the CPU) and the same zero inputs."""
    from bench import build_flagship

    jm = build_flagship()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    jseq, jt = np.zeros((2, jm.seq_len), np.int32), np.zeros((2,), np.int32)
    want = np.asarray(jax.jit(jm._apply_net)(params, jseq, jt))
    fn, (seq, t) = graft_entry.entry(
        device="cpu", state_dict=params_from_flax(jax.tree.map(np.asarray, params)))
    assert seq.shape == (2, 125) and seq.dtype == torch.int64 and t.shape == (2,)
    got = fn(seq, t)
    assert got.shape == want.shape == (2, 125, 155)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)


def test_dryrun_data_parallel_loss_is_the_one_process_loss(dryrun):
    out, _ = dryrun
    assert (out["backend"], out["world_size"], out["batch"]) == ("gloo", WORLD, 2 * WORLD)
    losses = out["losses"]
    np.testing.assert_allclose(losses["data_parallel"], losses["train_step"], **LOSS_TOL)
    assert all(np.isfinite(v) for v in losses.values())
    # the shard_map step draws each shard's own noise: a different loss
    assert losses["shard_map"] != losses["data_parallel"]


def test_dryrun_every_rank_contributes(dryrun):
    out, _ = dryrun
    assert out["chain_ranks"] == out["feature_ranks"] == list(range(WORLD))
    assert out["chain_equal_one_process"] is True
    assert out["feature_max_abs_err"] <= TOL


def test_dryrun_tp_ranks_hold_half_the_ffn(dryrun):
    out, _ = dryrun
    assert np.isfinite(out["losses"]["tensor_parallel"])
    assert out["tp_linear1_rows"] == [928, 1856]


def test_dryrun_prints_the_summary_line(dryrun):
    out, printed = dryrun
    assert out["summary"].startswith(f"dryrun_multichip({WORLD}) ok: flagship train loss=")
    assert f"sampler sharded over {WORLD} devices, eval features sharded over {WORLD}" \
        in out["summary"]
    assert "(tp x dp)" in out["summary"]
    assert out["summary"] in printed.splitlines()
    # the wrappers count launches only on the card
    assert out["launches"] == {"K1": 0, "K2": 0}


def _jax_sharded(fn, n_args):
    """``fn`` jitted with its first argument replicated and the rest split
    by rows over four of the virtual CPU devices, the output split alike."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    return jax.jit(fn, in_shardings=(repl,) + (data,) * n_args, out_shardings=data)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The JAX programs and the port's over four gloo ranks on the same
    weights and rows: a deterministic task-c chain of the tiny LayoutDM,
    and FIDNetV3 features of padded rows (one of them empty)."""
    d = tmp_path_factory.mktemp("graft")
    jm, params, tm = layoutdm_pair(seed=0)
    js = SamplingConfig(name="deterministic")
    jc = jtasks.to_sampler_cond(
        jtasks.get_cond(jax.random.PRNGKey(1), layout_batch(np.random.RandomState(5), B),
                        jm.tokenizer, "c"), jm.tokenizer, js)
    rs = np.random.RandomState(9)
    n = rs.randint(1, FID_MAX_BBOX + 1, (B, 1))
    n[-1] = 0
    fid_batch = {"bbox": rs.rand(B, FID_MAX_BBOX, 4).astype(np.float32),
                 "label": rs.randint(0, FID_LABELS, (B, FID_MAX_BBOX)).astype(np.int32),
                 "mask": np.arange(FID_MAX_BBOX)[None] < n}
    fidnet = jfid.FIDNetV3(num_labels=FID_LABELS, max_bbox=FID_MAX_BBOX)
    fid_vars = jax.jit(fidnet.init)(jax.random.PRNGKey(3), fid_batch["bbox"],
                                    fid_batch["label"], ~fid_batch["mask"])
    port_fid = tfid.FIDNetV3(FID_LABELS, max_bbox=FID_MAX_BBOX, device="cpu")
    port_fid.load_state_dict(tfid.fidnet_params_from_flax(
        jax.tree.map(np.asarray, fid_vars["params"])), strict=True)

    case = {"dir": str(d), "backbone": BACKBONE, "num_timesteps": NUM_TIMESTEPS,
            "num_bins": NUM_BINS, "num_categories": NUM_CATEGORIES,
            "max_elements": MAX_ELEMENTS, "state_dict": tm.net.state_dict(),
            "cond": {k: torch.as_tensor(np.array(getattr(jc, k))) for k in SamplerCond.TENSORS},
            "init_from_seq": jc.init_from_seq, "fid_labels": FID_LABELS,
            "fid_max_bbox": FID_MAX_BBOX, "fid_state_dict": port_fid.state_dict(),
            "fid_batch": fid_batch}
    torch.save(case, d / "case.pt")
    # the ranks run while the JAX programs compile and run here
    ranks = mp.spawn(run, args=(WORLD, str(d / "case.pt")), nprocs=WORLD, join=False)
    try:
        pad = jm.tokenizer.name_to_id("pad")
        chain = _jax_sharded(lambda p, c: sample_chain(
            p, jm._predict_start, jm.q, jax.random.PRNGKey(2), c, js, pad_id=pad), 1)
        extract = _jax_sharded(lambda p, b, l, m: fidnet.apply(
            {"params": p}, b, l, ~m, method=jfid.FIDNetV3.extract_features), 3)
        jx = {"ids": chain(params, jc),
              "features": extract(fid_vars["params"], fid_batch["bbox"], fid_batch["label"],
                                  fid_batch["mask"])}
    finally:
        while not ranks.join():
            pass
    return jx, torch.load(d / f"sharded{WORLD}.pt", weights_only=False)


def test_sharded_chain_equals_the_jax_sharded_chain(sharded):
    jx, port = sharded
    assert len(jx["ids"].sharding.device_set) == WORLD
    assert port["chain_ranks"] == list(range(WORLD))
    want = np.asarray(jx["ids"])
    assert len({tuple(r) for r in want}) > 1  # the rows differ, so their order shows
    np.testing.assert_array_equal(port["ids"].numpy(), want)


def test_sharded_features_equal_the_jax_sharded_features(sharded):
    jx, port = sharded
    assert len(jx["features"].sharding.device_set) == WORLD
    assert port["feature_ranks"] == list(range(WORLD))
    assert port["features"].shape == (B, 256)
    np.testing.assert_allclose(port["features"].numpy(), np.asarray(jx["features"]),
                               rtol=0, atol=TOL)


def test_no_card_no_run(monkeypatch):
    """The entry points run on the card unless asked for the CPU: without
    CUDA they raise, and NCCL takes one GPU a rank."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks need 2 GPUs, the host has 1"):
        graft_entry.dryrun_multichip(2)


def test_a_model_trains_after_it_sampled():
    """The dry run trains (the TP step) after its chain on one model: the
    converter's tables, first built under the chain's inference mode, are
    normal tensors that autograd may save."""
    _, _, tm = layoutdm_pair(seed=1)
    tm.sample_ids(torch.arange(2), 2, num_timesteps_eval=2)
    state = init_train_state(tm, make_optimizer(tm.net))
    seq = tm.tokenizer.encode(layout_batch(np.random.RandomState(3), 2))["seq"]
    assert np.isfinite(train_step(state, seq, torch.Generator().manual_seed(0))["loss"].item())
