"""The port's BART (through ``factory.build_model``) held to the benchmark's
plain float32 reference (`perfbench/reference/encdec.py`) on seeded random
weights at a small size on the CPU: the teacher-forced logits, the cached
decode's logits at every step against the reference's full forward pass,
the ``c`` task's constrained decode under injected Gumbel draws (tokens
and forced tokens exact), and the reference's vocabulary against the
port's tokenizer and task builder."""

import numpy as np
import pytest
import torch

from layoutdm_tpu_torch.configs import SamplingConfig, build_train_config
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.models.base import Draws
from layoutdm_tpu_torch.tasks import get_cond, to_sampler_cond
from perfbench.reference import encdec

LOGIT_TOL = 1e-5
# d_model 64 shrinks 21/32 to 42 = 3 heads of 14, FFN 128 -> 84, 2 + 2
# layers; the synthetic dataset's 5 categories, 6 elements (31 positions)
WIDTHS = {"d_model": 64, "nhead": 3, "dim_feedforward": 128, "num_layers": 2}
E, C = 6, 5
CFG = dict(WIDTHS, num_categories=C, max_elements=E, num_bins=32, shared_bbox_vocab="xywh",
           var_order="c-w-h-x-y", special_tokens=["pad", "bos", "eos", "mask"],
           bbox_quantization="linear", width_shrink=[21, 32])
VOCAB = encdec.Vocab.of(CFG)
B = 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the ops here are small, and on a shared host
    the thread pool's spinning made them several times slower."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def pair():
    """(the port's BART on the CPU in float32 with the reference's weights,
    the weights)."""
    cfg = build_train_config("bart", "synthetic", [
        "data.bbox_quantization=linear", f"dataset.max_seq_length={E}",
        *(f"backbone.{k}={v}" for k, v in WIDTHS.items())])
    model = build_model(cfg, device="cpu")
    params = encdec.make_params(CFG, VOCAB.size, 11, torch.device("cpu"))
    model.net.load_state_dict(params, strict=True)
    return model, params


def layouts(seed):
    rs = np.random.RandomState(seed)
    n = rs.randint(1, E + 1, (B, 1))
    return {"label": rs.randint(0, C, (B, E)).astype(np.int32),
            "bbox": rs.rand(B, E, 4).astype(np.float32), "mask": np.arange(E)[None] < n}


def c_condition(model, batch):
    """The port's ``c`` condition, as ``sample_cli`` builds it."""
    return to_sampler_cond(get_cond(batch, model.tokenizer, "c", model_type="bart"),
                           model.tokenizer, SamplingConfig())


@pytest.mark.parametrize("seed", [0, 1])
def test_teacher_forced_logits_match_the_reference(pair, seed):
    model, params = pair
    rs = np.random.RandomState(seed)
    enc = torch.as_tensor(rs.randint(0, VOCAB.size, (B, VOCAB.seq_len)))
    dec = torch.as_tensor(rs.randint(0, VOCAB.size, (B, VOCAB.seq_len)))
    with torch.no_grad():
        got = model.net(enc, dec)
        want = encdec.forward(params, CFG, enc, dec)
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)


def test_cached_decode_logits_match_the_reference_at_every_step(pair):
    """Prefill (the encoder, the cross keys and values) and a token a step
    through the caches against the reference's full forward pass over the
    same tokens."""
    model, params = pair
    batch = layouts(2)
    enc, _, _ = VOCAB.c_task(torch.as_tensor(batch["label"]), torch.as_tensor(batch["mask"]))
    dec = torch.as_tensor(np.random.RandomState(3).randint(0, VOCAB.size, (B, VOCAB.seq_len)))
    dec[:, 0] = VOCAB.bos
    with torch.no_grad():
        cache = model.net.new_cache(B, model.net(enc, None))
        got = torch.cat([model.net.decode_step(dec[:, i:i + 1], cache)
                         for i in range(VOCAB.seq_len)], 1)
        want = encdec.forward(params, CFG, enc, dec)
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)


def reference_decode(params, batch, gumbel):
    """The ``c`` task decoded by the reference, a full forward pass a step:
    the legal tokens' logits plus the step's noise, argmax, the condition's
    tokens forced."""
    enc, forced, forced_ids = VOCAB.c_task(torch.as_tensor(batch["label"]),
                                           torch.as_tensor(batch["mask"]))
    legal = VOCAB.legal()
    seq = torch.full((B, 1), VOCAB.bos)
    for i in range(VOCAB.gen_len):
        logits = encdec.forward(params, CFG, enc, seq)[:, -1]
        pred = torch.where(legal[i], logits, -torch.inf).add(gumbel[i]).argmax(-1)
        pred = torch.where(forced[:, i], forced_ids[:, i], pred)
        seq = torch.cat([seq, pred[:, None]], 1)
    return seq[:, 1:], forced, forced_ids


@pytest.mark.parametrize("seed", [4, 5])
def test_c_task_decode_under_injected_draws_matches_the_reference(pair, seed):
    model, params = pair
    batch = layouts(seed)
    g = torch.Generator().manual_seed(seed)
    gumbel = -torch.log(-torch.log(torch.rand((VOCAB.gen_len, B, VOCAB.size), generator=g)))
    with torch.no_grad():
        got = model.sample_ids(Draws(injected={"tokens": list(gumbel[:, None])}), B,
                               cond=c_condition(model, batch), sampling=SamplingConfig())
        want, forced, forced_ids = reference_decode(params, batch, gumbel)
    assert torch.equal(got, want)
    assert torch.equal(got[forced], forced_ids[forced])


@pytest.mark.parametrize("part", ["encode", "c_task", "legal", "decode"])
def test_the_reference_vocabulary_is_the_port_s(pair, part):
    model, _ = pair
    tok = model.tokenizer
    batch = layouts(6)
    label, mask = torch.as_tensor(batch["label"]), torch.as_tensor(batch["mask"])
    assert VOCAB.size == tok.N_total and VOCAB.seq_len == tok.max_token_length
    if part == "encode":
        assert torch.equal(VOCAB.encode(label, torch.as_tensor(batch["bbox"]), mask),
                           tok.encode(batch)["seq"])
    elif part == "c_task":
        enc, forced, forced_ids = VOCAB.c_task(label, mask)
        cond = c_condition(model, batch)
        assert torch.equal(enc, cond.seq)
        assert torch.equal(forced, cond.strong_mask[:, 1:])
        assert torch.equal(forced_ids[forced], cond.seq[:, 1:][forced])
    elif part == "legal":
        assert torch.equal(VOCAB.legal(), torch.as_tensor(tok.token_mask()))
    else:
        ids = torch.as_tensor(np.random.RandomState(7).randint(0, VOCAB.size,
                                                               (64, VOCAB.gen_len)))
        ids[:32] = tok.encode(batch)["seq"][:, 1:].repeat(6, 1)[:32]  # well-formed rows too
        want, got = tok.decode(ids), VOCAB.decode(ids)
        assert torch.equal(got["mask"], want["mask"])
        assert torch.equal(got["label"], want["label"])
        torch.testing.assert_close(got["bbox"], want["bbox"], rtol=0, atol=1e-6)
