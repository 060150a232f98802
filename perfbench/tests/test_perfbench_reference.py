"""The plain reference agrees with the port at toy widths on the CPU, on
the same weights and inputs, so that it is held to what it stands in for.
(This test imports the port; the reference itself does not.)"""

import numpy as np
import pytest
import torch

from perfbench.lib import program, registry
from perfbench.reference import denoiser, diffusion, noise, tasks
from perfbench.reference.tokens import Vocab

TOY = {"d_model": 64, "nhead": 2, "dim_feedforward": 64, "num_layers": 2, "max_elements": 5,
       "num_timesteps": 10, "diffusion_step": 10, "dtype": "float32"}


@pytest.fixture(scope="module")
def toy():
    cfg = dict(registry.config("layoutdm-rico25"), **TOY)
    cfg["program_overrides"] = [
        "data.bbox_quantization=linear", "model.dtype=float32", "dataset.max_seq_length=5",
        "backbone.d_model=64", "backbone.nhead=2", "backbone.dim_feedforward=64",
        "backbone.num_layers=2", "model.num_timesteps=10", "backbone.diffusion_step=10"]
    vocab = Vocab.of(cfg)
    params = denoiser.make_params(cfg, vocab.size, 123, torch.device("cpu"))
    model = program.build(cfg, params, torch.device("cpu"))
    return cfg, vocab, params, model


def ids_at(vocab, B, seed):
    """Random ids each attribute can hold, MASK among them."""
    g = torch.Generator().manual_seed(seed)
    cols = []
    for a in range(5):
        lanes = torch.tensor(vocab.attr_tokens(a) + [vocab.mask])
        cols.append(lanes[torch.randint(0, len(lanes), (B, vocab.max_elements), generator=g)])
    return torch.stack(cols, -1).reshape(B, -1)


def test_logits_agree(toy):
    cfg, vocab, params, model = toy
    ids = ids_at(vocab, 6, 1)
    t = torch.tensor([0, 1, 3, 5, 8, 9])
    with torch.no_grad():
        got = model.net(ids, t)
        want = denoiser.forward(params, cfg, ids, t)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_posterior_agrees(toy):
    cfg, vocab, params, model = toy
    ids = ids_at(vocab, 6, 2)
    t = torch.tensor([0, 1, 3, 5, 8, 9])
    diff = diffusion.Diffusion(cfg, torch.device("cpu"))
    with torch.no_grad():
        lx0 = diffusion.predict_start(denoiser.forward(params, cfg, ids, t))
        got = model.q.q_posterior_ids(model._predict_start(ids, t), ids, t)
        want = diff.posterior(lx0, ids, t)
    assert torch.allclose(got, want, atol=1e-4)


def test_train_loss_agrees(toy):
    from layoutdm_tpu_torch.models.diffusion.loss import LtState, diffusion_loss
    from layoutdm_tpu_torch.models.nn import Dropout

    cfg, vocab, params, model = toy
    B = 8
    rs = np.random.default_rng(3)
    n = rs.integers(1, 6, B)
    mask = torch.as_tensor(np.arange(5)[None] < n[:, None])
    label = torch.as_tensor(rs.integers(0, 25, (B, 5)))
    bbox = torch.as_tensor(rs.random((B, 5, 4)), dtype=torch.float32)
    x0 = vocab.encode(label, bbox, mask)
    assert torch.equal(x0, model.preprocess({"label": label.numpy(), "bbox": bbox.numpy(),
                                             "mask": mask.numpy()})["seq"])
    t = torch.tensor([0, 1, 2, 3, 5, 7, 8, 9])
    xt = model.q.corrupt(x0, t, torch.Generator().manual_seed(4))
    keep = torch.rand((B, x0.shape[1], 58), generator=torch.Generator().manual_seed(5)) > 0.1
    pt = torch.full((B,), 0.1)
    losses, _ = diffusion_loss(model.q, model._predict_start, x0, LtState.init(10, "cpu"),
                               dropout=Dropout(masks=[keep]), t=t, pt=pt, xt=xt,
                               auxiliary_loss_weight=0.1)
    lx0 = diffusion.predict_start(denoiser.forward(params, cfg, xt, t, emb_keep=keep))
    diff = diffusion.Diffusion(cfg, torch.device("cpu"))
    want, _ = diffusion.loss(diff, lx0, x0, xt, t, pt, 0.1)
    assert abs(float(sum(losses.values()).detach()) - float(want)) < 1e-4 * abs(float(want))
    lp = diff.forward_log_probs(x0, t).gather(-1, xt[..., None])
    assert (lp > -50).all()


def test_noise_agrees():
    from layoutdm_tpu_torch.ops.samplers import gumbel_noise

    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    assert torch.equal(noise.generator_noise(state, (3, 10, 155), "cpu"),
                       gumbel_noise(g, (1, 3, 10, 155))[0])


def test_unconditional_start_agrees(toy):
    from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond

    cfg, vocab, params, model = toy
    B = 4
    c = tasks.unconditional(vocab, B)
    sc = SamplerCond.empty(B, vocab.seq_len, "cpu")
    assert torch.equal(c.start, torch.full((B, vocab.seq_len), vocab.mask))
    assert torch.equal(c.held, sc.strong_mask)
    assert torch.equal(c.no_pad, sc.pad_suppress)
    assert c.prior is None and not sc.weak_mask.any()


def test_decode_agrees(toy):
    cfg, vocab, params, model = toy
    ids = ids_at(vocab, 16, 6)
    got, want = model.tokenizer.decode(ids), vocab.decode(ids)
    assert torch.equal(got["mask"], want["mask"]) and torch.equal(got["label"], want["label"])
    assert torch.allclose(got["bbox"], want["bbox"], atol=1e-6)
