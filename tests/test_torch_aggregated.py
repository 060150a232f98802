"""The port's aggregated LayoutDM denoiser, AdaInsNorm, `LayoutDictTokenizer`
and `ElementTransformer` held against the JAX package on the same weights:
logits, the constrained chain token-identical under deterministic
sampling, the norm's output, the dict tokenizer's encode and decode, and
AdamW's decay groups."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu import tasks as jtasks
from layoutdm_tpu.configs import BackboneConfig, ModelConfig, SamplingConfig
from layoutdm_tpu.models.layoutdm import LayoutDM as JaxLayoutDM
from layoutdm_tpu.models.nn import AdaInsNorm as JaxAdaInsNorm
from layoutdm_tpu.models.nn import ElementTransformer as JaxElementTransformer
from layoutdm_tpu.tokenizer.bbox import BboxTokenizer as JaxBbox
from layoutdm_tpu.tokenizer.sequence import LayoutDictTokenizer as JaxDictTok
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.configs import SamplingConfig as TSampling
from layoutdm_tpu_torch.factory import build_model
from layoutdm_tpu_torch.models.layoutdm import LayoutDM
from layoutdm_tpu_torch.models.nn import AdaInsNorm, ElementTransformer, make_module
from layoutdm_tpu_torch.tokenizer.bbox import BboxTokenizer
from layoutdm_tpu_torch.tokenizer.sequence import LayoutDictTokenizer
from layoutdm_tpu_torch.train.step import decayed_parameter_names
from layoutdm_tpu_torch.utils.params import params_from_flax
from torch_port_helpers import (
    BACKBONE,
    cond_to_port,
    jax_decayed_names,
    layout_batch,
    tokenizers,
)

LOGIT_TOL = 1e-5  # float32, same weights
NORM_TOL = 1e-6
T = 10


def _pair(seed, transformer_type="flattened", **backbone):
    """(jax LayoutDM, params, port LayoutDM); d_model 128 shrinks 29/32 to
    116 and, aggregated, 27/29 to 108 = 2 heads of 54 (the aggregated
    model's head width at full size)."""
    bb = dict(BACKBONE, **backbone)
    jt, tt = tokenizers()
    jm = JaxLayoutDM(BackboneConfig(**bb), jt,
                     ModelConfig(num_timesteps=T, transformer_type=transformer_type))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = LayoutDM(tconfigs.BackboneConfig(**bb), tt,
                  tconfigs.ModelConfig(num_timesteps=T, transformer_type=transformer_type),
                  device="cpu")
    tm.net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def aggregated():
    return _pair(0, "aggregated")


def test_aggregated_shapes_follow_the_reference():
    cfg = tconfigs.build_train_config("layoutdm", "rico25", [
        "data.bbox_quantization=linear", "model.transformer_type=aggregated"])
    tm = build_model(cfg, device="cpu")
    bb = tm.backbone_cfg
    assert (bb.d_model, bb.nhead, bb.dim_feedforward) == (432, 8, 1728)
    assert tm.net.pos.pos_emb.shape == (125, 432) and tm.net.enc.in_features == 5 * 432


def test_aggregated_logits_and_decay_groups_match_jax(aggregated):
    jm, params, tm = aggregated
    assert tm.backbone_cfg.d_model // tm.backbone_cfg.nhead == 54
    rs = np.random.RandomState(1)
    ids = rs.randint(0, tm.num_classes, (3, tm.seq_len))
    t = np.array([0, 4, 9])
    want = np.asarray(jm.net.apply({"params": params}, jnp.asarray(ids), jnp.asarray(t)))
    with torch.no_grad():
        got = tm.net(torch.as_tensor(ids), torch.as_tensor(t)).numpy()
    assert got.shape == (3, tm.seq_len, tm.num_classes)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    assert set(decayed_parameter_names(tm.net)) == jax_decayed_names(params)


@pytest.mark.parametrize("task", ["unconditional", "c"])
def test_aggregated_deterministic_chain_token_identical(aggregated, task):
    jm, params, tm = aggregated
    B = 4
    js = SamplingConfig(name="deterministic")
    if task == "unconditional":
        jc = jtasks.to_sampler_cond(None, jm.tokenizer, js, batch_size=B)
    else:
        batch = layout_batch(np.random.RandomState(5), B)
        jc = jtasks.to_sampler_cond(
            jtasks.get_cond(jax.random.PRNGKey(1), batch, jm.tokenizer, task), jm.tokenizer, js)
    want = np.asarray(jm.sample_ids(params, jax.random.PRNGKey(0), B, cond=jc, sampling=js))
    got = tm.sample_ids(torch.arange(B), B, cond=cond_to_port(jc),
                        sampling=TSampling(name="deterministic"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_adainsnorm_matches_jax():
    """The norm alone (statistics over the sequence, population variance,
    eps 1e-5), then a LayoutDM built with it."""
    rs = np.random.RandomState(2)
    x = (3.0 * rs.randn(2, 7, 16) + 1.0).astype(np.float32)
    t = np.array([3, 8])
    jn = JaxAdaInsNorm(16, T, "adainnorm")
    params = jn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    want = np.asarray(jn.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.device("meta"):
        norm = AdaInsNorm(16, T, "adainnorm")
    norm = norm.to_empty(device="cpu")
    norm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = norm(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, atol=NORM_TOL, rtol=0)

    jm, params, tm = _pair(3, timestep_type="adainnorm")
    assert isinstance(tm.net.backbone.layers[0].norm1, AdaInsNorm)
    ids = rs.randint(0, tm.num_classes, (2, tm.seq_len))
    want = np.asarray(jm.net.apply({"params": params}, jnp.asarray(ids), jnp.asarray(t)))
    with torch.no_grad():
        got = tm.net(torch.as_tensor(ids), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("special", [("pad", "bos", "eos", "mask"), ("pad", "mask")])
def test_layout_dict_tokenizer_matches_jax(special):
    kw = dict(num_categories=4, max_elements=6, special_tokens=special, pad_until_max=True)
    jt = JaxDictTok(bbox_tokenizer=JaxBbox(num_bins=8, shared_vocab="xywh"), **kw)
    tt = LayoutDictTokenizer(bbox_tokenizer=BboxTokenizer(num_bins=8, shared_vocab="xywh"), **kw)
    batch = layout_batch(np.random.RandomState(4), 5, 5, 4)  # padded to 6 elements
    want = jt.encode(batch)
    got = tt.encode(batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    want = jt.decode({k: np.asarray(v) for k, v in want.items()})
    got = tt.decode(got)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        LayoutDictTokenizer(bbox_tokenizer=BboxTokenizer(num_bins=8, shared_vocab="x-y-w-h"),
                            **kw)


@pytest.mark.parametrize("lookahead", [False, True])
def test_element_transformer_matches_jax(lookahead):
    bb = dict(d_model=32, nhead=2, dim_feedforward=32, num_layers=2, dropout=0.0)
    rs = np.random.RandomState(6)
    label = rs.randint(0, 5, (2, 6))
    bbox = rs.randint(0, 8, (2, 6, 4))
    pad = np.arange(6)[None] >= np.array([[6], [3]])
    jnet = JaxElementTransformer(BackboneConfig(**bb), num_labels=5, num_bins=8,
                                 lookahead=lookahead)
    params = jnet.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(label), jnp.asarray(bbox))
    params = params["params"]
    want = jnet.apply({"params": params}, jnp.asarray(label), jnp.asarray(bbox),
                      jnp.asarray(pad))
    tnet = make_module(ElementTransformer, "cpu", backbone=tconfigs.BackboneConfig(**bb),
                       num_labels=5, num_bins=8, lookahead=lookahead)
    tnet.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tnet(torch.as_tensor(label), torch.as_tensor(bbox), torch.as_tensor(pad))
    for k in ("label", "bbox"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=LOGIT_TOL, rtol=0)
