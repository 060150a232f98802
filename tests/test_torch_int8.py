"""The port's int8 serving engine (`layoutdm_tpu_torch.models.int8_serving`)
held against the JAX package's on the same weights: the float32 and bf16
mirrors, the quantized weights and their scales, the int8 logits under
the JAX side's activation scales, the predict_start contract and the
gate.  Shapes are `tests/test_int8_serving.py`'s ``_small``; the flax
weights are carried across by `params_from_flax`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu.configs import BackboneConfig
from layoutdm_tpu.models import int8_serving as jint8
from layoutdm_tpu.models.nn import CategoricalTransformer
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.models import int8_serving as tint8
from layoutdm_tpu_torch.utils.params import params_from_flax
from torch_port_helpers import layoutdm_pair, port_layoutdm, tokenizers

BB = dict(d_model=64, nhead=4, dim_feedforward=128, num_layers=2, dropout=0.0,
          timestep_type="adalayernorm", diffusion_step=20)


def _small(seed=0):
    """The JAX test's net and inputs, and the port's view of them."""
    bb = BackboneConfig(**BB)
    V, S = 33, 15  # 3 elements x 5 attributes
    net = CategoricalTransformer(backbone=bb, num_classes=V, max_token_length=S,
                                 dtype=jnp.float32)
    seq = np.random.RandomState(seed).randint(0, V, (4, S)).astype(np.int32)
    t = np.asarray([0, 5, 11, 19], np.int32)
    params = jax.jit(net.init)(jax.random.PRNGKey(seed), jnp.asarray(seq), jnp.asarray(t))["params"]
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    port = dict(bb=tconfigs.BackboneConfig(**BB), sd=sd, seq=torch.as_tensor(seq).long(),
                t=torch.as_tensor(t).long())
    return bb, net, params, seq, t, V, port


@pytest.fixture(scope="module")
def small():
    return _small()


def test_f32_mirror_matches_jax_mirror_and_flax_apply(small):
    bb, net, params, seq, t, V, p = small
    want_apply = np.asarray(net.apply({"params": params}, seq, t, deterministic=True))
    want_mirror = np.asarray(jint8.mirror_forward(params, bb, V, seq, t, dtype=jnp.float32))
    got = tint8.mirror_forward(p["sd"], p["bb"], V, p["seq"], p["t"], dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want_mirror, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), want_apply, atol=2e-5, rtol=2e-5)


def test_bf16_mirror_within_the_jax_bound(small):
    bb, net, params, seq, t, V, p = small
    want = np.asarray(net.apply({"params": params}, seq, t, deterministic=True))
    got = tint8.mirror_forward(p["sd"], p["bb"], V, p["seq"], p["t"], dtype=torch.bfloat16)
    assert got.dtype == torch.float32  # the head stays float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.15, rtol=0.05)
    assert np.mean(got.numpy().argmax(-1) == want.argmax(-1)) > 0.98


def test_quantized_weights_equal_jax(small):
    bb, net, params, seq, t, V, p = small
    want = jint8.quantize_weights(params)
    got = tint8.quantize_weights(p["sd"])
    assert set(got) == set(want) == {f"layer{i}/{s}" for i in range(2)
                                      for s in tint8.GEMM_SITES}
    for k in want:
        w_q = np.asarray(want[k]["w_q"])
        assert got[k]["w_q"].dtype == torch.int8
        np.testing.assert_array_equal(got[k]["w_q"].numpy(), w_q.T)  # (out, in)
        np.testing.assert_allclose(got[k]["s_w"].numpy(), np.asarray(want[k]["s_w"]), rtol=1e-7)
        np.testing.assert_array_equal(got[k]["b"].numpy(), np.asarray(want[k]["b"]))


def test_int8_logits_equal_jax_under_its_scales(small):
    bb, net, params, seq, t, V, p = small
    scales = jint8.calibrate_scales(params, bb, V, seq, t)
    want = np.asarray(jint8.mirror_forward(
        params, bb, V, seq, t, wq=jint8.quantize_weights(params), act_scales=scales,
        dtype=jnp.float32))
    t_scales = {k: torch.as_tensor(np.array(v)) for k, v in scales.items()}
    got = tint8.mirror_forward(p["sd"], p["bb"], V, p["seq"], p["t"],
                               wq=tint8.quantize_weights(p["sd"]), act_scales=t_scales,
                               dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.999
    # the port's own calibration gives the JAX side's scales (bf16 observe pass)
    own = tint8.calibrate_scales(p["sd"], p["bb"], V, p["seq"], p["t"])
    assert set(own) == set(scales)
    for k in scales:
        np.testing.assert_allclose(own[k].item(), float(scales[k]), rtol=2e-2)
    # and the int8 logits stay near the float32 mirror (the JAX test's bounds)
    f32 = torch.softmax(tint8.mirror_forward(p["sd"], p["bb"], V, p["seq"], p["t"],
                                             dtype=torch.float32), -1)
    pq = torch.softmax(torch.as_tensor(got), -1)
    assert (f32 - pq).abs().sum(-1).mean().item() < 0.25


def test_predict_start_contract_and_refusals(monkeypatch):
    """The head contract (log-probs in [-70, 0], MASK lane at -70) of the
    int8 predict_start on a tiny LayoutDM, against the JAX one on the same
    weights; and the gate's and the causal net's refusals, as in JAX."""
    jm, params, tm = layoutdm_pair(seed=0, backbone=dict(num_layers=1))
    jps = jint8.make_int8_predict_start(jm, params, calib_batch=8)
    tps = tint8.make_int8_predict_start(tm, calib_batch=8,
                                        generator=torch.Generator().manual_seed(0))
    ids = np.random.RandomState(3).randint(0, tm.num_classes, (2, tm.seq_len))
    t = np.asarray([3, 7])
    got = tps(torch.as_tensor(ids), torch.as_tensor(t))
    # the float32 mirror of the port's denoiser is its forward
    with torch.no_grad():
        np.testing.assert_allclose(
            tint8.mirror_forward(tm.net.state_dict(), tm.backbone_cfg, tm.num_classes,
                                 torch.as_tensor(ids), torch.as_tensor(t),
                                 dtype=torch.float32).numpy(),
            tm.net(torch.as_tensor(ids), torch.as_tensor(t)).numpy(), atol=2e-5, rtol=2e-5)
    want = np.asarray(jax.jit(jps)(params, jnp.asarray(ids), jnp.asarray(t)))
    assert got.shape == want.shape == (2, tm.seq_len, tm.num_classes)
    assert got.max().item() <= 0.0 and got.min().item() >= -70.0
    np.testing.assert_array_equal(got[..., -1].numpy(), -70.0)
    # own calibration draws: the two agree to int8 resolution, not exactly
    assert np.mean(got.numpy().argmax(-1) == want.argmax(-1)) > 0.9

    bb = tconfigs.BackboneConfig(timestep_type="adalayernorm")
    monkeypatch.delenv("LAYOUTDM_TPU_INT8", raising=False)
    assert not tint8.can_use_int8(bb)
    monkeypatch.setenv("LAYOUTDM_TPU_INT8", "1")
    assert tint8.can_use_int8(bb)
    for cfg, kw in ((tconfigs.BackboneConfig(timestep_type=None), {}),
                    (tconfigs.BackboneConfig(timestep_type="adalayernorm_mlp"), {}),
                    (tconfigs.BackboneConfig(timestep_type="adalayernorm_abs"), {}),
                    (bb, {"pos_emb": "default"}), (bb, {"lookahead": False})):
        assert not tint8.can_use_int8(cfg, **kw)
        assert not jint8.can_use_int8(BackboneConfig(timestep_type=cfg.timestep_type), **kw)

    _, tt = tokenizers()
    causal = port_layoutdm(tt)
    causal.net.lookahead = False
    with pytest.raises(ValueError, match="causal"):
        tint8.make_int8_predict_start(causal)
