"""The port's CategoricalTransformer on flax weights (``params_from_flax``)
held against the flax denoiser: float32 logits within 1e-4, including the
flagship head width hd = 58 (d = 116, 2 heads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu.configs import BackboneConfig
from layoutdm_tpu.models.nn import CategoricalTransformer as JaxTransformer
from layoutdm_tpu_torch.configs import BackboneConfig as TBackboneConfig
from layoutdm_tpu_torch.models.nn import make_transformer
from layoutdm_tpu_torch.utils.params import params_from_flax

LOGIT_TOL = 1e-4

CASES = [
    # the flagship's head width: d=116 = 2 heads of 58, AdaLayerNorm, elem_attr
    dict(bb=dict(d_model=116, nhead=2, dim_feedforward=64, num_layers=2,
                 timestep_type="adalayernorm"), pos_emb="elem_attr", S=25),
    # sinusoidal timestep encoding, learned absolute positions, gelu; with
    # 4000 steps the angles stay small (at 10 steps they reach ~3600 rad,
    # where one float32 ulp of the frequency moves sin() by ~3e-4)
    dict(bb=dict(d_model=64, nhead=4, dim_feedforward=96, num_layers=2,
                 timestep_type="adalayernorm_abs", activation="gelu",
                 diffusion_step=4000),
         pos_emb="default", S=20),
    # MLP timestep encoding, gelu2
    dict(bb=dict(d_model=32, nhead=2, dim_feedforward=48, num_layers=1,
                 timestep_type="adalayernorm_mlp", activation="gelu2"),
         pos_emb="elem_attr", S=15),
    # plain LayerNorm, no timestep conditioning
    dict(bb=dict(d_model=32, nhead=2, dim_feedforward=48, num_layers=2,
                 timestep_type=None), pos_emb="elem_attr", S=10),
]


def _pair(case, V=30, dtype=torch.float32):
    bb = dict(dict(dropout=0.0, diffusion_step=10), **case["bb"])
    S = case["S"]
    jnet = JaxTransformer(backbone=BackboneConfig(**bb), num_classes=V,
                          max_token_length=S, pos_emb=case["pos_emb"])
    params = jax.jit(jnet.init)({"params": jax.random.PRNGKey(0)},
                                jnp.zeros((1, S), jnp.int32),
                                jnp.zeros((1,), jnp.int32))["params"]
    # flax zero-inits biases and ones-inits norm scales: randomise them so
    # every tensor's mapping is exercised
    rs = np.random.RandomState(1)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rs.randn(*np.shape(p)).astype(np.float32),
        params,
    )
    tnet = make_transformer("cpu", backbone=TBackboneConfig(**bb), num_classes=V,
                            max_token_length=S, pos_emb=case["pos_emb"], dtype=dtype)
    tnet.load_state_dict(params_from_flax(params), strict=True)
    return jnet, params, tnet


@pytest.mark.parametrize("case", CASES, ids=["hd58", "abs_default_pos", "mlp", "plain_ln"])
def test_logits_match_flax_f32(case):
    jnet, params, tnet = _pair(case)
    rs = np.random.RandomState(2)
    B, S = 3, case["S"]
    ids = rs.randint(0, 30, (B, S))
    t = rs.randint(0, 10, (B,))
    want = np.asarray(
        jax.jit(jnet.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(t))
    )
    with torch.no_grad():
        got = tnet(torch.as_tensor(ids), torch.as_tensor(t))
    assert got.dtype == torch.float32 and got.shape == (B, S, 30)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL)


def test_bf16_compute_dtype_tracks_flax():
    """bf16 activations with f32 norms and head: the port's bf16 logits are
    as close to the float32 logits as the flax module's bf16 logits are
    (the two frameworks round GEMM outputs at slightly different points,
    so bitwise equality is not expected)."""
    case = CASES[0]
    jnet, params, _ = _pair(case)
    _, _, tnet = _pair(case, dtype=torch.bfloat16)
    rs = np.random.RandomState(3)
    ids, t = jnp.asarray(rs.randint(0, 30, (2, 25))), jnp.asarray(rs.randint(0, 10, (2,)))
    want32 = np.asarray(jax.jit(jnet.apply)({"params": params}, ids, t))
    jax16 = np.asarray(
        jax.jit(jnet.clone(dtype=jnp.bfloat16).apply)({"params": params}, ids, t)
    )
    with torch.no_grad():
        got = tnet(torch.as_tensor(np.asarray(ids)), torch.as_tensor(np.asarray(t)))
    assert got.dtype == torch.float32
    port_err = np.abs(got.numpy() - want32)
    jax_err = np.abs(jax16 - want32)
    assert port_err.max() < 0.1
    assert port_err.mean() <= 1.25 * jax_err.mean()


def test_params_from_flax_maps_every_leaf():
    _, params, tnet = _pair(CASES[0])
    sd = params_from_flax(params)
    assert set(sd) == set(tnet.state_dict())
    assert sd["backbone.layers.1.attn.qkv.weight"].shape == (3 * 116, 116)
    np.testing.assert_array_equal(
        sd["backbone.layers.0.attn.qkv.weight"].numpy(),
        np.asarray(params["backbone"]["layer0"]["attn"]["qkv"]["kernel"]).T,
    )
    np.testing.assert_array_equal(
        sd["backbone.layers.0.norm1.cond.emb.weight"].numpy(),
        np.asarray(params["backbone"]["layer0"]["norm1"]["AdaNormCond_0"]["emb"]["embedding"]),
    )


def test_init_params_is_seeded_and_leaves_global_rng_alone():
    kw = dict(backbone=TBackboneConfig(d_model=32, nhead=2, dim_feedforward=16,
                                      num_layers=1, timestep_type="adalayernorm",
                                      diffusion_step=5),
              num_classes=12, max_token_length=10)
    a = make_transformer("cpu", torch.Generator().manual_seed(7), **kw)
    b = make_transformer("cpu", torch.Generator().manual_seed(7), **kw)
    c = make_transformer("cpu", torch.Generator().manual_seed(8), **kw)
    state = torch.random.get_rng_state()
    make_transformer("cpu", **kw)
    assert torch.equal(state, torch.random.get_rng_state())  # global RNG untouched
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
        assert torch.isfinite(v).all()
    assert not torch.equal(a.cat_emb.weight, c.cat_emb.weight)
