"""The port's FIDNet (``layoutdm_tpu_torch/eval/fidnet.py``) and its trainer
step against the JAX package's flax FIDNet, at full width (d_model 256, 4
heads, 4 + 4 layers, max_bbox 25) on padded rows, on weights carried over
by ``fidnet_params_from_flax`` or read from the same checkpoint file."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from layoutdm_tpu.eval import fidnet as jfid
from layoutdm_tpu.eval.fidnet_train import fid_transform as jax_fid_transform
from layoutdm_tpu.eval.fidnet_train import make_fid_train_step
from layoutdm_tpu_torch.eval import fidnet as tfid
from layoutdm_tpu_torch.eval.fidnet_train import fid_transform, train_step
from layoutdm_tpu_torch.utils.flax_msgpack import read_flax_msgpack

TOL = 1e-4  # float32, 4 + 4 post-norm layers, summation order only
ADAM_TOL = 1e-5
L, S, B = 7, 25, 6
V2_LAYERS = 2  # of its 8 + 8 (the width is V2's own, 256)


def _batch(seed=0, B=B):
    """Padded rows, one of them with no element (decoder keys all masked)."""
    rs = np.random.RandomState(seed)
    n = rs.randint(1, S + 1, (B, 1))
    n[-1] = 0
    return (rs.rand(B, S, 4).astype(np.float32),
            rs.randint(0, L, (B, S)).astype(np.int32),
            np.arange(S)[None] < n)


@functools.lru_cache(maxsize=None)
def _flax(version=3):
    """(flax model, its variables as numpy, jitted (variables, bbox, label,
    mask) -> features) at the JAX package's defaults, initialised once."""
    bbox, label, mask = _batch()
    model = {1: jfid.FIDNetV1(num_labels=L), 3: jfid.FIDNetV3(num_labels=L, max_bbox=S),
             2: jfid.FIDNetV2(num_labels=L, max_bbox=S, num_layers=V2_LAYERS)}[version]
    variables = jax.jit(model.init)(jax.random.PRNGKey(version), bbox, label, ~mask)
    features = jax.jit(lambda v, b, l, m: model.apply(
        v, b, l, ~m, method=type(model).extract_features))
    return model, jax.tree.map(np.asarray, dict(variables)), features


def _port(version, variables):
    """The port's model of that version on the same weights, on the CPU."""
    cls = {1: tfid.FIDNetV1, 2: tfid.FIDNetV2, 3: tfid.FIDNetV3}[version]
    kw = {1: {}, 2: {"max_bbox": S, "num_layers": V2_LAYERS}, 3: {"max_bbox": S}}[version]
    tm = cls(L, device="cpu", **kw)
    tm.load_state_dict(tfid.fidnet_params_from_flax(
        variables["params"], variables.get("batch_stats")), strict=True)
    return tm.eval()


def _heads(tm, bbox, label, mask):
    with torch.no_grad():
        out = tm(torch.as_tensor(bbox), torch.as_tensor(label).long(), torch.as_tensor(~mask))
    return out if isinstance(out, tuple) else (out,)


def test_v3_features_and_training_heads_match_flax():
    model, variables, features = _flax(3)
    tm = _port(3, variables)
    bbox, label, mask = _batch(1)
    want = np.asarray(features(variables, bbox, label, mask))
    got = tfid.make_feature_extractor(tm)(bbox, label, mask)
    assert got.dtype == torch.float32 and got.shape == (B, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    wants = jax.jit(model.apply)(variables, bbox, label, ~mask)
    for w, g in zip(wants, _heads(tm, bbox, label, mask)):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


@pytest.mark.parametrize("version", [1, 2])
def test_v1_and_v2_match_flax(version):
    """The legacy extractors (V2's batch norm in eval mode, on running
    statistics moved off their init values; V2 at 2 + 2 layers)."""
    model, variables, features = _flax(version)
    rs = np.random.RandomState(3)
    if version == 2:
        variables = dict(variables, batch_stats=jax.tree.map(
            lambda a: (a + rs.rand(*a.shape)).astype(np.float32), variables["batch_stats"]))
    tm = _port(version, variables)
    bbox, label, mask = _batch(2)
    wants = jax.jit(model.apply)(variables, bbox, label, ~mask)
    wants = wants if isinstance(wants, tuple) else (wants,)
    for w, g in zip(wants, _heads(tm, bbox, label, mask)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    np.testing.assert_allclose(tfid.make_feature_extractor(tm)(bbox, label, mask).numpy(),
                               np.asarray(features(variables, bbox, label, mask)), atol=TOL)


def test_a_reference_layout_checkpoint_loads_in_both_packages(tmp_path):
    """A ``model_best.pth.tar`` under the reference's names (the port's
    state dict, token masks included) gives the same features through the
    JAX package's ``load_torch_fidnet`` and the port's loader, and a file
    without the constant token mask loads too."""
    torch.manual_seed(0)
    src = tfid.FIDNetV3(L, max_bbox=S, device="cpu")
    sd = src.state_dict()
    assert "enc_transformer.core.layers.3.self_attn.in_proj_weight" in sd
    assert sd["enc_transformer.token"].shape == (1, 1, 256)
    assert sd["pos_token"].shape == (S, 1, 256)
    path = tmp_path / "model_best.pth.tar"
    torch.save({"state_dict": sd}, path)
    _, jp = jfid.load_torch_fidnet(str(path), L, max_bbox=S)
    tm = tfid.load_torch_fidnet(str(path), L, max_bbox=S, device="cpu")
    bbox, label, mask = _batch(4)
    want = np.asarray(_flax(3)[2]({"params": jp}, bbox, label, mask))
    np.testing.assert_allclose(tfid.make_feature_extractor(tm)(bbox, label, mask).numpy(),
                               want, atol=TOL)
    del sd["enc_transformer.token_mask"]
    torch.save(sd, path)  # a bare state dict, as torch.save(model.state_dict())
    tm2 = tfid.load_torch_fidnet(str(path), L, max_bbox=S, device="cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(v, tm2.state_dict()[k]), k


def test_flax_msgpack_is_read_bit_equal_and_loads(tmp_path):
    model, variables, features = _flax(3)
    params = variables["params"]
    d = tmp_path / "synthetic-max25"
    d.mkdir()
    (d / "model_best.msgpack").write_bytes(serialization.to_bytes(params))
    got = read_flax_msgpack(str(d / "model_best.msgpack"))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(jax.tree.leaves(got)) == len(leaves)
    for path, leaf in leaves:
        g = functools.reduce(lambda t, k: t[k.key], path, got)
        assert g.dtype == leaf.dtype and g.shape == leaf.shape
        assert g.tobytes() == leaf.tobytes(), path
    tm = tfid.load_fidnet_v3("synthetic", L, str(tmp_path), S, device="cpu")
    bbox, label, mask = _batch(6)
    np.testing.assert_allclose(
        tfid.make_feature_extractor(tm)(bbox, label, mask).numpy(),
        np.asarray(features(variables, bbox, label, mask)), atol=TOL)
    with pytest.raises(FileNotFoundError):
        tfid.load_fidnet_v3("rico25", L, str(tmp_path), S, device="cpu")


def test_fid_transform_matches_jax():
    bbox, label, mask = _batch(7, B=32)
    batch = {"bbox": bbox, "label": label, "mask": mask}
    want = jax_fid_transform(np.random.RandomState(9), dict(batch))
    got = fid_transform(np.random.RandomState(9), dict(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_three_adam_steps_match_optax():
    """The loss and three Adam(3e-4) steps against optax.adam on the same
    batches (the noise of ``fid_transform`` drawn once, on the JAX side),
    both in float64: the key third of each ``in_proj_bias`` has an
    analytically zero gradient (the softmax ignores a shift shared by all
    keys), so in float32 Adam scales its rounding noise to steps of up to
    lr whose sign differs between any two implementations."""
    model, variables, _ = _flax(3)
    tm = _port(3, variables).double().train()
    topt = torch.optim.Adam(tm.parameters(), lr=3e-4)
    rs = np.random.RandomState(11)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        optimizer = optax.adam(3e-4)
        step, _ = make_fid_train_step(model, optimizer)
        opt_state = optimizer.init(params)
        for i in range(3):
            bbox, label, mask = _batch(20 + i, B=16)
            batch = jax_fid_transform(rs, {"bbox": bbox.astype(np.float64), "label": label,
                                           "mask": mask})
            batch["is_real"] = batch["is_real"].astype(np.float64)
            params, opt_state, jm = step(params, opt_state, batch)
            tmetrics = train_step(tm, topt, {
                "bbox": torch.as_tensor(batch["bbox"]), "label": torch.as_tensor(batch["label"]).long(),
                "mask": torch.as_tensor(batch["mask"]), "is_real": torch.as_tensor(batch["is_real"])})
            for k in ("loss", "bce", "label", "bbox"):
                assert abs(float(tmetrics[k]) - float(jm[k])) <= ADAM_TOL, k
        want = jax.tree.map(np.asarray, params)
    assert want["fc_bbox"]["kernel"].dtype == np.float64
    want = tfid.fidnet_params_from_flax(want)
    for n, p in tm.state_dict().items():
        err = (p.double() - want[n].double()).abs().max().item()
        assert err <= ADAM_TOL, (n, err)


def test_legacy_checkpoints_load(tmp_path):
    """A V1 ``.pth.tar`` gives the same logits through the JAX package's
    ``load_torch_fidnet_v1`` and the port's; a V2 file (batch-norm running
    statistics included) loads back into the port unchanged."""
    torch.manual_seed(1)
    v1 = tfid.FIDNetV1(L, device="cpu")
    torch.save({"state_dict": v1.state_dict()}, tmp_path / "v1.pth.tar")
    jm, jp = jfid.load_torch_fidnet_v1(str(tmp_path / "v1.pth.tar"), L)
    tm = tfid.load_torch_fidnet_v1(str(tmp_path / "v1.pth.tar"), L, device="cpu")
    bbox, label, mask = _batch(8)
    want = jax.jit(jm.apply)({"params": jp}, bbox, label, ~mask)
    np.testing.assert_allclose(_heads(tm, bbox, label, mask)[0].numpy(), np.asarray(want),
                               atol=TOL)
    v2 = tfid.FIDNetV2(L, max_bbox=S, device="cpu")
    v2.fc_out[1].running_mean.uniform_()
    torch.save(v2.state_dict(), tmp_path / "v2.pth.tar")
    back = tfid.load_torch_fidnet_v2(str(tmp_path / "v2.pth.tar"), L, max_bbox=S, device="cpu")
    assert not back.training
    for k, v in v2.state_dict().items():
        assert torch.equal(v, back.state_dict()[k]), k
