"""The port's checkpoint and cluster bridges held against the JAX package:
the reference's pickled KMeans centres (both packages pick the ``.pkl``
and read the same centres), reference ``state_dict``s through both
importers (same logits, same LtState), and a JAX trainer's job read by
`load_jax_job` (same logits, same aux state)."""

import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from layoutdm_tpu.configs import BackboneConfig as JaxBackbone
from layoutdm_tpu.configs import build_train_config as jax_build_train_config
from layoutdm_tpu.factory import build_model as jax_build_model
from layoutdm_tpu.factory import resolve_centers as jax_resolve_centers
from layoutdm_tpu.models.base import SeqLenState as JaxSeqLenState
from layoutdm_tpu.models.nn import CategoricalTransformer as JaxTransformer
from layoutdm_tpu.tokenizer.bbox import load_kmeans_centers as jax_load_centers
from layoutdm_tpu.train import checkpoint as jax_ckpt
from layoutdm_tpu.utils.torch_port import (
    convert_categorical_transformer as jax_convert,
)
from layoutdm_tpu.utils.torch_port import (
    import_layoutdm_checkpoint as jax_import_checkpoint,
)
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.factory import build_model, resolve_centers
from layoutdm_tpu_torch.models.base import SeqLenState
from layoutdm_tpu_torch.models.nn import make_transformer
from layoutdm_tpu_torch.tokenizer.bbox import load_kmeans_centers
from layoutdm_tpu_torch.utils.params import (
    load_aux_state,
    load_jax_job,
    load_job,
    params_from_flax,
)
from layoutdm_tpu_torch.utils.torch_port import (
    convert_categorical_transformer,
    import_layoutdm_checkpoint,
    to_reference_state_dict,
)
from test_torch_port import FF, H, L, S, T_STEPS, V, D, TorchDenoiser

LOGIT_TOL = 1e-5  # float32, same weights, same shapes
# the sinusoidal timestep embedding rescales t to 4000 steps: torch's and
# XLA's float32 exp may differ by one ulp in a frequency, which moves an
# angle of up to ~4000 rad by ~4e-4 before its sine (seen: 1.3e-5 in the logits)
ABS_LOGIT_TOL = 1e-4


# -- F2: the reference's pickled cluster centres ------------------------------


def _write_kmeans_pickle(path, num_bins, rs, monkeypatch):
    """A pickle of stand-in ``sklearn.cluster._kmeans.KMeans`` objects
    (one per coordinate, unsorted ``cluster_centers_`` of shape (nb, 1)),
    as the reference writes them (`bbox_tokenizer.py:56-58`)."""

    class KMeans:
        def __init__(self, centers):
            self.cluster_centers_ = centers
            self.n_clusters = len(centers)

    KMeans.__module__ = "sklearn.cluster._kmeans"
    KMeans.__qualname__ = "KMeans"
    fake = types.ModuleType("sklearn.cluster._kmeans")
    fake.KMeans = KMeans
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "sklearn.cluster._kmeans", fake)
        models = {f"{k}-{num_bins}": KMeans(rs.rand(num_bins, 1)) for k in "xywh"}
        with open(path, "wb") as f:
            pickle.dump(models, f)
    return {k: np.sort(v.cluster_centers_.reshape(-1)) for k, v in models.items()}


def test_reference_kmeans_pickle_is_read_and_picked_in_both_packages(tmp_path, monkeypatch):
    nb = 8
    cdir = tmp_path / "clustering_weights"
    cdir.mkdir()
    pkl = cdir / "synthetic_max5_kmeans_train_clusters.pkl"
    want = _write_kmeans_pickle(str(pkl), nb, np.random.RandomState(0), monkeypatch)
    want = np.stack([want[f"{k}-{nb}"] for k in "xywh"]).astype(np.float32)

    np.testing.assert_array_equal(load_kmeans_centers(str(pkl), nb), want)
    np.testing.assert_array_equal(jax_load_centers(str(pkl), nb), want)

    ov = [f"dataset.dir={tmp_path}/datasets", "dataset.max_seq_length=5",
          f"data.num_bin_bboxes={nb}"]
    got = resolve_centers(tconfigs.build_train_config("layoutdm", "synthetic", ov))
    jgot = jax_resolve_centers(jax_build_train_config("layoutdm", "synthetic", ov))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jgot, want)
    assert sorted(p.name for p in cdir.iterdir()) == [pkl.name]  # nothing refitted


# -- reference state dicts ----------------------------------------------------


def _twin_state_dict(timestep_type, pos, bos=False, seed=0):
    """A reference-wired state dict (keys under ``transformer.``) from the
    torch twin of `test_torch_port`, with its norm1 swapped for the zoo's
    LayerNorm or the MLP timestep embedding, and a BOS slot if asked."""
    torch.manual_seed(seed)
    twin = TorchDenoiser(timestep_type or "adalayernorm", pos)
    for blk in twin.backbone.layers:
        if timestep_type is None:
            blk.norm1 = nn.LayerNorm(D)
        elif "mlp" in timestep_type:
            blk.norm1.emb = nn.Sequential(nn.Identity(), nn.Linear(1, D // 2), nn.ReLU(),
                                          nn.Linear(D // 2, D))
    if bos:
        twin.pos_emb.bos_emb = nn.Parameter(torch.rand(1, D))
    with torch.no_grad():  # non-trivial norm parameters and biases
        for name, p in twin.named_parameters():
            if "norm" in name or name.endswith("bias") or name.startswith("head.0"):
                p.add_(0.1 * torch.randn(p.shape))
    return {f"transformer.{k}": v for k, v in twin.state_dict().items()}


def _both_logits(jax_params, port_sd, timestep_type, pos, max_len, seed=1):
    rs = np.random.RandomState(seed)
    seq = rs.randint(0, V, (3, max_len - 1 if max_len % 5 == 1 else max_len))
    t = rs.randint(0, T_STEPS, (3,))
    bb = dict(d_model=D, nhead=H, dim_feedforward=FF, num_layers=L, dropout=0.0,
              timestep_type=timestep_type, diffusion_step=T_STEPS)
    jnet = JaxTransformer(backbone=JaxBackbone(**bb), num_classes=V, max_token_length=max_len,
                          pos_emb=pos, n_attr_per_elem=5)
    tj = None if timestep_type is None else jnp.asarray(t)
    want = np.asarray(jnet.apply({"params": jax_params}, jnp.asarray(seq), tj))
    net = make_transformer("cpu", backbone=tconfigs.BackboneConfig(**bb), num_classes=V,
                           max_token_length=max_len, pos_emb=pos, n_attr_per_elem=5)
    net.load_state_dict(port_sd)
    with torch.no_grad():
        got = net(torch.as_tensor(seq), None if timestep_type is None else torch.as_tensor(t))
    return got.numpy(), want


@pytest.mark.parametrize("timestep_type,pos,bos", [
    (None, "elem_attr", False),
    (None, "default", False),
    (None, "elem_attr", True),
    ("adalayernorm", "elem_attr", False),
    ("adalayernorm", "default", False),
    ("adalayernorm_abs", "default", False),
    ("adalayernorm_mlp", "elem_attr", False),
])
def test_reference_state_dict_imports_as_in_jax(timestep_type, pos, bos):
    sd = _twin_state_dict(timestep_type, pos, bos)
    port_sd = convert_categorical_transformer(sd, L, timestep_type)
    jax_params = jax_convert(sd, L, timestep_type)
    got, want = _both_logits(jax_params, port_sd, timestep_type, pos, S + 1 if bos else S)
    tol = ABS_LOGIT_TOL if "abs" in (timestep_type or "") else LOGIT_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    back = to_reference_state_dict(port_sd, L, timestep_type)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_reference_checkpoint_import_matches_jax(tmp_path):
    sd = {f"model.module.{k}": v for k, v in _twin_state_dict("adalayernorm", "elem_attr").items()}
    rs = np.random.RandomState(4)
    sd["model.module.Lt_history"] = torch.as_tensor(rs.rand(T_STEPS).astype(np.float32))
    sd["model.module.Lt_count"] = torch.as_tensor(rs.randint(0, 20, T_STEPS).astype(np.float32))
    sd["model.module.c_log_at"] = torch.zeros(T_STEPS)  # a schedule buffer: not read
    path = str(tmp_path / "best_model.pt")
    torch.save({"state_dict": sd}, path)
    port_sd, lt = import_layoutdm_checkpoint(path, num_layers=L)
    jax_params, jlt = jax_import_checkpoint(path, num_layers=L)
    np.testing.assert_array_equal(lt.history.numpy(), np.asarray(jlt.history))
    np.testing.assert_array_equal(lt.count.numpy(), np.asarray(jlt.count))
    got, want = _both_logits(jax_params, port_sd, "adalayernorm", "elem_attr", S)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


# -- JAX jobs -----------------------------------------------------------------

TINY = ["dataset.max_seq_length=5", "data.bbox_quantization=linear", "backbone.d_model=64",
        "backbone.nhead=2", "backbone.dim_feedforward=64", "backbone.num_layers=2"]


def test_jax_job_reads_into_a_port_job(tmp_path):
    jcfg = jax_build_train_config("maskgit", "synthetic", TINY + [f"job_dir={tmp_path}/jax"])
    jm = jax_build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3))
    jstate = JaxSeqLenState(probs=jnp.asarray(np.random.RandomState(5).dirichlet(np.ones(5)),
                                              jnp.float32))
    jdir = str(tmp_path / "jax")
    jax_ckpt.save_config(jcfg, jdir)
    jax_ckpt.save_params(params, jdir, "best")
    final = jax.tree.map(lambda p: p + 1.0, params)
    jax_ckpt.save_params(final, jdir, "final")
    jax_ckpt.save_train_state(jstate, jdir, name="aux_state")

    pdir = str(tmp_path / "port")
    cfg, sd, aux = load_jax_job(jdir, pdir)
    np.testing.assert_array_equal(aux["probs"], np.asarray(jstate.probs))
    got_final = torch.load(os.path.join(pdir, "final_params.pt"), weights_only=True)
    for k, v in params_from_flax(jax.tree.map(np.asarray, final)).items():
        assert torch.equal(got_final[k], v), k
    cfg2, sd2 = load_job(pdir)
    assert tconfigs.to_dict(cfg2) == tconfigs.to_dict(cfg)
    model = build_model(cfg2, device="cpu")
    model.net.load_state_dict(sd2)
    state = load_aux_state(model.init_state(), pdir)
    assert isinstance(state, SeqLenState)
    np.testing.assert_array_equal(state.probs.numpy(), np.asarray(jstate.probs))

    rs = np.random.RandomState(6)
    seq = rs.randint(0, model.num_classes, (3, model.seq_len))
    pad = rs.rand(3, model.seq_len) < 0.3
    want = np.asarray(jm._apply(params, jnp.asarray(seq), jnp.asarray(pad)))
    with torch.no_grad():
        got = model._apply(torch.as_tensor(seq), torch.as_tensor(pad)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
