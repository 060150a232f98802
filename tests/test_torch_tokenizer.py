"""Port tokenizer held against the JAX package: bbox quantization, layout
sequences and the full<->partial vocabulary converter.  Ids are exact;
converted log-probs within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdm_tpu.configs import build_train_config
from layoutdm_tpu.factory import build_tokenizer as jax_build_tokenizer
from layoutdm_tpu.tokenizer.bbox import BboxTokenizer as JaxBbox
from layoutdm_tpu.tokenizer.converter import Converter as JaxConverter
from layoutdm_tpu.tokenizer.sequence import LayoutSequenceTokenizer as JaxTok
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.factory import build_model, build_tokenizer
from layoutdm_tpu_torch.tokenizer.bbox import BboxTokenizer
from layoutdm_tpu_torch.tokenizer.converter import Converter
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer

LOG_TOL = 1e-6

BBOX_CASES = [
    dict(num_bins=32, shared_vocab="x-y-w-h"),
    dict(num_bins=8, shared_vocab="xywh"),
    dict(num_bins=8, shared_vocab="x-y-w-h", var_order=("w", "h", "x", "y")),
]


def _centers(rs, nbins):
    return np.sort(rs.rand(4, nbins).astype(np.float32), axis=1)


@pytest.mark.parametrize("kw", BBOX_CASES)
@pytest.mark.parametrize("quant", ["linear", "kmeans"])
def test_bbox_encode_decode_exact(kw, quant, rng):
    centers = _centers(rng, kw["num_bins"]) if quant == "kmeans" else None
    jb = JaxBbox(quantization=quant, centers=centers, **kw)
    tb = BboxTokenizer(quantization=quant, centers=centers, **kw)
    # include out-of-range and exact-bin-edge coordinates
    box = rng.rand(3, 11, 4).astype(np.float32) * 1.2 - 0.1
    box[0, 0] = [0.5, 0.25, 1.0 / kw["num_bins"], 1.0]
    ids = tb.encode(torch.as_tensor(box))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jb.encode(jnp.asarray(box))))
    np.testing.assert_array_equal(
        tb.decode(ids).numpy(), np.asarray(jb.decode(jnp.asarray(ids.numpy())))
    )
    assert tb.vocab_len == jb.vocab_len
    for k, m in jb.token_masks().items():
        np.testing.assert_array_equal(tb.token_masks()[k], m)


def _tok_pair(**kw):
    bb_kw = {k: kw.pop(k) for k in ("num_bins", "shared_vocab", "var_order") if k in kw}
    common = dict(num_categories=5, max_elements=6, **kw)
    return (
        JaxTok(bbox_tokenizer=JaxBbox(**bb_kw), **common),
        LayoutSequenceTokenizer(bbox_tokenizer=BboxTokenizer(**bb_kw), **common),
    )


@pytest.mark.parametrize(
    "kw",
    [
        dict(num_bins=8, shared_vocab="x-y-w-h", pad_until_max=True),
        dict(num_bins=8, special_tokens=("pad", "bos", "eos", "mask"),
             var_order=("w", "h", "x", "y")),
        dict(num_bins=8, sort_by="category_alphabetical", pad_until_max=True),
    ],
)
def test_sequence_encode_decode_exact(kw, rng):
    jt, tt = _tok_pair(**kw)
    S = 4 if kw.get("pad_until_max") else 6
    batch = {
        "label": rng.randint(0, 5, (3, S)),
        "bbox": rng.rand(3, S, 4).astype(np.float32),
        "mask": np.arange(S)[None] < np.array([[1], [S], [2]]),
    }
    je, te = jt.encode(batch), tt.encode(batch)
    for k in ("seq", "mask"):
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))
    seq = te["seq"][:, 1:] if "bos" in tt.special_tokens else te["seq"]
    # corrupt some ids so the validity filter is exercised
    seq = seq.clone()
    seq[0, 1] = tt.N_total - 1
    jd, td = jt.decode(jnp.asarray(seq.numpy())), tt.decode(seq)
    for k in ("bbox", "label", "mask"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    np.testing.assert_array_equal(tt.token_mask(), jt.token_mask())
    assert tt.N_total == jt.N_total and tt.max_token_length == jt.max_token_length
    for name in tt.var_names + ("special",):
        assert tt.get_slice(name) == jt.get_slice(name)


def test_converter_ids_exact_and_logs_within_tolerance(rng):
    jt, tt = _tok_pair(num_bins=8, shared_vocab="x-y-w-h", pad_until_max=True)
    jc, tc = JaxConverter.build(jt), Converter.build(tt)
    for k in ("p2f", "f2p", "lane_valid", "n_normal"):
        np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k))
    B, S, A = 2, 6, tc.A
    ids = rng.randint(0, tc.Vf, (B, S, A))
    ids_valid = np.take_along_axis(
        tc.p2f[None, None], rng.randint(0, tc.Vp, (B, S, A))[..., None], axis=-1
    )[..., 0]
    np.testing.assert_array_equal(
        tc.f_to_p_id(torch.as_tensor(ids_valid)).numpy(),
        np.asarray(jc.f_to_p_id(jnp.asarray(ids_valid))),
    )
    lanes = rng.randint(0, tc.Vp, (B, S, A))
    np.testing.assert_array_equal(
        tc.p_to_f_id(torch.as_tensor(lanes)).numpy(),
        np.asarray(jc.p_to_f_id(jnp.asarray(lanes))),
    )
    del ids
    log_full = np.log(rng.dirichlet(np.ones(tc.Vf), (B, S, A))).astype(np.float32)
    log_part = np.log(rng.dirichlet(np.ones(tc.Vp), (B, S, A))).astype(np.float32)
    np.testing.assert_allclose(
        tc.f_to_p_log(torch.as_tensor(log_full)).numpy(),
        np.asarray(jc.f_to_p_log(jnp.asarray(log_full))), atol=LOG_TOL,
    )
    np.testing.assert_allclose(
        tc.p_to_f_log(torch.as_tensor(log_part)).numpy(),
        np.asarray(jc.p_to_f_log(jnp.asarray(log_part))), atol=LOG_TOL,
    )


def test_build_tokenizer_matches_jax_linear_and_cached_kmeans(tmp_path):
    over = [f"dataset.dir={tmp_path}/datasets/rico25"]
    jcfg = build_train_config("layoutdm", "rico25", over)
    tcfg = tconfigs.build_train_config("layoutdm", "rico25", over)
    # kmeans from the cached .npz the JAX package writes
    nb = tcfg.data.num_bin_bboxes
    cdir = tmp_path / "datasets" / "clustering_weights"
    cdir.mkdir(parents=True)
    rs = np.random.RandomState(0)
    np.savez(cdir / "rico25_max25_kmeans_train_clusters.npz",
             **{f"{k}-{nb}": rs.rand(nb) for k in "xywh"})
    for quant in ("kmeans", "linear"):
        jcfg.data.bbox_quantization = tcfg.data.bbox_quantization = quant
        jt, tt = jax_build_tokenizer(jcfg), build_tokenizer(tcfg)
        np.testing.assert_array_equal(tt.bbox_tokenizer.centers, jt.bbox_tokenizer.centers)
        assert tt.N_total == jt.N_total == 155
        assert tt.max_token_length == jt.max_token_length == 125
        assert tt.special_tokens == jt.special_tokens
        assert tt.bbox_tokenizer.var_order == jt.bbox_tokenizer.var_order
    tcfg.data.bbox_quantization = "percentile"
    with pytest.raises(FileNotFoundError):
        build_tokenizer(tcfg)


def test_build_model_names_later_ports():
    """Every model name the JAX factory builds, the later ports' (BART,
    DiffusionLM, BitDiffusion) included, builds here; an unknown name
    raises KeyError."""
    tiny = ["data.bbox_quantization=linear", "dataset.max_seq_length=4",
            "backbone.d_model=64", "backbone.nhead=2", "backbone.dim_feedforward=32",
            "backbone.num_layers=1"]
    for name in ("layoutdm", "maskgit", "blt", "autoreg", "elem_wise_autoreg", "ruite",
                 "bart", "diffusionlm", "bitdiffusion"):
        cfg = tconfigs.build_train_config(
            name if name != "elem_wise_autoreg" else "autoreg", "rico25", tiny)
        cfg.model.name = name
        assert build_model(cfg, device="cpu").net is not None, name
    cfg.model.name = "unknown"
    with pytest.raises(KeyError):
        build_model(cfg, device="cpu")
