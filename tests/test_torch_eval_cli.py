"""The port's evaluation CLIs against the JAX package's on the same inputs:
``evaluate_results`` and ``compute_real_baseline`` of ``eval_cli`` on the
same result pickles, processed splits and FIDNet ``.pth.tar``;
``render_cli``'s CSV and images; and the port's ``fidnet_train`` CLI,
whose checkpoint the JAX package's ``load_fidnet_v3`` reads.

The splits hold more layouts (600) than the FID features have dimensions
(256), so the covariances have full rank.  On each package's own FIDNet
(float32 features from two implementations, within 1e-4 of each other) FID
agrees within 1e-3 relative and precision, recall, density and coverage
within 2 / 600: they count feature distances under a radius, and such
features move a few of the 600 x 5 comparisons across it.  On shared
features every score agrees within 1e-6 relative, and so does every score
that does not use the features."""

import contextlib
import io
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from layoutdm_tpu import eval_cli as jcli
from layoutdm_tpu import render_cli as jrender
from layoutdm_tpu.eval import fidnet as jfid
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch import eval_cli as tcli
from layoutdm_tpu_torch import render_cli as trender
from layoutdm_tpu_torch.data.datasets import load_dataset
from layoutdm_tpu_torch.eval import fidnet as tfid
from layoutdm_tpu_torch.eval.fidnet_train import main as fidnet_train_main

S, N, NUM_LABELS = 8, 600, 25  # rico25 labels, 600 layouts a split
REL, FID_REL = 1e-6, 1e-3
PRDC = ("precision", "recall", "density", "coverage")


def _layouts(rs, n):
    out = []
    for _ in range(n):
        k = rs.randint(1, S + 1)
        out.append((rs.rand(k, 4).astype(np.float32),
                    rs.randint(0, 4, k).astype(np.int32)))  # few labels: max-IoU groups
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Processed rico25 splits at S=8, FIDNetV3 weights under the
    reference's names, and three result pickles (two seeds of task c, one
    with inputs, and a relation one) as ``sample_cli`` writes them."""
    d = tmp_path_factory.mktemp("evalcli")
    rs = np.random.RandomState(0)
    proc = d / "datasets" / f"rico25-max{S}" / "processed"
    proc.mkdir(parents=True)
    for split in ("train", "val", "test"):
        bbox, label, mask = tcli.pad_layout_list(_layouts(rs, N), S)
        np.savez(proc / f"{split}.npz", bbox=bbox, label=label, mask=mask)
    fid_dir = d / "fid"
    (fid_dir / f"rico25-max{S}").mkdir(parents=True)
    torch.manual_seed(0)
    model = tfid.FIDNetV3(NUM_LABELS, max_bbox=S, device="cpu")
    torch.save({"state_dict": model.state_dict()},
               fid_dir / f"rico25-max{S}" / "model_best.pth.tar")
    cfg = tconfigs.build_train_config("layoutdm", "rico25", [
        f"dataset.max_seq_length={S}", f"dataset.dir={d / 'datasets'}"])
    results = d / "results"
    results.mkdir()
    paths = []
    for name, extra in (("c_seed_0", {"inputs": _layouts(rs, 20)}),
                        ("c_seed_1", {"inputs": []}),
                        ("relation_seed_0", {"inputs": [], "violation_rate": 0.25})):
        cond = name.split("_seed")[0]
        res = {"results": _layouts(rs, N), "train_cfg": tconfigs.to_dict(cfg),
               "test_cfg": {"cond": cond}, "ms_per_sample": float(rs.rand()), **extra}
        paths.append(str(results / f"{name}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(res, f)
    return {"dir": d, "fid": str(fid_dir), "paths": paths, "data": str(d / "datasets")}


def _same_scores(got, want, shared_features=False):
    assert sorted(got) == sorted(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        rel = FID_REL if k == "fid" and not shared_features else REL
        for g, w in zip(got[k], want[k]):
            if np.isnan(w):
                assert np.isnan(g), k
            elif k in PRDC and not shared_features:
                assert abs(g - w) <= 2 / N, (k, g, w)
            else:
                assert abs(g - w) <= rel * max(abs(w), 1e-12) + 1e-12, (k, g, w)
    text = lambda mod, s: _printed(mod.print_scores, s)
    assert text(tcli, got) == text(jcli, got)
    assert text(tcli, want) == text(jcli, want)


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def test_evaluate_results_matches_jax(setup):
    want = jcli.evaluate_results(setup["paths"][:2], setup["fid"])
    got = tcli.evaluate_results(setup["paths"][:2], setup["fid"], device="cpu")
    assert {"fid", "maximum_iou", "DocSim", "precision", "wdist_bbox"} <= set(got)
    assert np.isfinite(got["fid"]).all()
    _same_scores(got, want)


def test_evaluate_results_on_shared_features_matches_jax(setup, monkeypatch):
    """Both packages fed the port's features: the host metrics alone."""
    extract = tfid.make_feature_extractor(
        tfid.load_fidnet_v3("rico25", NUM_LABELS, setup["fid"], S, device="cpu"))
    monkeypatch.setattr(jcli, "load_fidnet_v3", lambda *a, **k: (None, None))
    monkeypatch.setattr(jcli, "make_feature_extractor", lambda model, params: (
        lambda *arrays: extract(*map(np.asarray, arrays)).numpy()))
    monkeypatch.setattr(tcli, "make_feature_extractor", lambda model: extract)
    want = jcli.evaluate_results(setup["paths"][:2], setup["fid"])
    got = tcli.evaluate_results(setup["paths"][:2], setup["fid"], device="cpu")
    _same_scores(got, want, shared_features=True)


def test_evaluate_results_without_weights_and_with_violations(setup, caplog):
    """No FIDNet weights: FID is skipped with a warning, as in JAX; a
    relation pickle adds its violation rate."""
    missing = str(setup["dir"] / "nothing")
    want = jcli.evaluate_results(setup["paths"][2:], missing)
    caplog.clear()
    got = tcli.evaluate_results(setup["paths"][2:], missing, device="cpu")
    assert "fid" not in got and got["violation"] == [0.25]
    assert "skipping FID" in caplog.text
    _same_scores(got, want)


def test_compute_real_baseline_matches_jax(setup):
    want = jcli.compute_real_baseline("rico25", setup["data"], S, setup["fid"])
    got = tcli.compute_real_baseline("rico25", setup["data"], S, setup["fid"], device="cpu")
    _same_scores(got, want)


def test_eval_cli_main_prints_the_jax_rows(setup):
    args = [str(setup["dir"] / "results"), "--fid_weight_dir", setup["fid"], "--cond", "c",
            "--dataset", "rico25", "--data_dir", setup["data"], "--max_seq_length", str(S)]
    scores = {}
    out = _printed(lambda: scores.update(tcli.main(args + ["--device", "cpu"])))
    lines = out.splitlines()
    assert lines[0] == ",".join(sorted(scores)) and len(lines) == 3
    assert len(scores["fid"]) == 2  # the two task-c seeds
    with pytest.raises(SystemExit):
        tcli.main([str(setup["dir"]), "--device", "cpu"])  # no pickles there


def test_render_cli_matches_jax(setup, tmp_path):
    path = setup["paths"][0]
    jrender.main([path, "--out_dir", str(tmp_path / "jax"), "--num_samples", "16"])
    trender.main([path, "--out_dir", str(tmp_path / "port"), "--num_samples", "16"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert names == ["generated.png", "inputs.png", "scores.csv"]
    want = (tmp_path / "jax" / "scores.csv").read_bytes()
    assert (tmp_path / "port" / "scores.csv").read_bytes() == want
    assert len(want.decode().splitlines()) == 17
    for name in ("generated.png", "inputs.png"):
        a = np.asarray(Image.open(tmp_path / "jax" / name))
        b = np.asarray(Image.open(tmp_path / "port" / name))
        assert a.shape == b.shape and (a == b).all(), name
        assert a.std() > 0  # not blank


def test_fidnet_train_cli_writes_a_checkpoint_jax_reads(tmp_path):
    out = str(tmp_path / "fidw")
    args = ["synthetic", "--data_dir", "", "--out_dir", out, "--max_seq_length", "4",
            "--batch_size", "32", "--iteration", "40"]
    model, history = fidnet_train_main(args + ["--device", "cpu"])
    assert history == []  # shorter than one validation interval
    path = os.path.join(out, "synthetic-max4", "model_best.pth.tar")
    assert os.path.exists(path)
    jm, jp = jfid.load_fidnet_v3("synthetic", 5, out, 4)
    tm = tfid.load_fidnet_v3("synthetic", 5, out, 4, device="cpu")
    rs = np.random.RandomState(1)
    bbox, label = rs.rand(3, 4, 4).astype(np.float32), rs.randint(0, 5, (3, 4))
    mask = np.arange(4)[None] < np.array([[1], [3], [4]])
    np.testing.assert_allclose(
        tfid.make_feature_extractor(tm)(bbox, label, mask).numpy(),
        np.asarray(jfid.make_feature_extractor(jm, jp)(bbox, label, mask)), atol=1e-4)
    for k, v in model.state_dict().items():
        assert torch.equal(v, tm.state_dict()[k]), k


def test_render_cli_real_image_mode_matches_jax(tmp_path):
    """``--image_dir``: the test split's ground truth over its screenshots
    (a Rico fixture archive, one solid jpg per screen), pixel-equal."""
    from test_ingest_e2e import _write_rico_fixture

    data_dir = tmp_path / "datasets"
    _write_rico_fixture(str(data_dir / "rico25-max25" / "raw"), n_screens=30)
    test = load_dataset("rico25", str(data_dir), "test", 25)
    assert test.names is not None and len(test) >= 2
    img_dir = tmp_path / "combined"
    img_dir.mkdir()
    for i, n in enumerate(test.names):
        Image.new("RGB", (36, 64), (30 + 40 * i, 120, 30)).save(
            img_dir / os.path.basename(str(n)).replace(".json", ".jpg"))
    cfg = tconfigs.build_train_config("layoutdm", "rico25", [f"dataset.dir={data_dir}"])
    pkl = tmp_path / "c_test_seed_0.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"results": [(test.bbox[i][test.mask[i]], test.label[i][test.mask[i]])
                                 for i in range(len(test))],
                     "train_cfg": tconfigs.to_dict(cfg), "test_cfg": {}}, f)
    for pkg, main in (("jax", jrender.main), ("port", trender.main)):
        main([str(pkl), "--out_dir", str(tmp_path / pkg), "--image_dir", str(img_dir)])
    a = np.asarray(Image.open(tmp_path / "jax" / "real_gt.png"))
    b = np.asarray(Image.open(tmp_path / "port" / "real_gt.png"))
    assert a.shape == b.shape and (a == b).all() and a.std() > 0
