"""The port's ingest CLI (``layoutdm_tpu_torch/data/ingest.py``) against
the JAX package's on copies of the same raw fixtures (the Rico zip and
COCO files of ``tests/test_ingest_e2e.py``): the same report, line for
line, and equal ``.npz`` splits."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from layoutdm_tpu.data.ingest import main as jax_ingest
from layoutdm_tpu_torch.data.ingest import main as port_ingest
from test_ingest_e2e import _write_coco_fixture, _write_rico_fixture


def _run(main, args):
    """(exit code, report) of one CLI run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = main(args)
        except SystemExit as e:
            rc = e.code
    return rc, buf.getvalue()


def _both(tmp_path, name, write, S, extra=()):
    """Run both CLIs on their own copy of one raw fixture."""
    src = tmp_path / "src"
    write(str(src / f"{name}-max{S}" / "raw"))
    out = {}
    for pkg, main in (("jax", jax_ingest), ("port", port_ingest)):
        root = tmp_path / pkg
        shutil.copytree(src, root)
        rc, report = _run(main, [name, "--data_dir", str(root), "--max_seq_length", str(S),
                                 *extra])
        out[pkg] = (rc, report.replace(str(root), "<data_dir>"), root / f"{name}-max{S}")
    return out


@pytest.mark.parametrize("name,write", [("rico25", _write_rico_fixture),
                                        ("publaynet", _write_coco_fixture)])
def test_ingest_report_and_splits_equal_the_jax_cli(tmp_path, name, write):
    out = _both(tmp_path, name, write, 4)
    (jrc, jreport, jroot), (trc, treport, troot) = out["jax"], out["port"]
    assert jrc == trc == 0
    assert treport == jreport
    assert "raw ok:" in treport and "bbox in [0,1]: True" in treport
    for split in ("train", "val", "test"):
        want = np.load(jroot / "processed" / f"{split}.npz")
        got = np.load(troot / "processed" / f"{split}.npz")
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{split}/{k}")
    # --force re-parses into the same files
    rc, report = _run(port_ingest, [name, "--data_dir", str(troot.parent),
                                    "--max_seq_length", "4", "--force"])
    assert rc == 0 and report.replace(str(troot.parent), "<data_dir>") == jreport


def test_ingest_refusals_equal_the_jax_cli(tmp_path):
    """A missing archive exits 1 and an unknown dataset 2, with the same
    messages."""
    def nothing(raw_dir):
        os.makedirs(raw_dir)

    out = _both(tmp_path, "rico25", nothing, 4)
    assert out["jax"][:2] == out["port"][:2] and out["port"][0] == 1
    assert "missing raw file" in out["port"][1]
    with contextlib.redirect_stderr(io.StringIO()):
        assert _run(port_ingest, ["nosuch", "--data_dir", str(tmp_path)])[0] == 2
