"""Nothing a benchmark run loads is JAX or the JAX package, and the plain
reference loads nothing of the program (module names compared by their
top-level part, whole)."""

import json
import os
import subprocess
import sys

import pytest

from perfbench.lib import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "layoutdm_tpu"}


def loaded_by(code: str):
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=registry.REPO, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'perfbench'); sys.argv = ['run.py']\n"
            "import runpy; m = runpy.run_path('perfbench/run.py', run_name='perfbench_run')\n"
            "from perfbench.lib import registry, program, checks, tap, stretch\n"
            "import layoutdm_tpu_torch.factory\n"
            "import layoutdm_tpu_torch.train.step, layoutdm_tpu_torch.models.int8_serving\n"
            "for k in registry.names('traffic'): registry.traffic(k)\n"
            "for k in registry.names('metrics'): registry.metric(k)\n"
            "import perfbench.calibrate\n")
    mods = loaded_by(code)
    assert "torch" in mods and "layoutdm_tpu_torch" in mods
    assert not mods & FORBIDDEN, sorted(mods & FORBIDDEN)


@pytest.mark.parametrize("module", ["tokens", "diffusion", "denoiser", "noise", "tasks", "train"])
def test_reference_loads_nothing_of_the_program(module):
    mods = loaded_by(f"import perfbench.reference.{module}")
    assert not mods & (FORBIDDEN | {"layoutdm_tpu_torch"}), sorted(mods)


def test_harness_guard_names_forbidden_modules(monkeypatch):
    from perfbench.lib import harness

    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert harness.forbidden_modules() == ["flax"]
    monkeypatch.delitem(sys.modules, "flax.linen")
    monkeypatch.setitem(sys.modules, "layoutdm_tpu_torchx", object())
    assert harness.forbidden_modules() == []
