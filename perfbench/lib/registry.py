"""Finds the benchmark's parts by name: a configuration is
``configs/<name>.json``, a cell ``cells/<name>.json``, a traffic module
``traffic/<kind>.py`` and a per-layer metric ``metrics/<name>.py``.  A new
part is a new file: nothing here lists them."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # perfbench/
REPO = os.path.dirname(ROOT)

METRIC_KEYS = ("NAME", "UNIT", "BETTER", "SOURCE", "LAYER", "MOVES", "WORKLOADS", "read")


def _json(kind: str, name: str, root: str = ROOT) -> Dict:
    path = os.path.join(root, kind, f"{name}.json")
    if not os.path.exists(path):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        out = json.load(f)
    if out.get("name") != name:
        raise ValueError(f"{path} names itself {out.get('name')!r}")
    return out


def config(name: str, root: str = ROOT) -> Dict:
    return _json("configs", name, root)


def cell(name: str, root: str = ROOT) -> Dict:
    return _json("cells", name, root)


def names(kind: str, root: str = ROOT) -> List[str]:
    """Every part of ``kind`` (configs, cells, metrics, traffic) on disk."""
    ext = ".py" if kind in ("metrics", "traffic") else ".json"
    d = os.path.join(root, kind)
    return sorted(f[: -len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def _module(kind: str, name: str, root: str = ROOT) -> ModuleType:
    path = os.path.join(root, kind, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str, root: str = ROOT) -> ModuleType:
    return _module("traffic", kind, root)


def metric(name: str, root: str = ROOT) -> ModuleType:
    mod = _module("metrics", name, root)
    missing = [k for k in METRIC_KEYS if not hasattr(mod, k)]
    if missing or mod.NAME != name:
        raise ValueError(f"metrics/{name}.py: missing {missing} "
                         f"or NAME {getattr(mod, 'NAME', None)!r}")
    return mod


def metrics_of(cell_name: str, root: str = ROOT) -> List[ModuleType]:
    """The per-layer metrics whose ``WORKLOADS`` list ``cell_name``."""
    return [m for m in (metric(n, root) for n in names("metrics", root))
            if cell_name in m.WORKLOADS]
