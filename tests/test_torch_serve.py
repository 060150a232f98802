"""The port's layout service held against the JAX service on the same
weights (a JAX job bridged into the port's job format), its HTTP front on
a loopback socket, relation requests, seed determinism and request
coalescing."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from layoutdm_tpu.configs import (
    SamplingConfig,
    build_train_config,
    to_dict,
)
from layoutdm_tpu.factory import build_model as jax_build_model
from layoutdm_tpu.serve_cli import LayoutService as JaxService
from layoutdm_tpu.serve_cli import _row_seeds as jax_row_seeds
from layoutdm_tpu.train import checkpoint as jax_ckpt
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.serve_cli import (
    LayoutHTTPServer,
    LayoutService,
    _row_seeds,
    main,
    make_handler,
    make_server,
)
from layoutdm_tpu_torch.utils.params import load_job, params_from_flax, save_job

LAYOUT = {
    "label": [1, 3, 0],
    "bbox": [[0.5, 0.2, 0.3, 0.1], [0.3, 0.6, 0.4, 0.2], [0.7, 0.8, 0.2, 0.15]],
}
RELATIONS = [{"src": "canvas", "dst": 0, "loc": "top"},
             {"src": 0, "dst": 1, "size": "larger", "loc": "bottom"},
             {"src": 1, "dst": 2, "size": "smaller"}]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """A JAX job (config.json + msgpack) and the same weights as a port job."""
    root = tmp_path_factory.mktemp("serve")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    cfg = build_train_config("layoutdm", "synthetic", [
        "data.bbox_quantization=linear", "dataset.max_seq_length=5",
        "backbone.d_model=128", "backbone.nhead=2",
        "backbone.dim_feedforward=64", "backbone.num_layers=2",
        "model.num_timesteps=10", "backbone.diffusion_step=10",
    ])
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(3))
    jax_ckpt.save_config(cfg, jax_dir)
    jax_ckpt.save_params(params, jax_dir, "best")
    with open(f"{jax_dir}/config.json") as f:
        port_cfg = tconfigs.train_config_from_dict(json.load(f))
    save_job(port_cfg, params_from_flax(jax.tree.map(np.asarray, params)), port_dir)
    return jax_dir, port_dir, cfg


def test_job_roundtrip_keeps_config(jobs):
    _, port_dir, cfg = jobs
    port_cfg, sd = load_job(port_dir)
    assert json.loads(json.dumps(to_dict(cfg))) == json.loads(
        json.dumps(to_dict(port_cfg))
    )
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_cli_refuses_a_missing_cuda_device_and_serves_on_cpu_when_asked(jobs):
    """The service runs on CUDA unless told device=cpu: on a host without
    CUDA it refuses to start instead of falling back to the CPU."""
    _, port_dir, _ = jobs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([f"job_dir={port_dir}", "port=0"])
    svc, httpd = make_server([f"job_dir={port_dir}", "port=0", "device=cpu",
                              "max_batch_size=2", "warm_tasks="])
    try:
        assert svc.device == torch.device("cpu")
        assert svc.model.net.head.weight.device.type == "cpu"
        assert httpd.server_address[1] > 0
    finally:
        httpd.server_close()
        svc.close()


def test_row_seeds_identical():
    for seed in (0, 7, 2**31 - 1):
        np.testing.assert_array_equal(_row_seeds(seed, 9), jax_row_seeds(seed, 9))


@pytest.fixture(scope="module")
def services(jobs):
    jax_dir, port_dir, _ = jobs
    js = JaxService(jax_dir, max_batch_size=4, warm_tasks=(),
                    sampling=SamplingConfig(name="deterministic"))
    ts = LayoutService(port_dir, max_batch_size=4, warm_tasks=(),
                       sampling=tconfigs.SamplingConfig(name="deterministic"), device="cpu")
    yield js, ts
    js.close()
    ts.close()


@pytest.mark.parametrize("task", ["c", "cwh", "unconditional"])
def test_service_matches_jax_service(services, task):
    js, ts = services
    layout = None if task == "unconditional" else LAYOUT
    want = js.generate(task, 3, seed=5, layout=layout)
    got = ts.generate(task, 3, seed=5, layout=layout)
    assert got["layouts"] == want["layouts"]
    assert got["seed"] == want["seed"]
    if task == "c":
        for lay in got["layouts"]:
            assert sorted(lay["label"]) == sorted(LAYOUT["label"])


def test_relation_request_matches_jax_service(services):
    """The graph lowered from a relation request, the guided lane and the
    violation rate, against the JAX service on the same weights."""
    js, ts = services
    for layout in (LAYOUT, {"label": LAYOUT["label"]}):
        want = js.generate("relation", 3, seed=4, layout=layout, relations=RELATIONS)
        got = ts.generate("relation", 3, seed=4, layout=layout, relations=RELATIONS)
        assert got["layouts"] == want["layouts"]
        assert got["violation_rate"] == want["violation_rate"]
    assert ts.info()["max_edges"] == js.info()["max_edges"] == 32


@pytest.fixture(scope="module")
def server(jobs):
    """The port's HTTP front over a random-sampling service with a ladder."""
    _, port_dir, _ = jobs
    svc = LayoutService(port_dir, max_batch_size=8, timestep_ladder=(4,),
                        coalesce_window_ms=50.0, device="cpu")
    httpd = LayoutHTTPServer(("127.0.0.1", 0), make_handler(svc))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield svc, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    svc.close()


def _post(url, payload):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_generate_and_errors(server):
    svc, url = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert info["status"] == "ok" and info["timestep_ladder"] == [4]
    code, out = _post(url, {"task": "c", "batch_size": 2, "seed": 1, "layout": LAYOUT})
    assert code == 200 and len(out["layouts"]) == 2
    for lay in out["layouts"]:
        assert sorted(lay["label"]) == sorted(LAYOUT["label"])
        assert all(0.0 <= v <= 1.0 for b in lay["bbox"] for v in b)
    for task in ("partial", "refinement"):
        code, out = _post(url, {"task": task, "batch_size": 2, "seed": 1,
                                "layout": LAYOUT, "num_timesteps": 4})
        assert code == 200 and len(out["layouts"]) == 2
    code, out = _post(url, {"task": "relation", "layout": LAYOUT})
    assert code == 400 and "requires a non-empty 'relations' list" in out["error"]
    code, out = _post(url, {"task": "relation", "batch_size": 2, "seed": 1,
                            "layout": {"label": LAYOUT["label"]}, "relations": RELATIONS})
    assert code == 200 and len(out["layouts"]) == 2 and 0.0 <= out["violation_rate"] <= 1.0
    for lay in out["layouts"]:
        assert sorted(lay["label"]) == sorted(LAYOUT["label"])
    for bad in ([{"src": 0, "dst": 3, "loc": "top"}], [{"src": 0, "dst": 0, "loc": "top"}],
                [{"src": 0, "dst": 1}], [{"src": "canvas", "dst": 1, "size": "huge"}],
                [{"src": 1, "dst": "canvas", "loc": "top"}], RELATIONS * 20):
        code, out = _post(url, {"task": "relation", "layout": LAYOUT, "relations": bad})
        assert code == 400, bad
    assert _post(url, {"task": "nope"})[0] == 400
    assert _post(url, {"task": "unconditional", "num_timesteps": 3})[0] == 400
    assert _post(url, {"task": "c"})[0] == 400  # conditional task without layout


def test_seed_determinism_and_coalescing(server):
    svc, url = server
    req = lambda s: {"task": "unconditional", "batch_size": 1, "seed": s,
                     "num_timesteps": 4}
    serial = {s: _post(url, req(s))[1]["layouts"] for s in range(6)}
    assert serial[0] == _post(url, req(0))[1]["layouts"]
    results = {}
    runs0 = svc.runs
    threads = [
        threading.Thread(target=lambda s=s: results.__setitem__(s, _post(url, req(s))[1]["layouts"]))
        for s in serial
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert results == serial  # coalesced rows equal their serial results
    assert svc.runs - runs0 < len(serial)
