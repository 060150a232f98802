"""Serving capacity bench: drive the port's HTTP service (port of
``bin/bench_serve.py``).

    python -m layoutdm_tpu_torch.bench.serve --job_dir DIR [--ladder 25] [--out DIR]
    python -m layoutdm_tpu_torch.bench.serve --url http://127.0.0.1:8700

With ``--job_dir`` the bench starts ``layoutdm_tpu_torch.serve_cli`` on
that job in a child process (so the client threads do not share the
server's interpreter lock), waits until it listens, and stops it at the
end; with ``--url`` it drives a service already running.  For each rung of
the service's ``timestep_ladder`` and for the trained T (``t_eval``
null), closed-loop clients post unconditional requests:

- 10 sequential requests of ``max_batch_size`` layouts: bulk layouts/s;
- 1 client sending 16 batch-1 requests;
- 16 concurrent clients sending 64 batch-1 requests between them: with
  request coalescing they share chain runs, so ``program_runs`` (from
  ``/healthz``) falls below ``requests``.

A row a scenario: ``t_eval, threads, batch_size, requests, req_per_s,
layouts_per_s, p50_ms, p95_ms, program_runs``, its request latencies as
``runs`` (ms, host clock around each ``POST /generate``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from layoutdm_tpu_torch.bench.common import DEFAULT_OUT, card, emit, require_device, row, write_rows

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
READY = re.compile(r"listening on :(\d+)")


def post(url: str, payload: Dict, retries: int = 2) -> Dict:
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    for attempt in range(retries + 1):
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.loads(r.read())
        except (ConnectionResetError, ConnectionRefusedError):
            if attempt == retries:
                raise
            time.sleep(0.1 * (attempt + 1))


def healthz(url: str) -> Dict:
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        return json.loads(r.read())


def scenario(url: str, t_eval: Optional[int], n_req: int, n_threads: int,
             batch_size: int) -> Dict:
    """``n_threads`` closed-loop clients sending ``n_req`` requests between
    them after one warm-up request; the scenario's fields and its
    latencies (ms)."""
    payload = {"task": "unconditional", "batch_size": batch_size}
    if t_eval:
        payload["num_timesteps"] = t_eval
    post(url, dict(payload, seed=0))  # warm the lane
    runs0 = healthz(url)["program_runs"]
    lat = []
    lock = threading.Lock()
    errors = []

    def worker(k):
        try:
            for i in range(n_req // n_threads):
                t0 = time.perf_counter()
                resp = post(url, dict(payload, seed=1000 + k * 1000 + i))
                dt = time.perf_counter() - t0
                if len(resp["layouts"]) != batch_size:
                    raise AssertionError(f"{len(resp['layouts'])} layouts for {batch_size}")
                with lock:
                    lat.append(dt)
        except Exception as e:  # reported after the join
            errors.append(e)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=1800)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in ts):
        raise RuntimeError(f"serve scenario failed: {errors[:1] or 'a client hung'}")
    ms = sorted(1e3 * x for x in lat)
    return {
        "t_eval": t_eval, "threads": n_threads, "batch_size": batch_size,
        "requests": len(ms), "req_per_s": len(ms) / wall,
        "layouts_per_s": batch_size * len(ms) / wall,
        "p50_ms": ms[len(ms) // 2], "p95_ms": ms[int(len(ms) * 0.95)],
        "program_runs": healthz(url)["program_runs"] - runs0,
        "latencies_ms": ms,
    }


def write_random_job(job_dir: str, cfg, seed: int = 0) -> str:
    """A job directory holding ``cfg`` and random weights from ``seed``
    (what the bench serves when no trained job is at hand)."""
    import torch

    from layoutdm_tpu_torch.factory import build_model
    from layoutdm_tpu_torch.utils.params import save_job

    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    save_job(cfg, model.net.state_dict(), job_dir)
    return job_dir


def start_service(job_dir: str, ladder: Sequence[int], max_batch_size: int, device,
                  log_path: str, timeout_s: float = 900.0) -> Tuple[subprocess.Popen, str]:
    """``serve_cli`` on ``job_dir`` in a child process on a free port, its
    log in ``log_path``; returns it and its URL once it listens."""
    args = [sys.executable, "-m", "layoutdm_tpu_torch.serve_cli",
            f"job_dir={os.path.abspath(job_dir)}", "port=0",
            f"max_batch_size={max_batch_size}", f"device={device}"]
    if ladder:
        args.append("timestep_ladder=" + ",".join(str(t) for t in ladder))
    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    log = open(log_path, "w")
    try:
        # from the repo's root, where ``-m`` finds the package
        proc = subprocess.Popen(args, cwd=REPO_ROOT, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()  # the child holds its own descriptor
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        with open(log_path) as f:
            m = READY.search(f.read())
        if m:
            return proc, f"http://127.0.0.1:{m.group(1)}"
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    stop_service(proc)
    with open(log_path) as f:
        tail = f.read()[-2000:]
    raise RuntimeError(f"serve_cli did not start (exit {proc.returncode}):\n{tail}")


def stop_service(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def bench(url: str, device, info: Dict, threads: Sequence[int] = (1, 16),
          n_sequential: int = 10) -> List[Dict]:
    """The scenarios against a listening service, a row each."""
    health = healthz(url)
    rungs = list(health.get("timestep_ladder") or []) + [None]  # None: the trained T
    rows = []
    for t_eval in rungs:
        plan = [(n_sequential, 1, health["max_batch_size"])]
        plan += [(max(n * 4, 16), n, 1) for n in threads]
        for n_req, n_threads, batch_size in plan:
            s = scenario(url, t_eval, n_req, n_threads, batch_size)
            rows.append(emit(row(device, info, s.pop("latencies_ms"), "ms", metric="serve",
                                 path=health.get("denoiser"), **s)))
    return rows


def run(url: Optional[str] = None, job_dir: Optional[str] = None,
        ladder: Sequence[int] = (25,), max_batch_size: int = 64, device="cuda",
        threads: Sequence[int] = (1, 16), n_sequential: int = 10,
        out: str = DEFAULT_OUT) -> List[Dict]:
    """Bench the service at ``url``, or one started on ``job_dir`` with
    ``ladder`` and ``max_batch_size`` on ``device``."""
    device = require_device(device)
    if (url is None) == (job_dir is None):
        raise ValueError("give a url or a job_dir")
    proc = None
    if job_dir is not None:
        proc, url = start_service(job_dir, ladder, max_batch_size, device,
                                  os.path.join(out, "serve_cli.log"))
    try:
        dev = require_device(healthz(url)["device"])
        rows = bench(url, dev, card(dev), threads, n_sequential)
    finally:
        if proc is not None:
            stop_service(proc)
    for r in rows:
        if not np.isfinite([r["req_per_s"], r["p50_ms"], r["p95_ms"]]).all():
            raise AssertionError(f"serve row {r}")
    write_rows(out, "serve", rows)
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url")
    ap.add_argument("--job_dir")
    ap.add_argument("--ladder", default="25", help="timestep_ladder of a started service")
    ap.add_argument("--max_batch_size", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    a = ap.parse_args(argv)
    return run(a.url, a.job_dir, [int(t) for t in a.ladder.split(",") if t],
               a.max_batch_size, a.device, out=a.out)


if __name__ == "__main__":
    main()
