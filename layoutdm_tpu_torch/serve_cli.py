"""Layout-generation HTTP service (port of ``layoutdm_tpu/serve_cli.py``).

    python -m layoutdm_tpu_torch.serve_cli job_dir=<dir> port=8700 \
        [max_batch_size=64] [timestep_ladder=25,100] [max_edges=32] [device=cuda|cpu]

The device is CUDA unless ``device=cpu`` is given; without CUDA the
service refuses to start rather than fall back to the CPU.  The denoiser
path follows the JAX package's switches in the environment
(`factory.build_model`): ``LAYOUTDM_TPU_FUSED_BLOCK=1`` /
``LAYOUTDM_TPU_FUSED_FFN=1`` run the fused kernels (K4 attention block, K3
LayerNorm-FFN-residual), ``LAYOUTDM_TPU_ATTN_V2=1`` the block-diagonal
attention (K5), ``LAYOUTDM_TPU_SMAJOR=1`` the S-major attention (K6); the
startup log and ``/healthz`` name the path.

Endpoints
---------
GET  /healthz   -> {"status": "ok", "model": ..., "dataset": ..., ...}
POST /generate  -> {"layouts": [{"label": [...], "bbox": [[x,y,w,h], ...]}],
                    "ms_per_sample": float, "seed": int,
                    "violation_rate": float (task "relation" only: the share
                    of the requested relations the layouts break)}
     request: {"task": "unconditional" | "c" | "cwh" | "partial"
                       | "refinement" | "relation",
               "batch_size": int (<= max_batch_size), "seed": int,
               "num_timesteps": int (a rung of the service's ladder),
               "layout": {"label": [...], "bbox": [[x,y,w,h], ...]}
                         ("bbox" optional for "relation"),
               "relations": [{"src": int | "canvas", "dst": int,
                              "size": "smaller" | "equal" | "larger",
                              "loc": "left" | "top" | "right" | "bottom"
                                     | "center"}, ...]
                   (task "relation": at most max_edges; 0-based indices
                   into layout.label; "dst is <size>/<loc> of src", and with
                   src "canvas", loc is dst's band of the canvas)}

Design (as in the JAX service): every request is lowered to per-row
(cond, seed) pairs; one device thread, the coalescer, packs same-lane
requests (lane = timestep count x guided x init mode x refinement prior)
into one run of the reverse chain, padded to ``max_batch_size`` rows.
Relation requests carry their graphs in the cond, padded to
``max_edges``, and run guided (`relation.guidance`); a guided run never
holds an unguided row.  Sampling is row-seeded, so a row's result depends
only on its own seed and a request's result does not depend on its
batch-mates (guidance takes the mean penalty over the fixed run width,
whatever the other rows hold).  The JAX service compiles one
program per lane; here each lane is the same eager chain, reused.

A job of the baseline zoo (MaskGIT, BLT, RUITE, the autoregressive model,
BART, DiffusionLM, BitDiffusion) serves too.  Its samplers draw one stream
for the whole batch, so a zoo lane runs one request per run, seeded by the
request's seed (``supports_per_row_keys``), and ``relation`` is refused:
the zoo takes no guidance (``supports_guidance``).  An unconditional zoo request reaches
the sampler with no condition, so MaskGIT and BLT draw its element counts
from the job's aux state, as their sampling CLI does.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from layoutdm_tpu_torch.configs import SamplingConfig
from layoutdm_tpu_torch.data.relations import REL_UNK, pad_edges
from layoutdm_tpu_torch.data.transforms import AddCanvasElement
from layoutdm_tpu_torch.eval.metrics import compute_violation
from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond, timestep_ladder
from layoutdm_tpu_torch.relation.guidance import RelationData, make_relation_guidance
from layoutdm_tpu_torch.tasks import get_cond, to_sampler_cond
from layoutdm_tpu_torch.utils.device import require_device

logger = logging.getLogger(__name__)

COND_TASKS = ("c", "cwh", "partial", "refinement", "relation")

# request-schema names of the bit-encoded relations (`data.relations`
# RelSize / RelLoc values)
_SIZE_REL = {"smaller": 1, "equal": 2, "larger": 3}
_LOC_REL = {"left": 5, "top": 6, "right": 7, "bottom": 8, "center": 9}


def _parse_relations(relations, n_elements: int, max_edges: int):
    """A request's relation list -> padded (edge_index, edge_attr,
    edge_mask) over the canvas-prepended indexing (canvas 0, the request's
    element i at i + 1)."""
    if not isinstance(relations, (list, tuple)):
        raise ValueError("'relations' must be a list of constraint objects")
    if len(relations) > max_edges:
        raise ValueError(f"too many relations: {len(relations)} > max_edges ({max_edges})")
    ei, ea = [], []
    for k, r in enumerate(relations):
        if not isinstance(r, dict):
            raise ValueError(f"relation {k}: expected an object")
        src, dst = r.get("src"), r.get("dst")
        if dst == "canvas":
            raise ValueError(
                f"relation {k}: 'canvas' is only valid as src (constraints "
                "place elements relative to the canvas, not vice versa)"
            )

        def element_index(name, v):
            # check the raw value: -1 must not wrap into the canvas slot
            if not isinstance(v, int) or isinstance(v, bool) or not 0 <= v < n_elements:
                raise ValueError(
                    f"relation {k}: {name} out of range (0..{n_elements - 1} or 'canvas')"
                )
            return v + 1

        si = 0 if src == "canvas" else element_index("src", src)
        di = element_index("dst", dst)
        if si == di:
            raise ValueError(f"relation {k}: src == dst")
        size, loc = r.get("size"), r.get("loc")
        if size is not None and size not in _SIZE_REL:
            raise ValueError(f"relation {k}: unknown size '{size}' (one of {'/'.join(_SIZE_REL)})")
        if loc is not None and loc not in _LOC_REL:
            raise ValueError(f"relation {k}: unknown loc '{loc}' (one of {'/'.join(_LOC_REL)})")
        attr = (1 << (_SIZE_REL[size] if size else 0)) | (1 << (_LOC_REL[loc] if loc else 4))
        if attr == REL_UNK:
            raise ValueError(f"relation {k}: needs 'size' and/or 'loc'")
        ei.append((si, di))
        ea.append(attr)
    return pad_edges(
        np.asarray(ei, np.int32).reshape(-1, 2), np.asarray(ea, np.int32), max_edges
    )


def _row_seeds(seed: int, n: int) -> np.ndarray:
    """Per-row uint32 seeds derived from the request seed (splitmix-style
    mix).  A row's stream depends only on (request seed, row index)."""
    i = np.arange(1, n + 1, dtype=np.uint32)
    x = np.uint32(seed) + i * np.uint32(0x9E3779B9)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


class LayoutHTTPServer(ThreadingHTTPServer):
    """Threaded front with a deep accept backlog."""

    daemon_threads = True
    request_queue_size = 128


class ServiceOverloaded(RuntimeError):
    """Raised when the coalescer queue is full (mapped to HTTP 503)."""


class _Pending:
    """One request's rows queued at the coalescer."""

    __slots__ = ("cond", "seeds", "seed", "event", "result", "error", "sec")

    def __init__(self, cond: SamplerCond, seeds: np.ndarray, seed: int = 0):
        self.cond = cond  # CPU SamplerCond, leading dim = n rows
        self.seeds = seeds  # (n,) uint32
        self.seed = seed  # the request's seed (a zoo run's stream)
        self.event = threading.Event()
        self.result = None  # decoded dict sliced to this request's rows
        self.error = None
        self.sec = 0.0  # wall time of the shared chain run


class LayoutService:
    """Owns the model, its weights and the coalescing device worker."""

    def __init__(
        self,
        job_dir: str,
        max_batch_size: int = 64,
        sampling: Optional[SamplingConfig] = None,
        warm_tasks=("unconditional",),
        timestep_ladder=(),
        coalesce_window_ms: float = 2.0,
        request_timeout_s: float = 600.0,
        max_queued_requests: int = 256,
        device="cuda",
        max_edges: int = 32,
        **switches,
    ):
        """``switches``: the denoiser-path keywords of
        `factory.build_model` (``fused_block``, ``fused_ffn``, ``attn_v2``,
        ``smajor``), which override the environment's switches."""
        from layoutdm_tpu_torch.factory import build_model, build_tokenizer
        from layoutdm_tpu_torch.utils.params import load_aux_state, load_job

        self.train_cfg, state_dict = load_job(job_dir)
        self.train_cfg.data.pad_until_max = True
        self.device = require_device(device)
        self.tokenizer = build_tokenizer(self.train_cfg)
        self.model = build_model(self.train_cfg, self.tokenizer, self.device, **switches)
        self.model.net.load_state_dict(state_dict)
        self.state = load_aux_state(self.model.init_state(), job_dir)
        self.sampling = sampling or SamplingConfig(name="random")
        self.B = int(max_batch_size)
        # allowed per-request num_timesteps values (a bounded set of lanes);
        # diffusion models cannot go past their trained T, the iterative
        # zoo (MaskGIT, BLT) takes any positive step count
        self.ladder = tuple(sorted({int(t) for t in timestep_ladder}))
        T_train = getattr(getattr(self.model, "q", None), "num_timesteps", None)
        for t in self.ladder:
            if t < 1 or (T_train is not None and t > T_train):
                raise ValueError(
                    f"timestep_ladder rung {t} out of range: must satisfy "
                    f"0 < t <= num_timesteps ({T_train}) of the trained model"
                )
        # relation requests: a fixed edge capacity, and one guidance function
        # that reads each run's graphs from its cond
        self.max_edges = int(max_edges)
        self._guidance = make_relation_guidance(self.tokenizer, self.sampling)
        self._counter = 0
        self._counter_lock = threading.Lock()  # handlers run threaded
        self.request_timeout_s = float(request_timeout_s)
        self.max_queued_requests = int(max_queued_requests)
        # models whose sampler takes per-row seeds coalesce requests; a zoo
        # lane runs one request per run
        self._per_row = bool(self.model.supports_per_row_keys)

        self.coalesce_window_ms = float(coalesce_window_ms)
        self._cv = threading.Condition()
        self._queue: List[Tuple[tuple, _Pending]] = []
        self._stop = False
        self.runs = 0  # chain runs (observability + tests)
        self.steps = 0  # reverse steps over all chain runs
        self._worker = threading.Thread(
            target=self._worker_loop, name="device-worker", daemon=True
        )
        self._worker.start()

        dummy_layout = {"label": [0], "bbox": [[0.5, 0.5, 0.2, 0.2]]}
        dummy_rel = [{"src": "canvas", "dst": 0, "loc": "top"}]
        for task in warm_tasks:
            lay = None if task == "unconditional" else dummy_layout
            rel = dummy_rel if task == "relation" else None
            logger.info("warmup: %s", task)
            self.generate(task, min(4, self.B), seed=0, layout=lay, relations=rel)
            for t in self.ladder:
                logger.info("warmup: %s T=%d", task, t)
                self.generate(task, min(4, self.B), seed=0, layout=lay,
                              num_timesteps=t, relations=rel)
        logger.info("service ready (batch=%d, device=%s, denoiser: %s)",
                    self.B, self.device, self.model.denoiser_path)

    # -- coalescing device worker -------------------------------------------
    def _worker_loop(self):
        """The single device thread: drain the queue, packing same-lane
        request row-groups into one padded chain run."""
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(0.05)
                if self._stop:
                    return
                lane = self._queue[0][0]
            if self.coalesce_window_ms > 0:
                # linger so concurrent requests can join this batch
                time.sleep(self.coalesce_window_ms / 1e3)
            with self._cv:
                take, rest, used = [], [], 0
                for ln, p in self._queue:
                    if (ln == lane and used + len(p.seeds) <= self.B
                            and (self._per_row or not take)):
                        take.append(p)
                        used += len(p.seeds)
                    else:
                        rest.append((ln, p))
                self._queue = rest
            if not take:
                continue  # withdrawn (client timeout) between pickup and packing
            try:
                self._run_batch(lane, take)
            except Exception as e:  # reported to every request of the run
                logger.exception("chain run failed")
                for p in take:
                    p.error = e
            finally:
                for p in take:
                    p.event.set()

    def _pad_cond(self, n: int, guided: bool, init_from_seq: bool, has_weak: bool = False):
        """No-op rows that pad a coalesced batch to the run width; the weak
        prior rides as a broadcastable (n, 1, 1) zero unless the lane is
        refinement, and a guided lane's padding rows carry empty graphs."""
        S, V = self.model.seq_len, self.model.num_classes
        wshape = (n, S, V) if has_weak else (n, 1, 1)
        c = SamplerCond.empty(n, S, "cpu")
        c.weak_logits = torch.zeros(wshape)
        c.init_from_seq = init_from_seq
        if guided:
            c.relation = RelationData.empty(n, self.max_edges)
        return c

    def _run_batch(self, lane, pendings: List[_Pending]):
        t_eval, guided, init_from_seq, has_weak = lane
        n_rows = sum(len(p.seeds) for p in pendings)
        conds = [p.cond for p in pendings]
        seeds = [p.seeds for p in pendings]
        if n_rows < self.B:
            conds.append(self._pad_cond(self.B - n_rows, guided, init_from_seq, has_weak))
            seeds.append(np.zeros(self.B - n_rows, np.uint32))
        cond = SamplerCond.cat(conds).to(self.device)
        if self._per_row:
            rng = torch.as_tensor(np.concatenate(seeds).astype(np.int64), device=self.device)
        else:
            # one request per run: its seed keys the whole padded batch
            rng = torch.Generator(device=self.device).manual_seed(pendings[0].seed)
            if not init_from_seq:
                cond = None  # unconditional
        t0 = time.perf_counter()
        ids = self.model.sample_ids(
            rng, self.B, cond=cond, sampling=self.sampling,
            num_timesteps_eval=t_eval, guidance_fn=self._guidance if guided else None,
            state=self.state,
        )
        out = {k: v.cpu().numpy() for k, v in self.tokenizer.decode(ids).items()}
        sec = time.perf_counter() - t0
        self.runs += 1
        if hasattr(self.model, "q"):
            T = self.model.q.num_timesteps
            self.steps += len(timestep_ladder(T, t_eval, self.sampling.time_difference)[0])
        off = 0
        for p in pendings:
            n = len(p.seeds)
            p.result = {k: v[off : off + n] for k, v in out.items()}
            p.sec = sec
            off += n

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=5)

    # -- request handling ----------------------------------------------------
    def _build_cond(self, task: str, layout: Optional[Dict], B: int, relations=None):
        """(task cond on the CPU with B rows, or None for unconditional;
        for "relation", the canvas-prepended labels and padded edges that
        guide the run and score its answer, else None)."""
        if task == "unconditional":
            return None, None
        if layout is None:
            raise ValueError(f"task '{task}' requires a 'layout'")
        label = np.asarray(layout["label"], np.int64)
        if task == "relation" and "bbox" not in layout:
            # relation conditions on the categories alone
            bbox = np.zeros(label.shape + (4,), np.float32)
        else:
            bbox = np.asarray(layout["bbox"], np.float32)
        if label.ndim == 1:
            label, bbox = label[None], bbox[None]
        if bbox.shape != label.shape + (4,):
            raise ValueError(
                f"layout bbox shape {bbox.shape} does not match labels {label.shape}"
            )
        n, S = label.shape[1], self.tokenizer.max_elements
        if n > S:
            raise ValueError(f"too many elements: {n} > {S}")
        pad = S - n
        batch = {
            "label": np.pad(label, ((0, 0), (0, pad))),
            "bbox": np.pad(bbox, ((0, 0), (0, pad), (0, 0))),
            "mask": np.pad(np.ones_like(label, bool), ((0, 0), (0, pad))),
        }
        if label.shape[0] == 1:
            batch = {k: np.repeat(v, B, axis=0) for k, v in batch.items()}
        elif label.shape[0] != B:
            raise ValueError(
                f"layout has {label.shape[0]} rows but batch_size is {B}: "
                "provide ONE layout to broadcast, or exactly batch_size"
            )
        # fixed draws for partial/refinement, like the JAX service's
        # PRNGKey(0): a request's condition does not depend on its seed
        cond = get_cond(
            batch, self.tokenizer, task, generator=torch.Generator().manual_seed(0)
        )
        sc = to_sampler_cond(cond, self.tokenizer, self.sampling)
        if task != "relation":
            return sc, None
        # the canvas-prepended indexing of the training and eval paths
        edges = _parse_relations(relations or [], label.shape[1], self.max_edges)
        graph = {
            "label": AddCanvasElement()(None, dict(batch))["label"],
            **{k: np.repeat(v[None], B, axis=0) for k, v in edges.items()},
        }
        sc.relation = RelationData.from_batch(graph)
        return sc, graph

    def generate(
        self, task: str, batch_size: int, seed: Optional[int], layout,
        num_timesteps: Optional[int] = None, relations=None,
    ) -> Dict:
        if task != "unconditional" and task not in COND_TASKS:
            raise ValueError(
                f"unknown task '{task}' (one of unconditional/{'/'.join(COND_TASKS)})"
            )
        if num_timesteps is not None and (
            not float(num_timesteps).is_integer()
            or int(num_timesteps) not in self.ladder
        ):
            raise ValueError(
                f"num_timesteps {num_timesteps} not in the service ladder "
                f"{list(self.ladder)} (start with timestep_ladder=...)"
            )
        B = min(int(batch_size), self.B)
        if B < 1:
            raise ValueError("batch_size must be >= 1")
        if seed is None:
            with self._counter_lock:
                self._counter += 1
                seed = self._counter
        if task == "relation" and not relations:
            raise ValueError("task 'relation' requires a non-empty 'relations' list")
        if task == "relation" and not self.model.supports_guidance:
            raise ValueError(
                f"model '{self.train_cfg.model.name}' does not support relation "
                "guidance (diffusion-only, like the reference's CLG-LO)"
            )
        seed32 = int(seed) & 0x7FFFFFFF

        has_weak = task == "refinement"
        guided = task == "relation"
        cond, graph = self._build_cond(task, layout, B, relations)
        if cond is None:
            cond = self._pad_cond(B, False, False)
        elif not has_weak:
            cond.weak_logits = torch.zeros((B, 1, 1))
        t_eval = int(num_timesteps) if num_timesteps is not None else None
        lane = (t_eval, guided, bool(cond.init_from_seq), has_weak)

        p = _Pending(cond, _row_seeds(seed32, B), seed32)
        with self._cv:
            if len(self._queue) >= self.max_queued_requests:
                raise ServiceOverloaded(
                    f"queue full ({self.max_queued_requests} requests)"
                )
            self._queue.append((lane, p))
            self._cv.notify_all()
        if not p.event.wait(timeout=self.request_timeout_s):
            with self._cv:
                self._queue = [(ln, q) for ln, q in self._queue if q is not p]
            raise RuntimeError("generation timed out")
        if p.error is not None:
            raise RuntimeError(f"generation failed: {p.error!r}") from p.error
        bbox, label, mask = p.result["bbox"], p.result["label"], p.result["mask"]
        layouts = [
            {
                "label": label[i][mask[i]].tolist(),
                "bbox": np.round(bbox[i][mask[i]], 4).tolist(),
            }
            for i in range(B)
        ]
        resp = {
            "layouts": layouts,
            # wall time of the (possibly shared) run over the full run width
            "ms_per_sample": round(p.sec * 1e3 / self.B, 2),
            "seed": seed32,
        }
        if graph is not None:
            # the share of the requested relations the layouts break
            gen = np.zeros(graph["label"].shape + (4,), np.float32)
            gen[:, 0] = AddCanvasElement.x
            gen[:, 1:] = bbox
            v = compute_violation(gen, graph["label"], graph["edge_index"],
                                  graph["edge_attr"], graph["edge_mask"])
            v = v[~np.isnan(v)]
            resp["violation_rate"] = round(float(v.mean()), 4) if v.size else 0.0
        return resp

    def info(self) -> Dict:
        return {
            "status": "ok",
            "model": self.train_cfg.model.name,
            "dataset": self.train_cfg.dataset.name,
            "device": str(self.device),
            "denoiser": self.model.denoiser_path,
            "max_elements": self.tokenizer.max_elements,
            "max_batch_size": self.B,
            "timestep_ladder": list(self.ladder),
            "max_edges": self.max_edges,
            "coalesce_window_ms": self.coalesce_window_ms,
            "coalescing": self._per_row,
            "program_runs": self.runs,
        }


def make_handler(service: LayoutService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: Dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, service.info())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                out = service.generate(
                    req.get("task", "unconditional"),
                    req.get("batch_size", 1),
                    req.get("seed"),
                    req.get("layout"),
                    req.get("num_timesteps"),
                    req.get("relations"),
                )
                self._send(200, out)
            except ServiceOverloaded as e:
                self._send(503, {"error": str(e)})
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # the server keeps answering
                logger.exception("generate failed")
                self._send(500, {"error": str(e)})

        def log_message(self, fmt, *args):
            logger.info("%s - %s", self.address_string(), fmt % args)

    return Handler


def make_server(argv=None) -> Tuple[LayoutService, LayoutHTTPServer]:
    """Parse ``k=v`` arguments and build the service and its (not yet
    serving) HTTP server."""
    import argparse

    p = argparse.ArgumentParser(
        description="serve: layoutdm_tpu_torch.serve_cli job_dir=<dir> [k=v ...]"
    )
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    kv = dict(o.split("=", 1) for o in a.overrides)
    job_dir = kv.get("job_dir")
    if not job_dir:
        p.error("job_dir=<job directory> is required")
    ladder = tuple(int(t) for t in kv.get("timestep_ladder", "").split(",") if t)
    device = require_device(kv.get("device", "cuda"))
    service = LayoutService(
        job_dir,
        max_batch_size=int(kv.get("max_batch_size", 64)),
        warm_tasks=tuple(t for t in kv.get("warm_tasks", "unconditional").split(",") if t),
        timestep_ladder=ladder,
        coalesce_window_ms=float(kv.get("coalesce_window_ms", 2.0)),
        request_timeout_s=float(kv.get("request_timeout_s", 600.0)),
        max_queued_requests=int(kv.get("max_queued_requests", 256)),
        device=device,
        max_edges=int(kv.get("max_edges", 32)),
    )
    server = LayoutHTTPServer(
        (kv.get("host", "127.0.0.1"), int(kv.get("port", 8700))),
        make_handler(service),
    )
    return service, server


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    service, server = make_server(argv)
    logger.info("listening on :%d", server.server_address[1])
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
