"""Molecule generation served over HTTP: a checkpoint loaded once, its
reverse chains warm, generation requests answered as JSON
(moldiff_tpu/serve/server.py).

Design for one card:

  * one ``SamplerService`` holds the sampler; one lock serialises all card
    work (concurrent HTTP handlers queue on it: the card is the bottleneck,
    so serialising is the scheduling policy), and handler threads launch
    nothing outside it;
  * warmup runs one short chain per bucket before the port opens: that
    builds the kernel library and makes each kernel's first launch, so the
    first request does not pay for them;
  * the standard library's ``ThreadingHTTPServer``.

The JAX service's ``chunk_steps`` and mesh are left out: they exist for TPU
execution deadlines and sharding (server.py:340-366).

Endpoints:
  GET  /health    -> {status, device, buckets, warm, batch_size, guided}
  GET  /stats     -> request / molecule counters and latency aggregates
  POST /generate  -> body {"num_mols": int, "seed"?: int,
                           "guidance_scale"?: float, "format"?: "smiles"|"sdf"}
                     reply {"smiles": [...], "sdf"?: [...], "num_failed": int,
                            "elapsed_s": float, "seed": int,
                            "coalesced"?: int, "batch_num_failed"?: int}
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..chem.sdf import mol_to_molblock
from ..data.batching import node_mask_from_counts
from ..sample.cli import build_sampler

# warmup's chains: this many respaced steps per bucket
WARMUP_STEPS = 2


class _Pending:
    """One coalescable /generate request waiting for its batch."""

    __slots__ = ("num_mols", "want_sdf", "event", "result", "error")

    def __init__(self, num_mols: int, want_sdf: bool):
        self.num_mols = num_mols
        self.want_sdf = want_sdf
        self.event = threading.Event()
        self.result = None
        self.error = None


def _sdf_blocks(entries: list) -> list:
    return [mol_to_molblock(e["mol"], name=f"mol_{i}") + "$$$$\n"
            for i, e in enumerate(entries)]


class SamplerService:
    """Thread-safe generation around a ready ``MolSampler`` and its params.
    ``max_mols_per_request`` bounds one request's card time.
    ``batch_window_ms`` > 0 coalesces unseeded requests that arrive within
    the window into one pool (one generate call); 0 turns it off."""

    def __init__(self, sampler, params, max_mols_per_request: int = 1024,
                 batch_window_ms: float = 0.0):
        self.sampler = sampler
        self.params = params
        self.device = sampler.model.device
        self.device_name = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        self.max_mols_per_request = int(max_mols_per_request)
        self._lock = threading.Lock()          # all card work
        self._stats_lock = threading.Lock()
        self._seed_counter = 0
        self._warm = set()
        self.stats = {"requests": 0, "batches": 0, "mols_generated": 0, "mols_failed": 0,
                      "errors": 0, "total_generate_s": 0.0, "max_generate_s": 0.0}
        self.batch_window_ms = float(batch_window_ms)
        self._queue = []
        self._cv = threading.Condition()
        self._stop = False
        self._worker = None
        if self.batch_window_ms > 0:
            self._worker = threading.Thread(target=self._batch_worker, daemon=True)
            self._worker.start()

    # -- lifecycle -------------------------------------------------------------

    def warmup(self, logger=None) -> float:
        """One short chain per bucket (WARMUP_STEPS steps, the sampler's
        other settings) before serving. Returns elapsed seconds."""
        t0 = time.time()
        model = self.sampler.model
        kw = self.sampler.chain_kwargs()
        with self._lock:
            for n_bucket in self.sampler.buckets:
                if logger:
                    logger.info(f"warmup: bucket N={n_bucket}")
                counts = np.full(self.sampler.batch_size, min(6, n_bucket), np.int32)
                node_mask = torch.from_numpy(node_mask_from_counts(counts, n_bucket)).to(
                    self.device)
                preds = model.sample(self.params, node_mask, self._generator(0),
                                     num_steps=WARMUP_STEPS, **kw)
                preds.pred_pos.cpu()
                self._warm.add(n_bucket)
        dt = time.time() - t0
        if logger:
            logger.info(f"warmup done in {dt:.1f}s (buckets {list(self.sampler.buckets)})")
        return dt

    def close(self) -> None:
        """Stop the coalescing worker; requests still queued fail."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5)

    # -- request handling --------------------------------------------------------

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _check_num_mols(self, num_mols) -> int:
        num_mols = int(num_mols)
        if num_mols < 1 or num_mols > self.max_mols_per_request:
            raise ValueError(f"num_mols must be in [1, {self.max_mols_per_request}]")
        return num_mols

    def _next_seed(self) -> int:
        seed = 100_000 + self._seed_counter
        self._seed_counter += 1
        return seed

    def _pool(self, num_mols: int, seed: int) -> tuple:
        """(pool, seconds) of one generate call; the caller holds the lock."""
        t0 = time.time()
        pool = self.sampler.generate(self.params, num_mols, self._generator(seed),
                                     rng=np.random.default_rng(int(seed)))
        return pool, time.time() - t0

    def _count(self, requests: int, batches: int, pool: dict, dt: float) -> None:
        with self._stats_lock:
            s = self.stats
            s["requests"] += requests
            s["batches"] += batches
            s["mols_generated"] += len(pool["finished"])
            s["mols_failed"] += len(pool["failed"])
            s["total_generate_s"] += dt
            s["max_generate_s"] = max(s["max_generate_s"], dt)

    def count_error(self) -> None:
        with self._stats_lock:
            self.stats["errors"] += 1

    def generate(self, num_mols: int, seed: Optional[int] = None,
                 guidance_scale: Optional[float] = None, want_sdf: bool = False) -> dict:
        """``num_mols`` finished molecules as a JSON-able dict. Unseeded
        requests take seeds from a service counter, so repeats differ; a
        seed seeds the request's own generator on the card, so one seed
        gives the same molecules."""
        num_mols = self._check_num_mols(num_mols)
        with self._lock:
            if seed is None:
                seed = self._next_seed()
            if guidance_scale is not None:
                self.sampler.set_guidance_scale(float(guidance_scale))
            pool, dt = self._pool(num_mols, seed)
        self._count(1, 0, pool, dt)
        out = {"smiles": [e["smiles"] for e in pool["finished"]],
               "num_failed": len(pool["failed"]), "elapsed_s": round(dt, 3), "seed": int(seed)}
        if want_sdf:
            out["sdf"] = _sdf_blocks(pool["finished"])
        return out

    # -- request coalescing --------------------------------------------------------

    def submit(self, num_mols: int, seed: Optional[int] = None,
               guidance_scale: Optional[float] = None, want_sdf: bool = False) -> dict:
        """The HTTP layer's entry point. Unseeded requests without a scale
        override, while the window is on, are merged with concurrent ones
        into one pool; the rest take :meth:`generate`."""
        if self.batch_window_ms <= 0 or seed is not None or guidance_scale is not None:
            return self.generate(num_mols, seed=seed, guidance_scale=guidance_scale,
                                 want_sdf=want_sdf)
        req = _Pending(self._check_num_mols(num_mols), want_sdf)
        with self._cv:
            if self._stop:
                raise RuntimeError("service closed")
            self._queue.append(req)
            self._cv.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _batch_worker(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=0.1)
                if self._stop:
                    # fail the stragglers rather than leave their threads waiting
                    for r in self._queue:
                        r.error = RuntimeError("service closed")
                        r.event.set()
                    self._queue.clear()
                    return
                batch = [self._queue.pop(0)]
            total = batch[0].num_mols
            deadline = time.time() + self.batch_window_ms / 1000.0
            while total < self.max_mols_per_request:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                with self._cv:
                    if (self._queue and total + self._queue[0].num_mols
                            <= self.max_mols_per_request):
                        r = self._queue.pop(0)
                        batch.append(r)
                        total += r.num_mols
                        continue
                time.sleep(min(0.002, remaining))
            try:
                self._run_batch(batch, total)
            except Exception as e:  # noqa: BLE001 - each request gets the failure
                for r in batch:
                    if not r.event.is_set():
                        r.error = e
                        r.event.set()

    def _run_batch(self, batch: list, total: int) -> None:
        with self._lock:
            seed = self._next_seed()
            pool, dt = self._pool(total, seed)
        self._count(len(batch), 1, pool, dt)
        finished, n_failed = pool["finished"], len(pool["failed"])
        # the pool split in request order
        offset = 0
        for r in batch:
            entries = finished[offset:offset + r.num_mols]
            offset += r.num_mols
            out = {"smiles": [e["smiles"] for e in entries],
                   "num_failed": r.num_mols - len(entries), "elapsed_s": round(dt, 3),
                   "seed": int(seed), "coalesced": len(batch), "batch_num_failed": n_failed}
            if r.want_sdf:
                out["sdf"] = _sdf_blocks(entries)
            r.result = out
            r.event.set()

    def health(self) -> dict:
        return {"status": "ok", "device": self.device_name,
                "buckets": list(self.sampler.buckets), "warm": sorted(self._warm),
                "batch_size": self.sampler.batch_size,
                "guided": self.sampler.guidance is not None}


def build_service_from_checkpoint(
        ckpt_path: str, bond_ckpt_path: Optional[str] = None, guidance: Optional[tuple] = None,
        use_ema: bool = False, batch_size: int = 128, buckets=None,
        max_mols_per_request: int = 1024, guidance_interval: int = 1,
        num_steps: Optional[int] = None, pos_sampler: str = "ddpm", eta: float = 0.0,
        batch_window_ms: float = 0.0, commit: str = "nodes",
        device=None) -> SamplerService:
    """A checkpoint (and optionally a bond predictor's) -> a service, the
    model built as the sample CLI builds it (server.py:298-380). The
    default ``commit`` is "nodes", the JAX service's; "none" is the
    reference-exact posterior. ``device``: the card unless "cpu"."""
    from ..models.moldiff import resolve_device

    device = resolve_device(device)
    settings = {"use_ema": use_ema, "guidance": guidance,
                "guidance_interval": guidance_interval, "num_steps": num_steps,
                "pos_sampler": pos_sampler, "eta": eta, "commit": commit,
                "buckets": buckets}
    sampler, params = build_sampler(ckpt_path, settings, device, batch_size=batch_size,
                                    bond_predictor=bond_ckpt_path)
    return SamplerService(sampler, params, max_mols_per_request=max_mols_per_request,
                          batch_window_ms=batch_window_ms)


def make_http_server(service: SamplerService, host: str = "127.0.0.1", port: int = 8000,
                     logger=None) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server: ``.serve_forever()`` runs it,
    ``.shutdown()`` stops it. Port 0 takes a free port (``server_port``).
    ``logger``: a ``logging.Logger`` or None."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            if logger:
                logger.info("http: " + fmt % args)

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, service.health())
            elif self.path == "/stats":
                with service._stats_lock:
                    stats = dict(service.stats)
                stats["avg_generate_s"] = round(
                    stats["total_generate_s"] / max(stats["requests"], 1), 3)
                self._reply(200, stats)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                out = service.submit(num_mols=req.get("num_mols", 1), seed=req.get("seed"),
                                     guidance_scale=req.get("guidance_scale"),
                                     want_sdf=req.get("format") == "sdf")
                self._reply(200, out)
            except ValueError as e:
                service.count_error()
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - the server answers and lives on
                service.count_error()
                if logger:
                    logger.exception("generate failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)
