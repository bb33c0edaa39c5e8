"""Serving for the PyTorch port: request-coalescing batched inference over
HTTP (port of ``scann_tpu/serve.py``, same HTTP contract).

- ``BatchedPredictor``: a thread-safe front end over a ``Scann``.
  Concurrent callers enqueue structures; the worker coalesces everything
  queued within ``window_ms`` (up to ``max_batch`` structures) into one
  shape-grouped batch. With ``overlap`` (default) a featurizer thread
  prepares batch k+1 (host Voronoi) while the device thread runs batch k,
  through a depth-1 double buffer. Every launch runs on the device thread:
  a batch whose featurization failed goes through the same buffer, marked
  for the per-request fallback. A full pending queue rejects at once
  (``Overloaded``); ``close()`` fails every request still in flight.
- ``PredictionServer``: a stdlib ``ThreadingHTTPServer``:

      POST /predict   {"structures": [{"species": [...], "coords": [[...]],
                                       "lattice": [[...]] | null}, ...]}
                      or, with Content-Type text/plain, a raw (multi-)xyz
                      body or CIF text (one structure per ``data_`` block)
      GET  /healthz   liveness + target name

  Response: {"predictions": [...], "ga_scores": [[...], ...],
             "target": "...", "batch_size": N}. A malformed body or an
  invalid structure is a 400, an oversized body a 413, overload a 503, a
  timeout a 504, anything else a 500.

CLI: ``python -m scann_tpu_torch.cli.serve <model_dir>`` (a training run
directory of this package) or ``--config X.yaml --weights W.h5``.
"""

from __future__ import annotations

import json
import queue
import re
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np

from scann_tpu_torch.data.structure import Structure


class Overloaded(RuntimeError):
    """The pending-request queue is full (HTTP 503 at the server layer)."""


@dataclass
class _Request:
    structs: List[Structure]
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[Tuple[float, np.ndarray]]] = None
    error: Optional[Exception] = None


def _fail(reqs, message: str = "predictor closed") -> None:
    for r in reqs:
        if not r.event.is_set():
            r.error = RuntimeError(message)
            r.event.set()


class BatchedPredictor:
    """Coalesces concurrent prediction requests into device batches.

    ``warmup_shapes`` lists (max_atoms, max_neighbors) shapes whose ladder
    rungs run once before the first request (default: the model's recorded
    ``tpu.observed_buckets``; ``[]`` skips the warmup). ``exec_cache``
    ("auto": ``{model_dir}/exec_cache``, or a directory) points the kernel
    build cache there before the warmup (``Scann.enable_exec_cache``), so a
    process started after one that built the kernels loads them instead."""

    def __init__(self, scann, max_batch: int = 64, window_ms: float = 5.0,
                 max_pending: int = 256, featurize_pool: int = 0,
                 owns_scann: bool = False, canonical_frame: bool = True,
                 warmup_shapes: Optional[List[Tuple[int, int]]] = None,
                 exec_cache: Optional[str] = None, overlap: bool = True):
        self.scann = scann
        self.max_batch = max_batch
        self.window_ms = window_ms
        self.canonical_frame = canonical_frame
        self.owns_scann = owns_scann
        self.featurize_pool = featurize_pool
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_pending)
        self._deferred: Optional[_Request] = None  # worker-thread only
        self._stop = threading.Event()
        if exec_cache is not None:
            scann.enable_exec_cache(None if exec_cache in ("", "auto") else exec_cache)
        if warmup_shapes is None:
            warmup_shapes = [tuple(s) for s in (scann.config.tpu.observed_buckets or [])]
        self.warmed = scann.warmup_serving(warmup_shapes) if warmup_shapes else []
        self.overlap = overlap
        if overlap:
            self._feat_queue: "queue.Queue" = queue.Queue(maxsize=1)
            self._workers = [
                threading.Thread(target=self._run_featurizer, daemon=True,
                                 name="scann-featurizer"),
                threading.Thread(target=self._run_device, daemon=True, name="scann-device"),
            ]
        else:
            self._workers = [threading.Thread(target=self._run, daemon=True,
                                              name="scann-device")]
        for w in self._workers:
            w.start()

    @classmethod
    def from_files(cls, config_path: str, weights_path: str, device="cuda",
                   **kw) -> "BatchedPredictor":
        """A predictor over a config YAML and a Keras H5 checkpoint."""
        from scann_tpu_torch.api import Scann

        return cls(Scann(config_path, pretrained=weights_path, device=device),
                   owns_scann=True, **kw)

    @classmethod
    def from_model_dir(cls, model_dir: str, device="cuda", **kw) -> "BatchedPredictor":
        """A predictor over a training run directory of this package (its
        ``checkpoints/best.pt``, through ``Scann.load_model_infer``); needs
        neither yaml nor h5py."""
        from scann_tpu_torch.api import Scann

        return cls(Scann.load_model_infer(model_dir, device=device), owns_scann=True, **kw)

    # --- client side -----------------------------------------------------

    def predict(self, structs: List[Structure], timeout: float = 120.0):
        """Blocking: [(value, ga_scores)] for the given structures. Raises
        ``Overloaded`` at once when the pending queue is full."""
        req = _Request(structs=structs)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise Overloaded(f"{self._queue.maxsize} requests already pending")
        if not req.event.wait(timeout):
            raise TimeoutError("prediction timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        self._stop.set()
        for w in self._workers:
            w.join(timeout=5)
        # fail fast whatever is still in flight: the request deferred for
        # the next cycle, a featurized batch parked in the double buffer,
        # and requests in the coalescing queue
        stranded: List[_Request] = []
        if self._deferred is not None:
            stranded.append(self._deferred)
            self._deferred = None
        if self.overlap:
            try:
                while True:
                    reqs, _, _ = self._feat_queue.get_nowait()
                    stranded.extend(reqs)
            except queue.Empty:
                pass
        try:
            while True:
                stranded.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        _fail(stranded)
        if self.owns_scann:
            self.scann.close()

    # --- worker side -----------------------------------------------------

    def _drain(self) -> List[_Request]:
        """Block for one request, then coalesce the window's arrivals; a
        request that would overshoot ``max_batch`` waits for the next
        cycle."""
        if self._deferred is not None:
            first, self._deferred = self._deferred, None
        else:
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                return []
        batch = [first]
        n = len(first.structs)
        if n >= self.max_batch:
            return batch
        threading.Event().wait(self.window_ms / 1000.0)
        while n < self.max_batch:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if n + len(req.structs) > self.max_batch:
                self._deferred = req
                break
            batch.append(req)
            n += len(req.structs)
        return batch

    def _fallback_per_request(self, reqs):
        """One bad structure must not fail every coalesced request: retry
        each request alone so only the offending one errors."""
        for r in reqs:
            try:
                r.result = self.scann.predict_structures(
                    r.structs, featurize_pool=self.featurize_pool,
                    canonical_frame=self.canonical_frame)
            except Exception as e:
                r.error = e
            r.event.set()

    @staticmethod
    def _distribute(reqs, results):
        pos = 0
        for r in reqs:
            r.result = results[pos:pos + len(r.structs)]
            pos += len(r.structs)
            r.event.set()

    def _run(self):
        while not self._stop.is_set():
            reqs = self._drain()
            if not reqs:
                continue
            structs = [s for r in reqs for s in r.structs]
            try:
                results = self.scann.predict_structures(
                    structs, featurize_pool=self.featurize_pool,
                    canonical_frame=self.canonical_frame)
            except Exception:
                self._fallback_per_request(reqs)
                continue
            self._distribute(reqs, results)

    def _run_featurizer(self):
        """Stage 1: coalesce + host featurization, handed to the device
        thread through the depth-1 double buffer. A batch that fails to
        featurize is handed over as it is (no inputs): the device thread runs
        its per-request fallback, so no launch runs on this thread."""
        while not self._stop.is_set():
            reqs = self._drain()
            if not reqs:
                continue
            structs = [s for r in reqs for s in r.structs]
            try:
                structs, inputs = self.scann.featurize_structures(
                    structs, featurize_pool=self.featurize_pool,
                    canonical_frame=self.canonical_frame)
            except Exception:
                structs, inputs = None, None
            while not self._stop.is_set():
                try:
                    self._feat_queue.put((reqs, structs, inputs), timeout=0.2)
                    break
                except queue.Full:
                    continue
            else:
                _fail(reqs)  # shutdown raced the hand-off

    def _run_device(self):
        """Stage 2: device execution of featurized batches."""
        while not self._stop.is_set():
            try:
                reqs, structs, inputs = self._feat_queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if inputs is None:          # featurization failed: each request alone
                self._fallback_per_request(reqs)
                continue
            try:
                results = self.scann.predict_featurized(structs, inputs)
            except Exception:
                # isolate the failing request over the featurized inputs
                pos = 0
                for r in reqs:
                    n = len(r.structs)
                    try:
                        r.result = self.scann.predict_featurized(
                            structs[pos:pos + n], inputs[pos:pos + n])
                    except Exception as e:
                        r.error = e
                    pos += n
                    r.event.set()
                continue
            self._distribute(reqs, results)


def _parse_structures(body: bytes, content_type: str) -> List[Structure]:
    if "json" in (content_type or ""):
        payload = json.loads(body)
        out = []
        for s in payload["structures"]:
            lattice = s.get("lattice")
            out.append(Structure(list(s["species"]),
                                 np.asarray(s["coords"], np.float64),
                                 None if lattice is None
                                 else np.asarray(lattice, np.float64)))
        return out
    text = body.decode()
    if "_cell_length_a" in text:        # CIF: one periodic structure per data_ block
        from scann_tpu_torch.data.cif import parse_cif

        blocks = re.split(r"(?m)^(?=data_)", text)
        return [parse_cif(b) for b in blocks if "_cell_length_a" in b]
    lines = text.splitlines()           # raw (multi-)xyz text
    out, i = [], 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].split()[0])
        out.append(Structure.from_xyz_lines(lines[i:i + 2 + n]))
        i += 2 + n
    return out


class PredictionServer:
    """HTTP front end over a BatchedPredictor (stdlib only)."""

    def __init__(self, predictor: BatchedPredictor, host: str = "127.0.0.1",
                 port: int = 8421, max_body_bytes: int = 8 * 1024 * 1024):
        self.predictor = predictor
        self.max_body_bytes = max_body_bytes
        target = predictor.scann.config.hyper.target
        body_limit = max_body_bytes
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok", "target": target})
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": "unknown path"})
                    return
                # parse errors are the client's (400); after a good parse,
                # overload -> 503, timeout -> 504, anything else -> 500
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n < 0:
                        raise ValueError(f"negative Content-Length {n}")
                except ValueError as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                if n > body_limit:
                    self._send(413, {"error": f"request body {n} bytes exceeds "
                                              f"limit {body_limit}"})
                    return
                try:
                    structs = _parse_structures(self.rfile.read(n),
                                                self.headers.get("Content-Type", ""))
                    if not structs:
                        raise ValueError("no structures in request body")
                except Exception as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                try:
                    results = server.predictor.predict(structs)
                    self._send(200, {
                        "predictions": [float(v) for v, _ in results],
                        "ga_scores": [g.tolist() for _, g in results],
                        "target": target,
                        "batch_size": len(structs),
                    })
                except Overloaded as e:
                    self._send(503, {"error": str(e)})
                except TimeoutError as e:
                    self._send(504, {"error": str(e)})
                except Exception as e:
                    self._send(500, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address

    def serve_forever(self):
        print(f"scann-tpu-torch serving on http://{self.host}:{self.port} "
              f"(POST /predict, GET /healthz)")
        self._httpd.serve_forever()

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self.predictor.close()
