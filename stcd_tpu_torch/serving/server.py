"""Micro-batching HTTP inference server (counterpart of
stcd_tpu/serving/server.py).

- ONE batcher thread assembles the device batches and issues them to each
  device's replica of the model in turn (``serving/replicas.py``), under
  ``torch.inference_mode()``; HTTP handler threads only decode images,
  enqueue tiles and wait on futures.
- Fixed device batch ``batch``, zero-padded when short, so every step runs
  one shape. Over D devices each step cuts it into D contiguous slices of
  ``batch / D`` rows, one a replica, as the JAX server's ``sharding`` over
  the mesh's ``data`` axis does; the step ends when every device has
  answered, and a failure on any device fails the whole batch.
- Cross-request tile batching: each request's scene is tiled, tiles of
  concurrent requests share device batches, and each request's
  probabilities are stitched back with overlap averaging.
- ``max_wait_ms`` bounds the latency the batcher adds while it waits to
  fill a batch.

Endpoints (stdlib http.server, JSON/base64), with the JAX server's payloads:

- ``POST /predict`` body {"image_a": <b64 png/jpeg>, "image_b": ...,
  ["threshold": 0.5]} -> {"mask_png", "changed", "shape", "latency_ms"}
- ``GET /healthz`` -> {"status": "ok", "tile", "batch"}
- ``GET /stats`` -> request/batch counters, mean batch occupancy, the
  p50/p90/p99 of ``request_latency_ms`` and ``step_ms``, and
  ``mesh_sharded`` (more than one device), ``devices`` and ``quantized``.
"""

from __future__ import annotations

import base64
import collections
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence, Union

import numpy as np

from stcd_tpu_torch.data.tiled_inference import extract_tiles, stitch_tiles
from stcd_tpu_torch.serving.replicas import Replicas


class BatchingEngine:
    """Batches (tile_a, tile_b) pairs from many callers into fixed-size
    device steps over ``predict_fn(a, b) -> probs``: NHWC tensors on
    ``device`` in, (B, t, t, C) probabilities out. ``device`` defaults to the
    card; without one the constructor raises (pass ``"cpu"`` to run there).

    ``devices``, a list of D devices, takes the place of ``device``; then
    ``predict_fn`` is a list of D functions, one replica of the model on each
    device (``cli.predict.make_replicas``), and each step splits the batch by
    rows over them. ``batch`` must divide by D: the constructor raises
    otherwise, as the JAX server does for its sharded axis. ``quantized``
    only sets the /stats flag."""

    def __init__(self, predict_fn: Union[Callable, Sequence[Callable]], tile: int = 256,
                 stride: Optional[int] = None, batch: int = 8,
                 max_wait_ms: float = 5.0, timeout_s: float = 120.0,
                 device="cuda", devices: Optional[Sequence] = None,
                 quantized: bool = False):
        fns = list(predict_fn) if isinstance(predict_fn, (list, tuple)) else [predict_fn]
        devices = list(devices) if devices is not None else [device]
        if batch % len(devices):
            raise ValueError(f"batch={batch} does not divide across the {len(devices)} "
                             f"devices {[str(d) for d in devices]} (tile={tile})")
        self.tile = tile
        self.stride = stride or tile
        self.batch = batch
        self.quantized = bool(quantized)
        self._replicas = Replicas(fns, devices)
        self.devices = self._replicas.devices
        self.max_wait_s = max_wait_ms / 1e3
        self.timeout_s = timeout_s
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "tiles": 0, "batches": 0,
                      "batch_tiles": 0, "errors": 0}
        self._req_lat_ms: collections.deque = collections.deque(maxlen=2048)
        self._step_ms: collections.deque = collections.deque(maxlen=2048)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="stcd-serving-batcher")
        self._thread.start()

    # --- caller side -----------------------------------------------------
    def predict_pair(self, image_a: np.ndarray, image_b: np.ndarray) -> np.ndarray:
        """Full-scene change probabilities (H, W, C) for one request."""
        if image_a.shape != image_b.shape:
            raise ValueError(f"scene shapes differ: {image_a.shape} vs "
                             f"{image_b.shape}")
        if min(image_a.shape[:2]) < self.tile:
            raise ValueError(f"scene {image_a.shape[:2]} smaller than the "
                             f"server tile {self.tile}")
        t0 = time.monotonic()
        tiles_a, origins = extract_tiles(image_a, self.tile, self.stride)
        tiles_b, _ = extract_tiles(image_b, self.tile, self.stride)
        futs = []
        # enqueue under the lock: close() drains the queue under the same
        # lock after setting _stop, so no request slips tiles past the drain
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("serving engine closed")
            for ta, tb in zip(tiles_a, tiles_b):
                fut: Future = Future()
                self._q.put((ta, tb, fut))
                futs.append(fut)
            self.stats["requests"] += 1
            self.stats["tiles"] += len(futs)
        probs = np.stack([f.result(timeout=self.timeout_s) for f in futs])
        out = stitch_tiles(probs, origins, image_a.shape[:2])
        with self._lock:
            self._req_lat_ms.append((time.monotonic() - t0) * 1e3)
        return out

    def warm(self) -> None:
        """Run one zero batch on every device, outside the counters: each
        replica meets its one batch shape before traffic does."""
        z = np.zeros((self.batch, self.tile, self.tile, 3), np.float32)
        self._replicas.run(z, z)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        # fail anything still queued rather than leave callers waiting
        with self._lock:
            while True:
                try:
                    _, _, fut = self._q.get_nowait()
                except queue.Empty:
                    break
                fut.set_exception(RuntimeError("serving engine closed"))

    # --- batcher thread ---------------------------------------------------
    def _take_batch(self):
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return None
        items = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(items) < self.batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _loop(self):
        while not self._stop.is_set():
            items = self._take_batch()
            if items:
                self._step(items)

    def _step(self, items):
        t0 = time.monotonic()
        try:
            # batch assembly inside the try: a malformed tile fails these
            # futures instead of killing the batcher thread
            pad = self.batch - len(items)
            a = np.stack([it[0] for it in items])
            b = np.stack([it[1] for it in items])
            if pad:
                zeros = np.zeros((pad,) + a.shape[1:], a.dtype)
                a = np.concatenate([a, zeros])
                b = np.concatenate([b, zeros])
            probs = self._replicas.run(a, b)
        except Exception as exc:  # surface device/assembly errors to callers
            with self._lock:
                self.stats["errors"] += 1
            for _, _, fut in items:
                fut.set_exception(exc)
            return
        with self._lock:
            self.stats["batches"] += 1
            self.stats["batch_tiles"] += len(items)
            self._step_ms.append((time.monotonic() - t0) * 1e3)
        for (_ta, _tb, fut), p in zip(items, probs):
            fut.set_result(p)

    def stats_snapshot(self) -> dict:
        """Counters + mean batch occupancy + latency percentiles (the
        /stats payload)."""
        def pct(window):
            if not window:
                return {}
            v = np.sort(np.asarray(window, np.float64))
            at = lambda q: float(v[min(len(v) - 1, int(q * len(v)))])  # noqa: E731
            return {"p50": round(at(0.50), 1), "p90": round(at(0.90), 1),
                    "p99": round(at(0.99), 1), "n": len(v)}

        with self._lock:
            s = dict(self.stats)
            req_lat = pct(self._req_lat_ms)
            step = pct(self._step_ms)
        s["mean_batch_occupancy"] = (
            s["batch_tiles"] / (s["batches"] * self.batch) if s["batches"] else 0.0)
        s["request_latency_ms"] = req_lat
        s["step_ms"] = step
        s["mesh_sharded"] = len(self.devices) > 1
        s["quantized"] = self.quantized
        s["devices"] = len(self.devices)
        return s


def _decode_image(b64: str) -> np.ndarray:
    from PIL import Image
    img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def _encode_mask(mask01: np.ndarray) -> str:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray((mask01 * 255).astype(np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def make_handler(engine: BatchingEngine, default_threshold: float = 0.5):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet (ops read /stats)
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
                self._send(200, {"status": "ok", "tile": engine.tile,
                                 "batch": engine.batch})
            elif self.path == "/stats":
                self._send(200, engine.stats_snapshot())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            t0 = time.monotonic()
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                a = _decode_image(req["image_a"])
                b = _decode_image(req["image_b"])
                thr = float(req.get("threshold", default_threshold))
                probs = engine.predict_pair(a, b)
                mask = (probs[..., 0] > thr).astype(np.float32)
                self._send(200, {
                    "mask_png": _encode_mask(mask),
                    "changed": float(mask.mean()),
                    "shape": list(mask.shape),
                    "latency_ms": round((time.monotonic() - t0) * 1e3, 1),
                })
            except (KeyError, ValueError, json.JSONDecodeError) as exc:
                self._send(400, {"error": str(exc)})
            except Exception as exc:  # device/engine failure
                self._send(500, {"error": str(exc)})

    return Handler


def serve(engine: BatchingEngine, host: str = "127.0.0.1", port: int = 8475,
          threshold: float = 0.5) -> ThreadingHTTPServer:
    """Create (not start) the HTTP server; call .serve_forever() to run."""
    return ThreadingHTTPServer((host, port), make_handler(engine, threshold))
