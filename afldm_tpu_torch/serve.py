"""Persistent sampler service for the LDM pipeline. Counterpart of
``afldm_tpu/serve.py``:

- **Cross-request microbatching**: a worker thread drains the request
  queue in windows of ``batch_window_ms``, merges requests with equal step
  counts and right-pads the latents (with the last one) to the next
  power-of-two bucket up to ``max_batch``, so concurrent callers share one
  denoise and one decode on the card.
- **Explicit seeds**: every request carries a seed; its latents come from a
  CPU ``torch.Generator`` seeded with it and are then moved, so one seed
  gives the same image on every device and in every batch.

Front-end: stdlib ``http.server``:

  POST /sample   {"num_images": 1, "num_inference_steps": 50, "seed": 0}
                 -> {"shape": [...], "latency_s": ..., "batched_with": ...,
                     "images_b64": <NHWC .npy of the raw decode>}
  GET  /healthz  -> {"ok": true}
  GET  /stats    -> counters (requests, batches, padded slots, by bucket)

Programmatic use: ``SamplerService.sample(...)`` (thread-safe).
"""

import base64
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


def _next_bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class _Request:
    __slots__ = ("latents", "steps", "event", "result", "t0", "cancelled")

    def __init__(self, latents, steps):
        self.latents = latents
        self.steps = steps
        self.event = threading.Event()
        self.result = None
        self.t0 = time.perf_counter()
        self.cancelled = False


class SamplerService:
    """Batches concurrent ``sample()`` calls onto shared denoise passes."""

    def __init__(self, pipeline, batch_window_ms: float = 5.0,
                 max_batch: int = 16):
        self.pipeline = pipeline
        self.batch_window = batch_window_ms / 1e3
        self.buckets = [b for b in (1, 2, 4, 8, 16) if b <= max_batch]
        self._q = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                      "by_bucket": {}}
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- public API ---------------------------------------------------------

    def _draw(self, num_images: int, seed: int) -> torch.Tensor:
        """The request's initial latents (num_images, C, S, S), on the CPU
        from ``seed``."""
        cfg = self.pipeline.unet.config
        return torch.randn(
            (num_images, cfg.in_channels, cfg.sample_size, cfg.sample_size),
            generator=torch.Generator().manual_seed(seed))

    def sample(self, num_images: int = 1, num_inference_steps: int = 50,
               seed: int = 0, timeout: float = 600.0):
        """Generate images; blocks until the batched result is ready.
        Returns {"images": NHWC numpy (the raw decode), "latency_s",
        "batched_with"}."""
        if num_images > self.buckets[-1]:
            raise ValueError(
                f"num_images={num_images} exceeds max_batch="
                f"{self.buckets[-1]}; split the request")
        req = _Request(self._draw(num_images, seed), int(num_inference_steps))
        self._q.put(req)
        if not req.event.wait(timeout):
            req.cancelled = True  # the worker will skip it
            raise TimeoutError("sampler request timed out")
        if isinstance(req.result, Exception):
            raise req.result
        return req.result

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    # -- worker -------------------------------------------------------------

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first.cancelled:  # the waiter already timed out
                continue
            # drain the window; only requests with equal step counts merge
            batch = [first]
            deadline = time.perf_counter() + self.batch_window
            leftover = []
            while time.perf_counter() < deadline:
                room = self.buckets[-1] - sum(r.latents.shape[0]
                                              for r in batch)
                if room <= 0:
                    break
                try:
                    r = self._q.get(timeout=max(
                        0.0, deadline - time.perf_counter()))
                except queue.Empty:
                    break
                if r.cancelled:
                    continue
                if r.steps == first.steps and r.latents.shape[0] <= room:
                    batch.append(r)
                else:
                    leftover.append(r)
            for r in leftover:
                self._q.put(r)
            batch = [r for r in batch if not r.cancelled]
            if not batch:
                continue
            try:
                self._execute(batch)
            except Exception as e:  # noqa: BLE001 — every waiter gets it
                for r in batch:
                    r.result = e
                    r.event.set()

    def _execute(self, batch):
        lat = torch.cat([r.latents for r in batch])
        n = lat.shape[0]
        bucket = _next_bucket(n, self.buckets)
        if bucket > n:  # right-pad to the bucket size
            lat = torch.cat([lat, lat[-1:].expand(bucket - n, -1, -1, -1)])
        steps = batch[0].steps

        pipe = self.pipeline
        denoised, _ = pipe.denoise(lat.to(pipe.device), steps)
        images = (pipe.decode(denoised)[:n].permute(0, 2, 3, 1).float()
                  .cpu().numpy())

        self.stats["requests"] += len(batch)
        self.stats["batches"] += 1
        self.stats["padded_slots"] += bucket - n
        key = str(bucket)
        self.stats["by_bucket"][key] = self.stats["by_bucket"].get(key, 0) + 1
        off = 0
        for r in batch:
            k = r.latents.shape[0]
            r.result = {
                "images": images[off:off + k],
                "latency_s": time.perf_counter() - r.t0,
                "batched_with": n - k,
            }
            off += k
            r.event.set()


# -- HTTP front-end --------------------------------------------------------------

def _npy_b64(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def make_handler(service: SamplerService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                self._json(200, service.stats)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/sample":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                out = service.sample(
                    num_images=int(req.get("num_images", 1)),
                    num_inference_steps=int(
                        req.get("num_inference_steps", 50)),
                    seed=int(req.get("seed", 0)))
                self._json(200, {
                    "shape": list(out["images"].shape),
                    "latency_s": round(out["latency_s"], 4),
                    "batched_with": out["batched_with"],
                    "images_b64": _npy_b64(out["images"]),
                })
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(pipeline, host: str = "127.0.0.1", port: int = 8763,
          batch_window_ms: float = 5.0, max_batch: int = 16):
    """Returns (server, service); run ``server.serve_forever()`` (on a
    thread when used programmatically) and close both when done."""
    service = SamplerService(pipeline, batch_window_ms=batch_window_ms,
                             max_batch=max_batch)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    return server, service
