"""Dynamic-batching server and HTTP entry point of the port.

The port's own copy of `uaps_tpu/server.py` (`AsyncBatcher`, `serve_http`),
with the same behaviour and the same HTTP surface, in front of the port's
`InferenceEngine`:

    python -m uaps_tpu_torch.server --preset neu --method uaps \
        --dtype bfloat16 --ckpt model.pth [--port 8765] [--device cuda]

One dispatcher thread owns the device. Requests arrive on a queue as
(image, Future); the dispatcher drains up to `max_batch` of them (waiting at
most `max_wait_ms` after the first), runs one `engine.predict` (which pads
to the engine's fixed batch), and resolves the futures.

    batcher = AsyncBatcher(engine)             # engine: InferenceEngine
    fut = batcher.submit(img_u8)               # [H,W,C] -> Future
    mask, probs = fut.result()
    batcher.stats()                            # p50/p99/mean, occupancy

HTTP (stdlib only):
    POST /predict   body: .npy bytes of [H,W,C] uint8 (or [N,H,W,C])
                    resp: .npy bytes of [H,W] ([N,H,W]) int32 mask
    GET  /healthz   200 "ok"
    GET  /stats     JSON latency/throughput/occupancy counters
"""
from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from uaps_tpu_torch.serve import InferenceEngine
from uaps_tpu_torch.utils.cli import parse_args


class AsyncBatcher:
    """Dynamic-batching dispatcher over a fixed-batch InferenceEngine."""

    def __init__(self, engine, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_batch = max_batch or engine.batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        # entries: (image, future, enqueue_time)
        self._q: "queue.Queue[Tuple[np.ndarray, Future, float]]" = \
            queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # bounded: a long-lived server must not grow its stats forever
        self._lat: "deque[float]" = deque(maxlen=10000)  # per-request s
        self._occ: "deque[int]" = deque(maxlen=10000)    # batch occupancy
        self._n_done = 0
        self._shape: Optional[tuple] = None   # pinned by first submit
        self._t_start = time.perf_counter()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="uaps-batcher")
        self._thread.start()

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one [H,W,C] image; the Future resolves to (mask, probs).

        All images of one batcher share a shape; a mismatched request is
        rejected here so that it never poisons the batch it would have
        joined."""
        if self._stop.is_set():
            raise RuntimeError("batcher is shut down")
        image = np.asarray(image)
        # check-then-set under the lock: ThreadingHTTPServer calls submit()
        # from many threads
        with self._lock:
            if self._shape is None:
                self._shape = image.shape
            elif image.shape != self._shape:
                raise ValueError(
                    f"image shape {image.shape} != batcher shape "
                    f"{self._shape}; one shape per batcher")
        fut: Future = Future()
        self._q.put((image, fut, time.perf_counter()))
        return fut

    def predict(self, image: np.ndarray,
                timeout: Optional[float] = None):
        """Synchronous convenience wrapper around submit()."""
        return self.submit(image).result(timeout=timeout)

    def shutdown(self, wait: bool = True):
        self._stop.set()
        if wait:
            self._thread.join(timeout=10.0)
        # fail any straggler requests instead of hanging their callers
        while True:
            try:
                _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("batcher shut down"))

    def stats(self) -> dict:
        with self._lock:
            lat = np.asarray(self._lat, np.float64)
            occ = np.asarray(self._occ, np.float64)
            n, dt = self._n_done, time.perf_counter() - self._t_start
        out = {"requests": int(n),
               "throughput_rps": n / dt if dt > 0 else 0.0,
               "dispatches": int(occ.size)}
        if lat.size:
            out.update(p50_ms=float(np.percentile(lat, 50) * 1e3),
                       p99_ms=float(np.percentile(lat, 99) * 1e3),
                       mean_ms=float(lat.mean() * 1e3))
        if occ.size:
            out["mean_batch_occupancy"] = float(occ.mean())
        return out

    def _drain(self):
        """Block for the first request, then coalesce up to max_batch."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return None
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            try:
                # stack inside the try: a failure resolves the batch's
                # futures and leaves the dispatcher alive
                images = np.stack([b[0] for b in batch])
                masks, probs = self.engine.predict(images)
            except Exception as exc:  # surface to every waiting caller
                for _, fut, _ in batch:
                    if not fut.done():
                        fut.set_exception(exc)
                continue
            now = time.perf_counter()
            with self._lock:
                self._occ.append(len(batch))
                for i, (_, fut, t0) in enumerate(batch):
                    self._lat.append(now - t0)
                    self._n_done += 1
                    fut.set_result((masks[i], probs[i]))


def _make_handler(batcher: AsyncBatcher):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):        # quiet; stats has the numbers
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                self._send(200, json.dumps(batcher.stats()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
            except Exception as exc:
                self._send(400, f"bad .npy body: {exc}".encode(),
                           "text/plain")
                return
            single = arr.ndim == 3
            imgs = arr[None] if single else arr
            futs = [batcher.submit(im) for im in imgs]
            try:
                masks = np.stack([f.result(timeout=60.0)[0] for f in futs])
            except Exception as exc:
                self._send(500, str(exc).encode(), "text/plain")
                return
            buf = io.BytesIO()
            np.save(buf, masks[0] if single else masks)
            self._send(200, buf.getvalue(), "application/octet-stream")

    return Handler


def serve_http(batcher: AsyncBatcher, port: int = 8765,
               host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start the HTTP front; returns the (running) server object."""
    srv = ThreadingHTTPServer((host, port), _make_handler(batcher))
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="uaps-http")
    t.start()
    return srv


def main(argv=None):
    cfg, _ = parse_args(argv)
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True, help=".pth checkpoint")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    extra, _ = p.parse_known_args(argv)
    engine = InferenceEngine.from_torch(cfg, extra.ckpt, device=extra.device)
    batcher = AsyncBatcher(engine, max_wait_ms=extra.max_wait_ms)
    srv = serve_http(batcher, extra.port, extra.host)
    print(f"serving on http://{extra.host}:{srv.server_address[1]} "
          f"(batch {batcher.max_batch}, wait {extra.max_wait_ms} ms, "
          f"{engine.device})", flush=True)
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        batcher.shutdown()


if __name__ == "__main__":
    main()
