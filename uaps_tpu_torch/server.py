"""HTTP serving entry point of the port.

Builds the port's `InferenceEngine` and puts the JAX package's jax-free
`uaps_tpu.server.AsyncBatcher` (dynamic batching) and `serve_http` (POST
/predict with .npy bodies, GET /healthz, GET /stats) in front of it,
unchanged:

    python -m uaps_tpu_torch.server --preset neu --method uaps \
        --dtype bfloat16 --ckpt model.pth [--port 8765] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

from uaps_tpu.server import AsyncBatcher, serve_http
from uaps_tpu_torch.serve import InferenceEngine
from uaps_tpu_torch.utils.cli import parse_args


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
