"""Times of the neu steps and the serving forward, eager and graphed, for
comparing two checkouts on one card.

    python3 uaps_tpu_torch/step_times.py [ROOT]

imports `uaps_tpu_torch` from the checkout at ROOT (default: the one that
holds this file), builds its kernel libraries and prints one JSON line of
ms, each the median over ROUNDS rounds (min and max beside it) on the
host's clock with a sync after each call:
  * `uaps_eager`, `baseline_eager`: one eager step of the neu UAPS step
    (`python -m uaps_tpu_torch.train --preset neu --method uaps --dtype
    bfloat16 --dataset synthetic`, 16 + 16 images at 256 x 256) and of the
    baseline step, sampling from device pools; `uaps_eager_host`: the
    host's time to enqueue one eager UAPS step while the card is still
    busy with the previous ones (no sync inside a round of REPS steps);
  * `uaps_graph`, `baseline_graph`: a step of a CUDA graph of 4 steps
    (`dispatch.GraphedSteps`), which runs no Python per step;
  * `predict`: `InferenceEngine.predict_device` of a batch of 16 on the
    neu unet_uaps bf16 engine (the serving forward).
The card's name and power limit come from nvidia-smi. Run it for each
checkout in turns within one call (A, B, B, A): the host's clock there is
noisy, and a card's power limit moves every time.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROUNDS, REPS = 5, 4
SEED = 1234


def _rounds(torch, fn, sync_each=True):
    """{median, min, max} over ROUNDS of the mean ms of REPS fn() calls."""
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
            if sync_each:
                torch.cuda.synchronize()
        got.append((time.perf_counter() - t0) * 1e3 / REPS)
        torch.cuda.synchronize()
    return {"median": statistics.median(got), "min": min(got),
            "max": max(got)}


def main(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("step_times: no CUDA card")
    from uaps_tpu_torch import dispatch
    from uaps_tpu_torch.data import SyntheticDefects
    from uaps_tpu_torch.data.device_pool import PoolSampler
    from uaps_tpu_torch.kernels import _build
    from uaps_tpu_torch.methods import get_method
    from uaps_tpu_torch.serve import InferenceEngine
    from uaps_tpu_torch.utils.cli import parse_args
    if not _build.__file__.startswith(root):
        raise SystemExit(f"step_times: imported {_build.__file__}, not "
                         f"{root}")
    _build.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"root": root, "card": smi}
    for name in ("uaps", "baseline"):
        cfg, _ = parse_args(["--preset", "neu", "--method", name, "--dtype",
                             "bfloat16", "--dataset", "synthetic"])
        data = SyntheticDefects(cfg.data, seed=SEED, labeled_pool=16,
                                unlabeled_pool=48)
        sampler = PoolSampler(data, cfg.data.batch_size, SEED, dev)
        sampler.start_epoch(1)
        method = get_method(name)
        state, model = method.init_state(
            cfg, dev, torch.Generator().manual_seed(SEED))
        step = method.make_train_step(cfg, model)

        def eager():
            step(state, sampler.sample())

        out[f"{name}_eager"] = _rounds(torch, eager)
        if name == "uaps":
            out["uaps_eager_host"] = _rounds(torch, eager, sync_each=False)
        graphed = dispatch.GraphedSteps(step, dispatch.AUTO_STEPS_CUDA, dev,
                                        sampler)
        graphed(state)      # its eager steps, then the capture
        g = _rounds(torch, lambda: graphed(state))
        out[f"{name}_graph"] = {k: v / dispatch.AUTO_STEPS_CUDA
                                for k, v in g.items()}
        del state, model, step, graphed, sampler, data
        torch.cuda.empty_cache()
    cfg, _ = parse_args(["--preset", "neu", "--method", "uaps", "--dtype",
                         "bfloat16"])
    from uaps_tpu_torch.methods.base import build_model
    engine = InferenceEngine(cfg, state_dict=build_model(
        cfg, "cpu", torch.Generator().manual_seed(SEED)).state_dict(),
        device=dev)
    x = torch.randn((16, *cfg.data.image_size, 3), device=dev)
    out["predict"] = _rounds(torch, lambda: engine.predict_device(x))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else
         os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
