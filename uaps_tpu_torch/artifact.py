"""The deployable export artifact: one file that predicts without the model,
config or checkpoint code (the port's counterpart of the JAX package's
`jax.export` artifact, uaps_tpu/serve.py:111-139 and :181-215).

Layout, as JAX's: 8 bytes of little-endian header length, the JSON header,
then the program. JAX's header keys (batch_size, image_size, in_channels,
mean, std, num_classes, model) keep JAX's values; the port adds `device`
and `dtype` (the device type and compute dtype it was exported with) and
`ops_module`, the module that registers the `uaps::` operators the program
calls. The program is `torch.export.save` of an exported module that maps
one f32 NHWC batch [batch_size, H, W, C] to (int32 masks [B, H, W], f32
probs [B, H, W, classes]), the weights baked in
(`serve.InferenceEngine.export` writes it).

`ExportedEngine(path, device="cuda")` loads it with torch and
`ops_module` alone: this module imports nothing else of the package. On
the card the program's `uaps::` nodes launch the hand-written kernels (the
operators' CUDA implementations); a program exported on one device type
runs on another after `torch.export.passes.move_to_device_pass`.

    python -m uaps_tpu_torch.serve --preset neu --method uaps \
        --ckpt RUN_DIR --export model.uapsexport [--tta] [--device cuda]
    masks, probs = ExportedEngine("model.uapsexport").predict(images_u8)
"""
from __future__ import annotations

import importlib
import io
import json
from typing import Tuple

import numpy as np
import torch

OPS_MODULE = "uaps_tpu_torch.kernels.custom_ops"


def write(path: str, header: dict,
          program: torch.export.ExportedProgram) -> int:
    """Write the artifact; returns its size in bytes."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    head = json.dumps({**header, "ops_module": OPS_MODULE}).encode()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        f.write(blob)
    return 8 + len(head) + len(blob)


def read(path: str) -> Tuple[dict, bytes]:
    """(header, program bytes) of an artifact."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        return json.loads(f.read(n).decode()), f.read()


class ExportedEngine:
    """Load and run an `InferenceEngine.export()` artifact: the same
    `predict` contract as JAX's (uint8 or normalised f32 NHWC batches in,
    int32 masks and f32 probs out, numpy), with neither checkpoints nor
    configs nor the model zoo. Runs on the card unless `device` says
    otherwise."""

    def __init__(self, path: str, device="cuda"):
        self.meta, blob = read(path)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is "
                               "not available")
        importlib.import_module(self.meta["ops_module"])   # the uaps:: ops
        program = torch.export.load(io.BytesIO(blob))
        if self.device.type != self.meta["device"]:
            from torch.export.passes import move_to_device_pass
            program = move_to_device_pass(program, self.device)
        self._program = program.module()
        self.batch_size = self.meta["batch_size"]

    def _normalize(self, images: np.ndarray) -> np.ndarray:
        """uint8 -> (x - 255 mean) / (255 std) in f32 (JAX serve.py:195-200);
        float input is taken as already normalised."""
        if images.dtype == np.uint8:
            mean = np.asarray(self.meta["mean"], np.float32) * 255.0
            std = np.asarray(self.meta["std"], np.float32) * 255.0
            return (images.astype(np.float32) - mean) / std
        return images.astype(np.float32)

    def predict_device(self, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One normalised batch of batch_size on the device -> (masks,
        probs) on the device."""
        with torch.no_grad():
            return self._program(x)

    def predict(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """images [N, H, W, C] -> (masks [N, H, W] int32, probs [N, H, W,
        classes] f32); the last micro-batch padded by repeating its last
        image."""
        x = self._normalize(images)
        bs = self.batch_size
        masks, probs = [], []
        for i in range(0, x.shape[0], bs):
            chunk = x[i:i + bs]
            n = chunk.shape[0]
            if n < bs:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], bs - n, axis=0)])
            m, p = self.predict_device(torch.from_numpy(
                np.ascontiguousarray(chunk)).to(self.device))
            masks.append(m[:n].cpu().numpy())
            probs.append(p[:n].cpu().numpy())
        return np.concatenate(masks), np.concatenate(probs)
