"""Batched inference engine: the port's `uaps_tpu/serve.py`.

    engine = InferenceEngine.from_torch(cfg, "model.pth", device="cuda")
    masks, probs = engine.predict(images_u8)   # numpy in, numpy out

`predict` keeps the JAX contract (serve.py:142-169): uint8 NHWC images are
normalised as (x / 255 - mean) / std in f32 (float input is taken as
already normalised), cut into micro-batches of `batch_size` with the last
one padded by repeating its last image, run through the main decoder (a
deep-supervision net's forward gives its dp0 head, as JAX's `_forward`
takes `out["dp0"]`), softmaxed in f32 and argmaxed; it returns int32
masks [N, H, W] and f32 probs [N, H, W, C]; with `tta` the probs are the
mean softmax over the 4 H/V flips (`ops/tta.py`, JAX serve.py:77-82), or,
for a BaseNet, its multi-scale flip sum divided by its sum over the
classes (models/resnet.py, JAX serve.py:77-79).
`uncertainty` (serve.py:171-178) returns the main decoder's KL map
against the mean of every decoder's softmax, the aux decoders seeing
perturbed features. For concurrent traffic, `uaps_tpu_torch.server` puts
its `AsyncBatcher` and HTTP front in front of this engine.

Weights come from a `.pth` (a reference checkpoint, one written by the
port's trainer, or JAX weights written by the JAX package's `save_pth`) or
from a state dict.

The directory CLI (JAX serve.py:218-283) predicts every image of a
directory:

    python -m uaps_tpu_torch.serve --preset neu --method uaps \
        --images DIR --out DIR [--ckpt RUN_DIR | --torch_ckpt PTH] \
        [--uncertainty] [--tta] [--device cuda]

Each file OpenCV decodes (in name order; others are skipped) is resized
to the preset's image size with nearest, and the predictions go to
`<stem>_mask.png` (the class of each pixel), `<stem>_viz.png` (the NEU
palette, utils/viz.py) and, with `--uncertainty`, `<stem>_uncert.png`
(the KL map scaled to 255, JET). `--ckpt` is a run directory of the
port's Trainer (its best checkpoint by val mDice), by default
`out_dir/checkpoints`. It prints the count and images/s of the
prediction.

`InferenceEngine.export(path)` writes the deployable artifact
(uaps_tpu_torch/artifact.py: JAX's container around a `torch.export`
program of `predict_device`, TTA included, the weights baked in), and
`ExportedEngine(path, device="cuda")` (re-exported here) runs it with torch
and the kernels' operators alone. `--export PATH` on the CLI writes it,
prints its path and size and exits (JAX serve.py:245-249).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from uaps_tpu_torch import artifact
from uaps_tpu_torch.artifact import ExportedEngine  # noqa: F401 (public)
from uaps_tpu_torch.data.augment import cv2, normalize
from uaps_tpu_torch.methods.base import build_model, resolve_device
from uaps_tpu_torch.ops import kl_divergence_map
from uaps_tpu_torch.ops.tta import flip_tta_softmax
from uaps_tpu_torch.utils.weights import load_pth, load_state_dict


def uncertainty_map(model: torch.nn.Module, x: torch.Tensor
                    ) -> torch.Tensor:
    """A normalised NHWC batch on the model's device -> its KL maps [B, H,
    W]: the main decoder against the mean of every decoder's softmax, from
    the eval-mode forward with perturbations drawn from a generator seeded
    0 for every batch (JAX: rngs key(0)); zeros for a single-output
    model."""
    with torch.inference_mode():
        gen = torch.Generator(device=x.device).manual_seed(0)
        out = model(x, gen)
        outs = out if isinstance(out, tuple) else (out,)
        if len(outs) < 2:
            return torch.zeros(x.shape[:3], device=x.device)
        preds = sum(torch.softmax(o, -1) for o in outs) / len(outs)
        return kl_divergence_map(outs[0], preds)


class _Predictor(torch.nn.Module):
    """An engine's `predict_device` as a module (the exported program): one
    normalised NHWC batch -> (int32 masks, f32 probs)."""

    def __init__(self, engine: "InferenceEngine"):
        super().__init__()
        self.model = engine.model
        self._probs = engine._probs

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        probs = self._probs(x)
        return torch.argmax(probs, dim=-1).to(torch.int32), probs


class InferenceEngine:
    """Fixed-batch predictor over the main decoder, with the padding
    micro-batcher."""

    def __init__(self, cfg, ckpt: Optional[str] = None,
                 state_dict: Optional[dict] = None,
                 batch_size: Optional[int] = None, device="cuda",
                 tta: bool = False):
        if (ckpt is None) == (state_dict is None):
            raise ValueError("pass exactly one of ckpt (.pth path) and "
                             "state_dict")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = batch_size or cfg.data.batch_size
        model = build_model(cfg, "cpu")
        if ckpt is not None:
            load_pth(model, ckpt)
        else:
            load_state_dict(model, state_dict)
        self.model = model.to(self.device).eval()
        self._forward = getattr(self.model, "main_only", self.model)
        self.tta = tta
        self.basenet = cfg.model.name.startswith("basenet")

    @classmethod
    def from_torch(cls, cfg, pth_path: str, **kw) -> "InferenceEngine":
        """Serve a reference (or `save_pth`) .pth checkpoint."""
        return cls(cfg, ckpt=pth_path, **kw)

    def export(self, path: str) -> int:
        """Write the deployable artifact of `predict_device` at batch_size
        (artifact.py): `torch.export` under no_grad of one f32 NHWC batch
        -> (masks, probs), TTA included, the weights and the models'
        interpolation matrices baked in (a predict first fills those
        caches, so they export as constants). Returns its size in bytes."""
        h, w = self.cfg.data.image_size
        x = torch.zeros((self.batch_size, h, w, self.cfg.data.in_channels),
                        device=self.device)
        self.predict_device(x)
        with torch.no_grad():
            program = torch.export.export(_Predictor(self), (x,),
                                          strict=False)
        d = self.cfg.data
        return artifact.write(path, {
            "batch_size": self.batch_size, "image_size": [h, w],
            "in_channels": d.in_channels, "mean": list(d.mean),
            "std": list(d.std), "num_classes": d.num_classes,
            "model": self.cfg.model.name, "device": self.device.type,
            "dtype": self.cfg.model.compute_dtype}, program)

    def uncertainty(self, images: np.ndarray) -> np.ndarray:
        """images [N,H,W,C] uint8 or normalized float32 -> f32 [N,H,W] KL
        maps of the main decoder against the decoders' mean softmax (zeros
        for a single-output model)."""
        x = self._normalize(images)
        maps = []
        for chunk, n in self._microbatches(x):
            u = self.uncertainty_device(torch.from_numpy(
                np.ascontiguousarray(chunk)).to(self.device))
            maps.append(u[:n].cpu().numpy())
        return np.concatenate(maps)

    def uncertainty_device(self, x: torch.Tensor) -> torch.Tensor:
        """One normalised NHWC batch on the device -> its uncertainty maps
        (`uncertainty_map`)."""
        return uncertainty_map(self.model, x)

    # ------------------------------------------------------------------
    def _normalize(self, images: np.ndarray) -> np.ndarray:
        if images.dtype == np.uint8:   # the pipeline's normalisation
            return normalize(images, self.cfg.data.mean, self.cfg.data.std)
        return images.astype(np.float32)

    def _microbatches(self, x: np.ndarray):
        bs = self.batch_size
        for i in range(0, x.shape[0], bs):
            chunk = x[i:i + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)])
            yield chunk, bs - pad

    def _probs(self, x: torch.Tensor) -> torch.Tensor:
        """f32 class probabilities [B, H, W, C] of a normalised batch."""
        if self.tta and self.basenet:
            scores = self.model(x, tta=True)
            return scores / scores.sum(-1, keepdim=True)
        if self.tta:
            return flip_tta_softmax(self._forward, x)
        return torch.softmax(self._forward(x).float(), dim=-1)

    def predict_device(self, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One normalised NHWC batch already on the device -> (masks int32
        [B, H, W], probs f32 [B, H, W, C]) on the device."""
        with torch.inference_mode():
            probs = self._probs(x)
            return torch.argmax(probs, dim=-1).to(torch.int32), probs

    def predict(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """images [N,H,W,C] uint8 or normalized float32 ->
        (masks [N,H,W] int32, probs [N,H,W,C] float32)."""
        x = self._normalize(images)
        masks, probs = [], []
        for chunk, n in self._microbatches(x):
            m, p = self.predict_device(
                torch.from_numpy(np.ascontiguousarray(chunk)).to(
                    self.device))
            masks.append(m[:n].cpu().numpy())
            probs.append(p[:n].cpu().numpy())
        return np.concatenate(masks), np.concatenate(probs)


def read_images(directory: str, hw: Tuple[int, int], channels: int = 3
                ) -> Tuple[list, np.ndarray]:
    """(file names, uint8 images [N, H, W, channels]) of the files in
    `directory` that OpenCV decodes, in name order, resized to `hw` with
    nearest (RGB, or grey for one channel)."""
    h, w = hw
    names, imgs = [], []
    for n in sorted(os.listdir(directory)):
        path = os.path.join(directory, n)
        if channels == 1:
            img = cv2().imread(path, cv2().IMREAD_GRAYSCALE)
        else:
            img = cv2().imread(path)
            if img is not None:
                img = cv2().cvtColor(img, cv2().COLOR_BGR2RGB)
        if img is None:
            continue
        img = cv2().resize(img, (w, h), interpolation=cv2().INTER_NEAREST)
        imgs.append(img.reshape(h, w, channels))
        names.append(n)
    if not imgs:
        raise FileNotFoundError(f"no image OpenCV can decode in "
                                f"{directory!r}")
    return names, np.stack(imgs)


def main(argv=None) -> Dict[str, float]:
    from uaps_tpu_torch.utils.checkpoint import module_tensors, restore_run
    from uaps_tpu_torch.utils.cli import parse_args
    from uaps_tpu_torch.utils.viz import colorize, jet
    cfg, _ = parse_args(argv)
    p = argparse.ArgumentParser()
    p.add_argument("--images", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--export", default=None, metavar="PATH",
                   help="write the deployable artifact (artifact.py) and "
                        "exit")
    p.add_argument("--ckpt", default=None,
                   help="a run directory of the port's Trainer")
    p.add_argument("--torch_ckpt", default=None, help="a .pth checkpoint")
    p.add_argument("--uncertainty", action="store_true")
    p.add_argument("--tta", action="store_true",
                   help="mean softmax over the 4 H/V flips (a BaseNet: its "
                        "multi-scale flip harness)")
    p.add_argument("--device", default="cuda")
    extra, _ = p.parse_known_args(argv)

    kw = dict(tta=extra.tta, device=extra.device)
    if extra.torch_ckpt:
        engine = InferenceEngine.from_torch(cfg, extra.torch_ckpt, **kw)
    else:
        tensors, _, _ = restore_run(extra.ckpt or cfg.run.out_dir)
        engine = InferenceEngine(cfg, state_dict=module_tensors(tensors),
                                 **kw)
    if extra.export:
        size = engine.export(extra.export)
        print(f"exported deployment artifact -> {extra.export} ({size} "
              "bytes)")
        return {"bytes": size}
    if not (extra.images and extra.out):
        p.error("--images and --out are required (or use --export)")

    os.makedirs(extra.out, exist_ok=True)
    names, batch = read_images(extra.images, cfg.data.image_size,
                               cfg.data.in_channels)
    t0 = time.perf_counter()
    masks, _ = engine.predict(batch)
    dt = time.perf_counter() - t0
    stems = [os.path.splitext(n)[0] for n in names]
    for stem, m in zip(stems, masks):
        cv2().imwrite(os.path.join(extra.out, f"{stem}_mask.png"),
                      m.astype(np.uint8))
        cv2().imwrite(os.path.join(extra.out, f"{stem}_viz.png"),
                      cv2().cvtColor(colorize(m), cv2().COLOR_RGB2BGR))
    if extra.uncertainty:
        for stem, u in zip(stems, engine.uncertainty(batch)):
            um = (255 * u / max(float(u.max()), 1e-8)).astype(np.uint8)
            cv2().imwrite(os.path.join(extra.out, f"{stem}_uncert.png"),
                          cv2().cvtColor(jet(um), cv2().COLOR_RGB2BGR))
    print(f"processed {len(names)} images in {dt:.2f}s "
          f"({len(names) / dt:.1f} imgs/s) -> {extra.out}")
    return {"images": len(names), "seconds": dt,
            "imgs_per_sec": len(names) / dt}


if __name__ == "__main__":
    main()
