"""Batched inference engine: the port's `uaps_tpu/serve.py`.

    engine = InferenceEngine.from_torch(cfg, "model.pth", device="cuda")
    masks, probs = engine.predict(images_u8)   # numpy in, numpy out

`predict` keeps the JAX contract (serve.py:142-169): uint8 NHWC images are
normalised as (x / 255 - mean) / std in f32 (float input is taken as
already normalised), cut into micro-batches of `batch_size` with the last
one padded by repeating its last image, run through the main decoder (a
deep-supervision net's forward gives its dp0 head, as JAX's `_forward`
takes `out["dp0"]`), softmaxed in f32 and argmaxed; it returns int32
masks [N, H, W] and f32 probs [N, H, W, C]. `uncertainty`
(serve.py:171-178) returns the main decoder's KL map against the mean of
every decoder's softmax, the aux decoders seeing perturbed features. For
concurrent traffic, `uaps_tpu_torch.server` puts its `AsyncBatcher` and
HTTP front in front of this engine.

Weights come from a `.pth` (a reference checkpoint, one written by the
port's trainer, or JAX weights written by the JAX package's `save_pth`) or
from a state dict.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from uaps_tpu_torch.methods.base import build_model, resolve_device
from uaps_tpu_torch.ops import kl_divergence_map
from uaps_tpu_torch.utils.weights import load_pth, load_state_dict


class InferenceEngine:
    """Fixed-batch predictor over the main decoder, with the padding
    micro-batcher."""

    def __init__(self, cfg, ckpt: Optional[str] = None,
                 state_dict: Optional[dict] = None,
                 batch_size: Optional[int] = None, device="cuda",
                 tta: bool = False):
        if tta:
            raise NotImplementedError(
                "test-time augmentation is not ported yet: ROADMAP.md "
                "Queue A, 'The rest of serving and checkpoints' (ops/tta.py)")
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

    @classmethod
    def from_torch(cls, cfg, pth_path: str, **kw) -> "InferenceEngine":
        """Serve a reference (or `save_pth`) .pth checkpoint."""
        return cls(cfg, ckpt=pth_path, **kw)

    def export(self, path: str) -> None:
        raise NotImplementedError(
            "export is not ported yet: ROADMAP.md Queue A, 'The rest of "
            "serving and checkpoints'")

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
        """One normalised NHWC batch on the device -> its uncertainty maps:
        the eval-mode multi-decoder forward with perturbations drawn from a
        generator seeded 0 for every batch (JAX: rngs key(0))."""
        with torch.inference_mode():
            gen = torch.Generator(device=self.device).manual_seed(0)
            out = self.model(x, gen)
            outs = out if isinstance(out, tuple) else (out,)
            if len(outs) < 2:
                return torch.zeros(x.shape[:3], device=x.device)
            preds = sum(torch.softmax(o, -1) for o in outs) / len(outs)
            return kl_divergence_map(outs[0], preds)

    # ------------------------------------------------------------------
    def _normalize(self, images: np.ndarray) -> np.ndarray:
        if images.dtype == np.uint8:
            # (x / 255 - mean) / std in f32, the same IEEE operations as
            # numpy's, in torch's multi-threaded CPU ops (numpy's
            # broadcast over C = 3 is ~10x slower)
            x = torch.from_numpy(np.ascontiguousarray(images)).float()
            x.div_(255.0).sub_(torch.tensor(self.cfg.data.mean))
            return x.div_(torch.tensor(self.cfg.data.std)).numpy()
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

    def predict_device(self, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One normalised NHWC batch already on the device -> (masks int32
        [B, H, W], probs f32 [B, H, W, C]) on the device."""
        with torch.inference_mode():
            probs = torch.softmax(self._forward(x).float(), dim=-1)
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
