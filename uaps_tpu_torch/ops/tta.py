"""Flip test-time augmentation: the port's `uaps_tpu/ops/tta.py`, for the
U-Net family (BaseNet's multi-scale harness waits for BaseNet)."""
from __future__ import annotations

from typing import Callable

import torch

# (flip W, flip H), in JAX's order
_FLIPS = ((False, False), (True, False), (False, True), (True, True))


def flip_tta_softmax(forward: Callable[[torch.Tensor], torch.Tensor],
                     image: torch.Tensor) -> torch.Tensor:
    """The mean softmax over the 4 H/V flips of an NHWC batch, the
    models' layout: `forward(image) -> logits [B, H, W, C]`; returns f32
    probabilities [B, H, W, C] (their argmax and metrics read as the
    logits' do)."""
    total = None
    for fw, fh in _FLIPS:
        dims = [d for d, on in ((2, fw), (1, fh)) if on]
        cur = image.flip(dims) if dims else image
        p = torch.softmax(forward(cur).float(), dim=-1)
        p = p.flip(dims) if dims else p
        total = p if total is None else total + p
    return total / 4.0
