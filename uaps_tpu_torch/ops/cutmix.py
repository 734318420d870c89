"""CutMix and cross-CutMix for UCC, on the device: the port's
`uaps_tpu/ops/cutmix.py`.

The masks are built for the whole batch at once from broadcast index
comparisons, with the rectangles' corners as device tensors, so no draw
reaches the host and a CUDA graph can capture the augmentation. Each
rectangle is drawn as JAX draws it (per sample): width w ~ U{W/ratio + 1,
..., W - 1}, height h = round(H W / ratio / w) (half to even, in f32),
x0 ~ U{0, ..., W - w}, y0 ~ U{0, ..., max(H - h, 0)}. The integers come
from f64 uniforms floored (torch.randint takes host bounds, and w sets the
others' bounds), all from the caller's generator; the bits are not JAX's.
On ranks a sample's draws are its row of the draw over the global batch
(parallel/ranks.py `rows`).

Mask convention (the reference's): 1 outside the rectangle, 0 inside, so
`a * mask + b * (1 - mask)` pastes a rectangle of b into a; the mixes below
select instead of blending, which gives the same values.
"""
from __future__ import annotations

from typing import Tuple

import torch

from uaps_tpu_torch.parallel.ranks import rows


def _below(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """floor(u * n) for f64 u in [0, 1) and int64 n >= 1, capped at n - 1:
    U{0, ..., n - 1}."""
    return torch.minimum(torch.floor(u * n).to(torch.int64), n - 1)


def _rectangles(generator: torch.Generator, b: int, im_h: int, im_w: int,
                ratio: int, device) -> torch.Tensor:
    """[b, H, W] bool, True inside each sample's rectangle."""
    u = rows(lambda n: torch.rand((3, n), generator=generator,
                                  device=device, dtype=torch.float64),
             b, dim=1)
    w_lo = im_w // ratio + 1
    w = w_lo + _below(u[0], torch.full_like(u[0], im_w - w_lo,
                                           dtype=torch.int64))
    h = torch.round((im_h * im_w / ratio) / w.to(torch.float32)).to(
        torch.int64)
    x0 = _below(u[1], im_w - w + 1)
    y0 = _below(u[2], torch.clamp(im_h - h + 1, min=1))
    xx = torch.arange(im_w, device=device)[None, None, :]
    yy = torch.arange(im_h, device=device)[None, :, None]
    x0, w, y0, h = (v[:, None, None] for v in (x0, w, y0, h))
    return (xx >= x0) & (xx < x0 + w) & (yy >= y0) & (yy < y0 + h)


def cutout_mask(generator: torch.Generator, b: int, im_h: int, im_w: int,
                ratio: int = 2, device=None) -> torch.Tensor:
    """[b, H, W] f32 masks, each with one rectangle of area ~ H W / ratio
    zeroed (cross_cutmix.py:60-75)."""
    return torch.where(_rectangles(generator, b, im_h, im_w, ratio, device),
                       0.0, 1.0)


def _gates(generator: torch.Generator, b: int, p: float,
           device) -> torch.Tensor:
    """[b] bool, each True with probability p."""
    return rows(lambda n: torch.rand((n,), generator=generator,
                                     device=device), b) < p


def generate_mix_data(generator: torch.Generator, images: torch.Tensor,
                      labels: torch.Tensor, p: float = 0.2
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-batch labelled CutMix (cross_cutmix.py:78-99): with
    probability p per sample i, a rectangle of sample (i + 1) % B is pasted
    into it, image and label alike. images NHWC, labels [B, H, W]."""
    b, h, w, _ = images.shape
    gates = _gates(generator, b, p, images.device)
    paste = (_rectangles(generator, b, h, w, 2, images.device)
             & gates[:, None, None])
    mixed_img = torch.where(paste[..., None], torch.roll(images, -1, 0),
                            images)
    mixed_lab = torch.where(paste, torch.roll(labels, -1, 0), labels)
    return mixed_img, mixed_lab


def generate_crossmix_data(generator: torch.Generator,
                           labeled: torch.Tensor, weak: torch.Tensor,
                           strong: torch.Tensor, p: float = 0.3
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-CutMix of the labelled images into the weak and strong
    unlabelled streams (cross_cutmix.py:101-123): per sample one mask and
    one gate, shared by the weak / strong pair."""
    b, h, w, _ = labeled.shape
    gates = _gates(generator, b, p, labeled.device)
    paste = (_rectangles(generator, b, h, w, 2, labeled.device)
             & gates[:, None, None])[..., None]
    return (torch.where(paste, labeled, weak),
            torch.where(paste, labeled, strong))
