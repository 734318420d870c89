"""Host-side image augmentations: the port's copy of
`uaps_tpu/data/augment.py` (albumentations-equivalent ops with OpenCV).

The reference composes albumentations transforms per dataset
(utilities/dataloaders.py:98-105, DAGM .../UAPS_dataloaders.py:96-101,
MTiles :96-99, KoSDD2 :107-114, UCC/UCC_dataloaders.py:149-168); each op
here has the same sampling semantics as JAX's: the same draws from the
same `np.random.Generator` in the same order, on uint8 HWC / HW arrays,
so one seed gives both packages the same bits (a CPU test holds them
equal). Augmentation runs on host threads; the device step only sees
normalised NHWC f32 batches.

Every op: fn(rng, img, mask) -> (img, mask). OpenCV is imported when an
op first runs: without it they raise ImportError naming cv2 (there is no
fallback decoder or resampler).

`normalize` is the one normalisation of the port: the real-image pipeline
and `InferenceEngine` both call it.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

Op = Callable[[np.random.Generator, np.ndarray, Optional[np.ndarray]],
              Tuple[np.ndarray, Optional[np.ndarray]]]


@functools.cache
def cv2():
    """The OpenCV module; ImportError naming cv2 where it is absent."""
    try:
        import cv2 as module
    except ImportError as exc:
        raise ImportError(
            "the real-image pipeline and the serve directory CLI decode and "
            "resample with OpenCV: install the cv2 module "
            f"(opencv-python-headless) ({exc})") from exc
    return module


def resize(h: int, w: int) -> Op:
    """A.Resize(h, w, interpolation=INTER_NEAREST): nearest for both image
    and mask, as the reference configures it."""
    def op(rng, img, mask):
        img = cv2().resize(img, (w, h), interpolation=cv2().INTER_NEAREST)
        if mask is not None:
            mask = cv2().resize(mask, (w, h),
                                interpolation=cv2().INTER_NEAREST)
        return img, mask
    return op


def hflip(p: float) -> Op:
    def op(rng, img, mask):
        if rng.random() < p:
            img = img[:, ::-1].copy()
            if mask is not None:
                mask = mask[:, ::-1].copy()
        return img, mask
    return op


def vflip(p: float) -> Op:
    def op(rng, img, mask):
        if rng.random() < p:
            img = img[::-1].copy()
            if mask is not None:
                mask = mask[::-1].copy()
        return img, mask
    return op


def random_rotate90(p: float) -> Op:
    def op(rng, img, mask):
        if rng.random() < p:
            k = int(rng.integers(1, 4))
            img = np.rot90(img, k).copy()
            if mask is not None:
                mask = np.rot90(mask, k).copy()
        return img, mask
    return op


def random_brightness_contrast(
    brightness: Tuple[float, float] = (0.0, 0.5),
    contrast: Tuple[float, float] = (0.0, 0.5),
    p: float = 0.5,
) -> Op:
    """A.RandomBrightnessContrast (brightness_by_max=True):
    out = clip(img * (1 + c) + b * 255)."""
    def op(rng, img, mask):
        if rng.random() < p:
            c = rng.uniform(*contrast)
            b = rng.uniform(*brightness)
            out = img.astype(np.float32) * (1.0 + c) + b * 255.0
            img = np.clip(out, 0, 255).astype(np.uint8)
        return img, mask
    return op


def blur(p: float, kernel_range: Tuple[int, int] = (3, 7)) -> Op:
    """A.Blur: a box filter with a random odd kernel in [3, 7]."""
    def op(rng, img, mask):
        if rng.random() < p:
            k = int(rng.integers(kernel_range[0] // 2,
                                 kernel_range[1] // 2 + 1)) * 2 + 1
            img = cv2().blur(img, (k, k))
        return img, mask
    return op


def gauss_noise(p: float, var_limit: Tuple[float, float] = (10.0, 50.0)) -> Op:
    """A.GaussNoise: additive N(0, sigma) on the uint8 scale,
    sigma = sqrt(U(var_limit))."""
    def op(rng, img, mask):
        if rng.random() < p:
            sigma = np.sqrt(rng.uniform(*var_limit))
            noise = rng.normal(0.0, sigma, img.shape).astype(np.float32)
            img = np.clip(img.astype(np.float32) + noise, 0, 255
                          ).astype(np.uint8)
        return img, mask
    return op


def grid_distortion(p: float, num_steps: int = 5,
                    distort_limit: float = 0.3) -> Op:
    """A.GridDistortion: per-cell scale jitter of the sampling grid,
    remapped with linear (image) and nearest (mask) interpolation."""
    def op(rng, img, mask):
        if rng.random() >= p:
            return img, mask
        h, w = img.shape[:2]

        def axis_map(n):
            xs = [0.0]
            step = n / num_steps
            for _ in range(num_steps):
                xs.append(xs[-1] + step * (1.0 + rng.uniform(
                    -distort_limit, distort_limit)))
            grid = np.asarray(xs)
            grid = grid * (n - 1) / grid[-1]
            fine = np.interp(np.arange(n), np.linspace(0, n, num_steps + 1),
                             grid)
            return fine.astype(np.float32)

        map_x = np.tile(axis_map(w), (h, 1))
        map_y = np.tile(axis_map(h)[:, None], (1, w))
        img = cv2().remap(img, map_x, map_y, cv2().INTER_LINEAR,
                          borderMode=cv2().BORDER_REFLECT_101)
        if mask is not None:
            mask = cv2().remap(mask, map_x, map_y, cv2().INTER_NEAREST,
                               borderMode=cv2().BORDER_REFLECT_101)
        return img, mask
    return op


def color_jitter(p: float, brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.2) -> Op:
    """A.ColorJitter as JAX approximates it: an affine intensity jitter,
    then saturation and hue in HSV (RGB images only)."""
    def op(rng, img, mask):
        if rng.random() >= p or img.ndim != 3 or img.shape[2] != 3:
            return img, mask
        out = img.astype(np.float32)
        out = out * rng.uniform(1 - brightness, 1 + brightness)
        mean = out.mean()
        out = (out - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
        hsv = cv2().cvtColor(np.clip(out, 0, 255).astype(np.uint8),
                             cv2().COLOR_RGB2HSV).astype(np.float32)
        hsv[..., 1] *= rng.uniform(1 - saturation, 1 + saturation)
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue, hue) * 180) % 180
        img = cv2().cvtColor(np.clip(hsv, 0, 255).astype(np.uint8),
                             cv2().COLOR_HSV2RGB)
        return img, mask
    return op


def pixel_dropout(p: float, dropout_prob: float = 0.01,
                  drop_value: int = 0) -> Op:
    """A.PixelDropout: zero random pixels (the mask untouched)."""
    def op(rng, img, mask):
        if rng.random() < p:
            drop = rng.random(img.shape[:2]) < dropout_prob
            img = img.copy()
            img[drop] = drop_value
        return img, mask
    return op


class Compose:
    def __init__(self, ops: Sequence[Op]):
        self.ops = list(ops)

    def __call__(self, rng: np.random.Generator, img: np.ndarray,
                 mask: Optional[np.ndarray]):
        for op in self.ops:
            img, mask = op(rng, img, mask)
        return img, mask


def normalize(images: np.ndarray, mean, std) -> np.ndarray:
    """uint8 images [..., H, W, C] (or one [H, W] grey image) -> f32
    (x / 255 - mean) / std per channel (ToTensor + Normalize up to the
    layout). The same IEEE operations as numpy's formula (JAX's fallback;
    the fused form of JAX's native library rounds up to 4.8e-7 away), run
    as torch's CPU ops: numpy's broadcast over C = 3 is ~10x slower."""
    x = torch.from_numpy(np.ascontiguousarray(images)).float()
    if x.ndim == 2:
        x = x[..., None]
    x.div_(255.0).sub_(torch.tensor(mean, dtype=torch.float32))
    return x.div_(torch.tensor(std, dtype=torch.float32)).numpy()
