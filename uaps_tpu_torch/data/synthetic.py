"""Synthetic defect-segmentation data: the port's copy of
`uaps_tpu/data/synthetic.py` (same generator, same numbers for a seed).

Random textured plates with elliptical defect blobs whose appearance
correlates with their class, generated with numpy on the host, so training
runs and tests need no dataset: class k defects have a distinct
intensity/texture signature, so a working train step drives mIoU well
above chance within a few hundred steps. `hard=True` overlaps the class
signatures and adds strong jitter and noise, so that a small labelled pool
underfits.

`write_image_set` (the port's own) writes such images and masks as files
in the layout scripts/prepare_data.py writes, for the real-image pipeline's
tests and the card's smoke run.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_GRID_CACHE = {}


def _grid(h: int, w: int):
    """Cached coordinate grids (the mgrid was ~30% of generation time)."""
    if (h, w) not in _GRID_CACHE:
        _GRID_CACHE[(h, w)] = np.mgrid[0:h, 0:w].astype(np.float32)
    return _GRID_CACHE[(h, w)]


def _defect_mask(rng: np.random.Generator, h: int, w: int,
                 num_classes: int, max_blobs: int = 4,
                 hard: bool = False) -> np.ndarray:
    """Label map with 1..max_blobs elliptical blobs of classes 1..C-1."""
    mask = np.zeros((h, w), np.int32)
    yy, xx = _grid(h, w)
    r_lo, r_hi = (0.025, 0.11) if hard else (0.04, 0.22)
    for _ in range(rng.integers(1, max_blobs + 1)):
        c = int(rng.integers(1, num_classes))
        cy, cx = rng.uniform(0.15, 0.85) * h, rng.uniform(0.15, 0.85) * w
        ry = rng.uniform(r_lo, r_hi) * h
        rx = rng.uniform(r_lo, r_hi) * w
        theta = rng.uniform(0, np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        u = (xx - cx) * ct + (yy - cy) * st
        v = -(xx - cx) * st + (yy - cy) * ct
        blob = (u / rx) ** 2 + (v / ry) ** 2 <= 1.0
        mask[blob] = c
    return mask


def _render(rng: np.random.Generator, mask: np.ndarray,
            in_channels: int, hard: bool = False) -> np.ndarray:
    """Image whose per-class appearance is separable but noisy;
    ``hard=True`` overlaps the class signatures, shrinks their mean
    shifts and adds per-image gain/bias jitter and heavy noise."""
    h, w = mask.shape
    base = rng.normal(0.45, 0.08, (h, w))
    # low-frequency texture: smoothed noise via strided upsample
    tex_amp = 0.18 if hard else 0.1
    coarse = rng.normal(0, tex_amp, (h // 8 + 1, w // 8 + 1))
    tex = np.kron(coarse, np.ones((8, 8)))[:h, :w]
    img = base + tex
    num_classes = int(mask.max()) + 1 if mask.max() > 0 else 2
    for c in range(1, num_classes):
        sel = mask == c
        if not sel.any():
            continue
        if hard:
            # weak, overlapping signatures: small mean shifts, close
            # stripe frequencies, and the defect keeps the plate texture
            shift = 0.05 + 0.045 * c
            stripes = 0.035 * np.sin(
                _grid(h, w)[c % 2] * (1.1 + 0.18 * c)
                + rng.uniform(0, 2 * np.pi))
            img = np.where(sel, img + shift + stripes, img)
        else:
            # class signature: shifted mean + class-dependent stripes
            shift = 0.25 + 0.15 * c
            stripes = 0.08 * np.sin(_grid(h, w)[c % 2] * (0.5 + 0.35 * c))
            img = np.where(sel, base - 0.5 + shift + stripes, img)
    if hard:
        # per-image photometric jitter decorrelates absolute intensity
        # from class identity (a tiny labeled pool can't average it out)
        img = img * rng.uniform(0.8, 1.2) + rng.uniform(-0.12, 0.12)
    noise = 0.10 if hard else 0.03
    img = np.clip(img + rng.normal(0, noise, (h, w)), 0, 1)
    chans = [img]
    for i in range(1, in_channels):
        chans.append(np.clip(img * (1.0 - 0.1 * i) +
                             rng.normal(0, 0.02, (h, w)), 0, 1))
    return np.stack(chans[:in_channels], axis=-1).astype(np.float32)


def synthetic_batch(
    rng: np.random.Generator,
    batch_size: int,
    image_size: Tuple[int, int] = (64, 64),
    num_classes: int = 4,
    in_channels: int = 3,
    mean: Optional[Tuple[float, ...]] = None,
    std: Optional[Tuple[float, ...]] = None,
    hard: bool = False,
) -> Dict[str, np.ndarray]:
    h, w = image_size
    # per-image generation in a thread pool (numpy releases the GIL for
    # the large-array ops); child rngs keep determinism
    from concurrent.futures import ThreadPoolExecutor
    seeds = rng.integers(0, 2 ** 63, size=batch_size)

    def gen(s):
        r = np.random.default_rng(int(s))
        m = _defect_mask(r, h, w, num_classes, hard=hard)
        return _render(r, m, in_channels, hard=hard), m

    with ThreadPoolExecutor(min(8, batch_size)) as pool:
        results = list(pool.map(gen, seeds))
    imgs = [r[0] for r in results]
    masks = [r[1] for r in results]
    image = np.stack(imgs)
    if mean is not None:
        image = (image - np.asarray(mean, np.float32)) / np.asarray(
            std, np.float32)
    return {"image": image, "label": np.stack(masks)}


class SyntheticDefects:
    """Infinite two-stream iterator with the real pipeline's interface
    (explicitly infinite samplers; the trainer counts steps per epoch)."""

    def __init__(self, cfg, seed: int = 0, labeled_pool: int = 0,
                 unlabeled_pool: int = 0, val_pool: int = 0,
                 test_pool: int = 0, hard: bool = False):
        """``labeled_pool > 0`` fixes the labeled stream to that many
        pre-generated images (sampled with replacement); the unlabeled
        stream stays infinite and fresh. ``unlabeled_pool`` / ``val_pool``
        / ``test_pool > 0`` likewise pin those splits to fixed pools, which
        val/test sweeps visit once each, like a finite dataset's
        loaders."""
        self.cfg = cfg
        self.seed = seed
        self.hard = hard
        self.labeled_pool = labeled_pool
        self.unlabeled_pool = unlabeled_pool
        self._pool = self._fixed(labeled_pool, 7)
        self._upool = self._fixed(unlabeled_pool, 11)
        self._val = self._fixed(val_pool, 100)
        self._test = self._fixed(test_pool, 200)

    def _fixed(self, n: int, salt: int):
        """Pre-generate an n-image pool (chunked so the thread pool and
        peak temp memory stay bounded at 256²-scale pool sizes)."""
        if n <= 0:
            return None
        rng = np.random.default_rng(self.seed + salt)
        d = self.cfg
        chunks = []
        left = n
        while left > 0:
            k = min(64, left)
            chunks.append(synthetic_batch(rng, k, d.image_size,
                                          d.num_classes, d.in_channels,
                                          hard=self.hard))
            left -= k
        return {k: np.concatenate([c[k] for c in chunks])
                for k in chunks[0]}

    def _stream(self, salt: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + salt)
        d = self.cfg
        pool = (self._pool if salt == 1
                else self._upool if salt == 2 else None)
        if pool is not None:
            size = len(pool["image"])
            while True:
                idx = rng.integers(0, size, d.batch_size)
                yield {"image": pool["image"][idx],
                       "label": pool["label"][idx]}
        while True:
            yield synthetic_batch(
                rng, d.batch_size, d.image_size, d.num_classes,
                d.in_channels, hard=self.hard)

    def train_iter(self):
        """Yields {'image','label','uimage','ulabel'} merged two-stream
        batches (labels of the unlabeled stream kept for diagnostics only,
        like the reference's unused labels_U)."""
        lab = self._stream(1)
        unlab = self._stream(2)
        for a, b in zip(lab, unlab):
            yield {"image": a["image"], "label": a["label"],
                   "uimage": b["image"], "ulabel": b["label"]}

    def train_iter_weak_strong(self):
        """UCC-style stream with a weak/strong unlabeled pair. For the
        synthetic fixture 'strong' = weak + extra noise jitter."""
        rng = np.random.default_rng(self.seed + 3)
        for batch in self.train_iter():
            strong = batch["uimage"] + rng.normal(
                0, 0.1, batch["uimage"].shape).astype(np.float32)
            yield {**batch, "uimage_strong": strong}

    @staticmethod
    def _sweep(pool, batch_size: int):
        """One full pass over a fixed pool (drop_last=False, like the
        reference's val/test loaders)."""
        n = len(pool["image"])
        for i in range(0, n, batch_size):
            yield {k: v[i:i + batch_size] for k, v in pool.items()}

    def val_iter(self, num_batches: int = 4):
        d = self.cfg
        if self._val is not None:
            yield from self._sweep(self._val, d.batch_size)
            return
        rng = np.random.default_rng(self.seed + 100)
        for _ in range(num_batches):
            yield synthetic_batch(rng, d.batch_size, d.image_size,
                                  d.num_classes, d.in_channels,
                                  hard=self.hard)

    def test_iter(self, num_batches: int = 8, batch_size=None):
        d = self.cfg
        if self._test is not None:
            yield from self._sweep(self._test, batch_size or d.batch_size)
            return
        rng = np.random.default_rng(self.seed + 200)
        for _ in range(num_batches):
            yield synthetic_batch(rng, batch_size or d.batch_size,
                                  d.image_size, d.num_classes,
                                  d.in_channels, hard=self.hard)


def write_image_set(root: str, dataset: str, n_train: int, n_test: int,
                    hw: Tuple[int, int], num_classes: int, seed: int
                    ) -> Dict[str, str]:
    """Seeded defect images and masks as files under `root`, in the layout
    scripts/prepare_data.py writes: images/ and annotations/, and with
    `n_test` test_images/ and test_annotations/, named by index with the
    extensions of `dataset`'s spec (data/specs.py): grey images where the
    spec reads grey, masks of 0 / 255 where it binarises (num_classes 2),
    else the class of each pixel. Returns the DataConfig roots
    (image_root, mask_root, test_image_root, test_mask_root)."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from uaps_tpu_torch.data.augment import cv2
    from uaps_tpu_torch.data.specs import SPECS
    spec = SPECS[dataset]
    h, w = hw
    roots = {"image_root": os.path.join(root, "images"),
             "mask_root": os.path.join(root, "annotations"),
             "test_image_root": os.path.join(root, "test_images") if n_test
             else "",
             "test_mask_root": os.path.join(root, "test_annotations")
             if n_test else ""}
    for d in roots.values():
        if d:
            os.makedirs(d, exist_ok=True)
    jobs = [(roots["image_root"], roots["mask_root"], f"{i:05d}")
            for i in range(n_train)]
    jobs += [(roots["test_image_root"], roots["test_mask_root"], f"t{i:05d}")
             for i in range(n_test)]
    seeds = np.random.default_rng(seed).integers(0, 2 ** 63, len(jobs))

    def write(job):
        (img_dir, mask_dir, stem), s = job
        r = np.random.default_rng(int(s))
        m = _defect_mask(r, h, w, num_classes)
        img = np.round(255 * _render(r, m, 1 if spec.grayscale else 3))
        img = img.astype(np.uint8)
        if not spec.grayscale:
            img = cv2().cvtColor(img, cv2().COLOR_RGB2BGR)
        cv2().imwrite(os.path.join(img_dir, stem + spec.img_ext), img)
        mask = (m * 255 if spec.binarize_mask else m).astype(np.uint8)
        cv2().imwrite(os.path.join(mask_dir, stem + spec.mask_ext), mask)

    with ThreadPoolExecutor() as pool:
        list(pool.map(write, zip(jobs, seeds)))
    return roots
