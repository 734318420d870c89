"""The real-image host pipeline: the port's copy of
`uaps_tpu/data/pipeline.py` (discovery, seeded splits, augmented streams).

    data = DefectDataset(cfg.data, seed=cfg.run.seed)
    for batch in data.train_iter(): ...   # image, label, uimage, ulabel

The training streams are infinite and the val / test streams finite (the
last batch short). Decoding and augmentation run in a thread pool of
`DataConfig.num_workers` threads (OpenCV and numpy release the GIL) behind
a bounded prefetch queue. The order of a stream does not depend on the
threads: each epoch's permutation and every example's seed are drawn on
the producer thread before the pool maps the examples, `pool.map` keeps
their order, and the labelled and unlabelled streams are zipped in order,
so one seed gives the batches JAX's pipeline gives (a CPU test holds
them equal). Batches are numpy: image f32 NHWC normalised by
`augment.normalize`, label int32 NHW.

Layout (scripts/prepare_data.py writes it): image_root holds
<stem><img_ext>, mask_root <stem><mask_ext> with the class of each pixel
(kosdd2: 0 / 255); the stems are the file names up to their first dot, in
`os.walk` order, unsorted, as the reference lists them (sorting would move
the splits).
"""
from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from uaps_tpu_torch.data import augment as A
from uaps_tpu_torch.data.specs import SPECS, DatasetSpec, split_ids

PREFETCH = 4   # finished batches a training stream keeps ready


def background(it: Iterable, size: int) -> Iterator:
    """Iterate `it` on a daemon thread behind a queue of `size` items. An
    exception raised there is raised again here, in the consumer, so that
    a fault of the stream (a missing file, no OpenCV, a split smaller than
    a batch) stops the caller instead of leaving it waiting."""
    q: "queue.Queue" = queue.Queue(maxsize=size)

    def worker():
        try:
            for item in it:
                q.put((True, item))
        except BaseException as e:   # handed to the consumer
            q.put((False, e))
        else:
            q.put((False, None))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        ok, item = q.get()
        if ok:
            yield item
        elif item is None:
            return
        else:
            raise item


def discover_ids(root: str) -> List[str]:
    """File stems under `root` in os.walk order (utilities/
    dataloaders.py:26-32)."""
    names = []
    for _, _, filenames in os.walk(root):
        for fn in filenames:
            names.append(fn.split(".")[0])
    return names


class DefectDataset:
    """Two-stream semi-supervised dataset over image files on disk."""

    def __init__(self, data_cfg, seed: int = 0):
        A.cv2()   # no OpenCV: raise here, naming it
        self.cfg = data_cfg
        self.spec: DatasetSpec = SPECS[data_cfg.name]
        self.seed = seed
        if not data_cfg.image_root:
            raise ValueError(
                f"dataset {data_cfg.name!r} needs data.image_root "
                "(--image_root, or $UAPS_DATA_ROOT/<dataset> in the layout "
                "scripts/prepare_data.py writes)")
        train_ids = discover_ids(data_cfg.image_root)
        test_ids = (discover_ids(data_cfg.test_image_root)
                    if self.spec.has_test_dir and data_cfg.test_image_root
                    else None)
        self.splits = split_ids(
            self.spec, train_ids, test_ids, data_cfg.val_fraction,
            data_cfg.labeled_fraction, data_cfg.split_seed_val,
            data_cfg.split_seed_labeled)
        self._eval_aug = A.Compose([A.resize(*self.spec.resize_hw)])

    # ------------------------------------------------------------------
    def _read(self, image_root: str, mask_root: str, stem: str):
        cv2 = A.cv2()
        img_path = os.path.join(image_root, stem + self.spec.img_ext)
        if self.spec.grayscale:
            img = cv2.imread(img_path, cv2.IMREAD_GRAYSCALE)
        else:
            img = cv2.imread(img_path)
            if img is not None:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        mask = cv2.imread(os.path.join(mask_root, stem + self.spec.mask_ext),
                          cv2.IMREAD_GRAYSCALE)
        if img is None or mask is None:
            raise FileNotFoundError(f"missing image/mask for id {stem!r}")
        return img, mask

    def _example(self, rng, stem: str, aug: A.Compose, roots=None):
        """The augmented uint8 image [H, W, C] and int32 mask of `stem`."""
        image_root, mask_root = roots or (self.cfg.image_root,
                                          self.cfg.mask_root)
        img, mask = self._read(image_root, mask_root, stem)
        img, mask = aug(rng, img, mask)
        if img.ndim == 2:
            img = img[..., None]
        y = mask.astype(np.int32)
        if self.spec.binarize_mask:
            y = (y / 255.0).astype(np.int32)
        if self.spec.transpose_after_resize:
            img = np.transpose(img, (1, 0, 2))
            y = np.transpose(y, (1, 0))
        return np.ascontiguousarray(img), y

    def _finalize(self, imgs_u8, masks):
        """Stack and normalise a batch."""
        x = A.normalize(np.stack(imgs_u8), self.cfg.mean, self.cfg.std)
        return x, np.stack(masks)

    # ------------------------------------------------------------------
    def _infinite_batches(self, split: str, aug_factory, salt: int,
                          extra_aug_factory=None) -> Iterator:
        """Infinite shuffled batches of the ids of `split` from a producer
        thread; with `extra_aug_factory` each also carries a second view
        (image2, label2) of the same examples from the seed after theirs.
        A split smaller than a batch raises ValueError (it would yield
        nothing)."""
        ids = self.splits[split]
        bs = self.cfg.batch_size
        if len(ids) < bs:
            raise ValueError(
                f"the {split} split holds {len(ids)} images, fewer than "
                f"one batch of {bs}")
        n_workers = max(1, self.cfg.num_workers)

        def producer():
            rng = np.random.default_rng(self.seed + salt)
            aug = aug_factory()
            extra = extra_aug_factory() if extra_aug_factory else None

            def load(args):
                stem, s = args
                x1, y1 = self._example(np.random.default_rng(int(s)), stem,
                                       aug)
                if extra is None:
                    return x1, y1
                x2, y2 = self._example(np.random.default_rng(int(s) + 1),
                                       stem, extra)
                return x1, y1, x2, y2

            with ThreadPoolExecutor(n_workers) as pool:
                while True:
                    order = rng.permutation(len(ids))
                    for i in range(0, len(order) - bs + 1, bs):
                        stems = [ids[j] for j in order[i:i + bs]]
                        seeds = rng.integers(0, 2**31, size=bs)
                        results = list(pool.map(load, zip(stems, seeds)))
                        x, y = self._finalize([r[0] for r in results],
                                              [r[1] for r in results])
                        batch = {"image": x, "label": y}
                        if extra is not None:
                            batch["image2"], batch["label2"] = \
                                self._finalize([r[2] for r in results],
                                               [r[3] for r in results])
                        yield batch

        yield from background(producer(), PREFETCH)

    # ------------------------------------------------------------------
    def train_iter(self) -> Iterator[Dict[str, np.ndarray]]:
        lab = self._infinite_batches("labeled", self.spec.train_aug, salt=1)
        unlab = self._infinite_batches("unlabeled", self.spec.train_aug,
                                       salt=2)
        for a, b in zip(lab, unlab):
            yield {"image": a["image"], "label": a["label"],
                   "uimage": b["image"], "ulabel": b["label"]}

    def train_iter_weak_strong(self) -> Iterator[Dict[str, np.ndarray]]:
        """UCC's stream: labelled (train aug) and the weak / strong views
        of the unlabelled images (UCC/UCC_dataloaders.py
        NEUDataset_SW:104-143)."""
        if self.spec.weak_aug is None or self.spec.strong_aug is None:
            raise ValueError(
                f"dataset {self.spec.name!r} has no weak/strong recipe")
        lab = self._infinite_batches("labeled", self.spec.train_aug, salt=1)
        unlab = self._infinite_batches(
            "unlabeled", self.spec.weak_aug, salt=2,
            extra_aug_factory=self.spec.strong_aug)
        for a, b in zip(lab, unlab):
            yield {"image": a["image"], "label": a["label"],
                   "uimage": b["image"], "ulabel": b["label"],
                   "uimage_strong": b["image2"]}

    def _finite(self, ids: List[str], roots=None, batch_size=None,
                salt: int = 99) -> Iterator[Dict[str, np.ndarray]]:
        """Batches of `ids` in order, resized only; the last one short."""
        bs = batch_size or self.cfg.batch_size
        rng = np.random.default_rng(self.seed + salt)
        for i in range(0, len(ids), bs):
            xs, ys = [], []
            for stem in ids[i:i + bs]:
                x, y = self._example(rng, stem, self._eval_aug, roots)
                xs.append(x)
                ys.append(y)
            imgs, labels = self._finalize(xs, ys)
            yield {"image": imgs, "label": labels}

    def val_iter(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._finite(self.splits["val"])

    def test_iter(self, batch_size: Optional[int] = None
                  ) -> Iterator[Dict[str, np.ndarray]]:
        """The dedicated test directory where the dataset has one and it
        is given, else the split's test ids from the train directory."""
        roots = None
        if self.spec.has_test_dir and self.cfg.test_image_root:
            roots = (self.cfg.test_image_root, self.cfg.test_mask_root)
        return self._finite(self.splits["test"], roots=roots,
                            batch_size=batch_size)
