"""Per-dataset specs: the port's copy of `uaps_tpu/data/specs.py` (file
layout, split protocol, augmentation recipes).

The split protocols are the reference's sklearn `train_test_split` chains
with its seeds, so labelled-set membership matches the reference runs and
JAX's:
  NEU    (utilities/dataloaders.py:52-53): dedicated test dir;
         val = 15% seed 69; labelled split seed 45, test_size=1-labelled.
  DAGM   (DAGM-Dataset-codes/UAPS_dataloaders.py:48-50): 20% test seed 69
         from the train dir, then 15% val seed 45, then labelled seed 45.
  MTiles (MTiles-Dataset-codes/UAPS_dataloaders.py:49-50): 20% val seed 69,
         labelled seed 45; no test dir (val doubles as test).
  KoSDD2 (KoSDD2-Dataset-Codes/UAPS_dataloaders.py:60-61): 20% val seed 69,
         labelled seed 45 (test_size=0.6 => 40% labelled); dedicated test
         dir; resize (512, 256) then transpose to landscape; mask / 255.

`train_test_split` is sklearn's function without sklearn: for n ids,
test_size t and random_state s it returns (ids[p[k:]], ids[p[:k]]) with
p = np.random.RandomState(s).permutation(n) and k = ceil(t n), which is
what sklearn's ShuffleSplit computes, and raises ValueError where sklearn
does (t outside (0, 1), an empty side).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from uaps_tpu_torch.data import augment as A


@dataclasses.dataclass
class DatasetSpec:
    name: str
    img_ext: str
    mask_ext: str
    grayscale: bool
    resize_hw: Tuple[int, int]          # cv2 resize target (H, W)
    transpose_after_resize: bool        # KoSDD2 portrait -> landscape
    binarize_mask: bool                 # KoSDD2 (mask / 255)
    has_test_dir: bool
    split_protocol: str                 # 'neu' | 'dagm' | 'valsplit'
    train_aug: Callable[[], A.Compose]  # factories (a fresh Compose a use)
    weak_aug: Optional[Callable[[], A.Compose]] = None
    strong_aug: Optional[Callable[[], A.Compose]] = None


def _neu_train():
    # utilities/dataloaders.py:98-102
    return A.Compose([
        A.resize(256, 256), A.hflip(0.4), A.vflip(0.4),
        A.random_brightness_contrast((0, 0.5), (0, 0.5)),
        A.blur(0.3), A.random_rotate90(0.3), A.gauss_noise(0.3),
    ])


def _dagm_train():
    # DAGM-Dataset-codes/UAPS_dataloaders.py:96-101
    return A.Compose([
        A.resize(256, 256), A.hflip(0.3), A.vflip(0.3),
        A.gauss_noise(0.3),
        A.random_brightness_contrast((0, 0.5), (0, 0.5)),
        A.blur(0.2),
    ])


def _mtiles_train():
    # MTiles-Dataset-codes/UAPS_dataloaders.py:96-99
    return A.Compose([
        A.resize(256, 256), A.hflip(0.5), A.vflip(0.5),
        A.random_brightness_contrast((0, 0.5), (0, 0.5)),
        A.blur(0.3), A.gauss_noise(0.4),
    ])


def _kosdd2_train():
    # KoSDD2-Dataset-Codes/UAPS_dataloaders.py:107-114
    return A.Compose([
        A.resize(512, 256), A.hflip(0.3), A.vflip(0.3),
        A.random_brightness_contrast((0, 0.5), (0, 0.5)),
        A.blur(0.3), A.gauss_noise(0.3),
    ])


def _ucc_train():
    # UCC/UCC_dataloaders.py:149-155
    return A.Compose([
        A.resize(256, 256), A.hflip(0.3), A.vflip(0.3),
        A.random_brightness_contrast((0, 0.5), (0, 0.5), p=0.3),
        A.grid_distortion(0.2), A.blur(0.3), A.gauss_noise(0.4),
    ])


def _ucc_weak():
    # UCC/UCC_dataloaders.py:157-161
    return A.Compose([
        A.resize(256, 256),
        A.random_brightness_contrast((0, 0.5), (0, 0.5), p=0.3),
        A.blur(0.3), A.gauss_noise(0.4),
    ])


def _ucc_strong():
    # UCC/UCC_dataloaders.py:163-168
    return A.Compose([
        A.resize(256, 256), A.blur(0.3), A.color_jitter(0.3),
        A.pixel_dropout(0.2, dropout_prob=0.01), A.gauss_noise(0.4),
    ])


SPECS: Dict[str, DatasetSpec] = {
    "neu": DatasetSpec(
        name="neu", img_ext=".jpg", mask_ext=".png", grayscale=False,
        resize_hw=(256, 256), transpose_after_resize=False,
        binarize_mask=False, has_test_dir=True, split_protocol="neu",
        train_aug=_neu_train, weak_aug=_ucc_weak, strong_aug=_ucc_strong,
    ),
    "dagm": DatasetSpec(
        name="dagm", img_ext=".PNG", mask_ext=".PNG", grayscale=True,
        resize_hw=(256, 256), transpose_after_resize=False,
        binarize_mask=False, has_test_dir=False, split_protocol="dagm",
        train_aug=_dagm_train,
    ),
    "mtiles": DatasetSpec(
        name="mtiles", img_ext=".png", mask_ext=".png", grayscale=False,
        resize_hw=(256, 256), transpose_after_resize=False,
        binarize_mask=False, has_test_dir=False, split_protocol="valsplit",
        train_aug=_mtiles_train,
    ),
    "kosdd2": DatasetSpec(
        name="kosdd2", img_ext=".png", mask_ext=".png", grayscale=False,
        resize_hw=(512, 256), transpose_after_resize=True,
        binarize_mask=True, has_test_dir=True, split_protocol="valsplit",
        train_aug=_kosdd2_train,
    ),
    "ucc_neu": DatasetSpec(  # UCC's own NEU pipeline, weak/strong pair
        name="ucc_neu", img_ext=".jpg", mask_ext=".png", grayscale=False,
        resize_hw=(256, 256), transpose_after_resize=False,
        binarize_mask=False, has_test_dir=True, split_protocol="neu",
        train_aug=_ucc_train, weak_aug=_ucc_weak, strong_aug=_ucc_strong,
    ),
}


def train_test_split(ids: np.ndarray, test_size: float, random_state: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn.model_selection.train_test_split(ids, test_size=test_size,
    random_state=random_state) for a float test_size: (train, test)."""
    n = len(ids)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in the "
                         "(0, 1) range")
    n_test = math.ceil(test_size * n)
    if n - n_test <= 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and "
            "train_size=None, the resulting train set will be empty. "
            "Adjust any of the aforementioned parameters.")
    p = np.random.RandomState(random_state).permutation(n)
    return ids[p[n_test:]], ids[p[:n_test]]


def split_ids(spec: DatasetSpec, train_ids: List[str],
              test_ids: Optional[List[str]], val_fraction: float,
              labeled_fraction: float, seed_val: int, seed_labeled: int):
    """The reference's split chains: dict(labeled, unlabeled, val,
    test)."""
    ids = np.asarray(train_ids)
    if spec.split_protocol == "neu":
        xx_train, x_val = train_test_split(ids, val_fraction, seed_val)
        x_train, x_untrain = train_test_split(
            xx_train, 1.0 - labeled_fraction, seed_labeled)
        # no dedicated test dir: the golden eval reuses the val split
        x_test = np.asarray(test_ids) if test_ids is not None else x_val
    elif spec.split_protocol == "dagm":
        xxt_train, x_test = train_test_split(ids, 0.20, seed_val)
        xt_train, x_val = train_test_split(xxt_train, val_fraction,
                                           seed_labeled)
        x_train, x_untrain = train_test_split(
            xt_train, 1.0 - labeled_fraction, seed_labeled)
    elif spec.split_protocol == "valsplit":
        xx_train, x_val = train_test_split(ids, 0.20, seed_val)
        x_train, x_untrain = train_test_split(
            xx_train, 1.0 - labeled_fraction, seed_labeled)
        x_test = np.asarray(test_ids) if test_ids is not None else x_val
    else:
        raise ValueError(spec.split_protocol)
    return {"labeled": list(x_train), "unlabeled": list(x_untrain),
            "val": list(x_val), "test": list(x_test)}
