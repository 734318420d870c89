"""The port's copy of the JAX package's config tree and presets.

Same dataclasses, fields, defaults and presets as `uaps_tpu/utils/config.py`
(a CPU test holds the two equal field by field), so a flag or preset means
the same thing to both packages. The model knobs name the JAX package's
kernel variants; the port maps every Pallas conv variant to its one CUDA
conv (models/unet.py). One difference: the port discovers a dataset's
image/mask roots only under `$UAPS_DATA_ROOT/<dataset>`, never under a
default directory of its own.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class DataConfig:
    name: str = "synthetic"    # synthetic | neu | dagm | mtiles | kosdd2
    image_root: str = ""
    mask_root: str = ""
    test_image_root: str = ""
    test_mask_root: str = ""
    num_classes: int = 4
    in_channels: int = 3
    image_size: Tuple[int, int] = (256, 256)   # (H, W)
    batch_size: int = 16
    # split protocol: val split first (seed 69), then labeled/unlabeled
    # split (seed 45); labeled_fraction = 1 - test_size of the second split
    val_fraction: float = 0.15
    labeled_fraction: float = 0.10
    split_seed_val: int = 69
    split_seed_labeled: int = 45
    mean: Tuple[float, ...] = (0.485, 0.456, 0.406)
    std: Tuple[float, ...] = (0.229, 0.224, 0.225)
    shuffle_seed: int = 1337
    num_workers: int = 8
    transpose_to_landscape: bool = False   # KoSDD2 portrait -> landscape
    binarize_mask: bool = False            # KoSDD2: (mask/255).long()


@dataclasses.dataclass
class ModelConfig:
    name: str = "unet_uaps"
    n_aux: int = 3
    compute_dtype: str = "float32"     # float32 | bfloat16
    remat: bool = False
    stack_decoders: bool = False
    # the first N resolution levels run the kernel conv and pool
    nchw_levels: int = 2
    conv_backend: str = "auto"         # auto | fused | chain | xla (plain)
    conv_variant: str = dataclasses.field(
        default_factory=lambda: os.environ.get("UAPS_CONV_VARIANT",
                                               "dwmf"))
    head_variant: str = dataclasses.field(
        default_factory=lambda: os.environ.get("UAPS_HEAD_VARIANT",
                                               "dwmf"))
    packed_heads: bool = False
    dropout_backend: str = "auto"      # auto | xla (plain) | pallas (kernel)
    pool_backend: str = "auto"         # auto | pallas | maskpool | xla
    bn_backend: str = "auto"           # auto | 4d | flat


@dataclasses.dataclass
class MethodConfig:
    name: str = "uaps"  # uaps|baseline|mt|uamt|cps|cct|dct|ucc
    consistency1: float = 0.1
    consistency2: float = 0.1
    consistency_rampup: float = 200.0
    ramp_iters: int = 80
    ema_decay: float = 0.99
    consistency_start_iter: int = 1000
    uamt_num_samples: int = 8
    dynamic_mixing: bool = True
    uncertainty_gate: bool = True
    decoder_consistency_weight: float = 0.0
    unramped_uncertainty: bool = False
    fused_batch: bool = False
    fused_uncertainty: bool = True


@dataclasses.dataclass
class OptimConfig:
    base_lr: float = 1e-3
    # ReduceLROnPlateau(mode=max, patience=50, factor=0.1, min_lr=1e-8)
    plateau_patience: int = 50
    plateau_factor: float = 0.1
    min_lr: float = 1e-8
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass
class RunConfig:
    epochs: int = 800
    iter_per_epoch: int = 60
    seed: int = 1337
    out_dir: str = "runs/default"
    keep_checkpoints: int = 2
    log_every: int = 20
    save_every: int = 0
    prng_impl: str = "threefry2x32"
    use_shard_map: Optional[bool] = None
    halt_on_nan: bool = True
    early_stop_patience: int = 0
    debug_nans: bool = False
    profile_steps: Optional[Tuple[int, int]] = None
    steps_per_dispatch: int = 0
    device_pools: bool = False


@dataclasses.dataclass
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    method: MethodConfig = dataclasses.field(default_factory=MethodConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)


def _discover_roots(data: DataConfig) -> DataConfig:
    """Fill empty image/mask roots from `$UAPS_DATA_ROOT/<dataset>/images`
    (+ `annotations`, and `test_images`/`test_annotations` when both
    exist), the layout scripts/prepare_data.py writes."""
    base_dir = os.environ.get("UAPS_DATA_ROOT")
    if data.image_root or not base_dir:
        return data
    base = os.path.join(base_dir, data.name)
    img = os.path.join(base, "images")
    if not os.path.isdir(img):
        return data
    kw = dict(image_root=img, mask_root=os.path.join(base, "annotations"))
    t = os.path.join(base, "test_images")
    ta = os.path.join(base, "test_annotations")
    if os.path.isdir(t) and os.path.isdir(ta):
        kw.update(test_image_root=t, test_mask_root=ta)
    return dataclasses.replace(data, **kw)


def _model_for(method: str) -> str:
    return {
        "uaps": "unet_uaps", "baseline": "unet", "mt": "unet",
        "uamt": "unet", "cps": "unet_f", "cct": "unet_cct",
        "dct": "unet", "ucc": "unet_ucc",
    }[method]


def _neu(method: str = "uaps") -> Config:
    """NEU-Seg 10% labeled."""
    return Config(
        data=_discover_roots(
            DataConfig(name="neu", num_classes=4, in_channels=3,
                       batch_size=16, labeled_fraction=0.10)),
        model=ModelConfig(name=_model_for(method)),
        method=MethodConfig(name=method),
    )


def _dagm() -> Config:
    """DAGM: 7 classes, grayscale, 10% labeled."""
    return Config(
        data=_discover_roots(DataConfig(
            name="dagm", num_classes=7, in_channels=1, batch_size=16,
            labeled_fraction=0.10, mean=(0.5314,), std=(0.1357,),
        )),
        model=ModelConfig(name="unet_uaps"),
        method=MethodConfig(name="uaps"),
    )


def _mtiles() -> Config:
    """MTiles: 6 classes, 40% labeled, lr 2e-3, 20 iterations an epoch."""
    return Config(
        data=_discover_roots(
            DataConfig(name="mtiles", num_classes=6, batch_size=16,
                       labeled_fraction=0.40)),
        model=ModelConfig(name="unet_uaps"),
        method=MethodConfig(name="uaps", decoder_consistency_weight=0.0,
                            unramped_uncertainty=True),
        optim=OptimConfig(base_lr=2e-3),
        run=RunConfig(iter_per_epoch=20),
    )


def _kosdd2() -> Config:
    """KolektorSDD2: binary, 512x256 -> landscape, 40% labeled, bs 12,
    lr 2e-3, rampup 150."""
    return Config(
        data=_discover_roots(
            DataConfig(name="kosdd2", num_classes=2, batch_size=12,
                       image_size=(256, 512), labeled_fraction=0.40,
                       transpose_to_landscape=True, binarize_mask=True)),
        model=ModelConfig(name="unet_uaps"),
        method=MethodConfig(name="uaps", consistency_rampup=150.0),
        optim=OptimConfig(base_lr=2e-3),
        run=RunConfig(iter_per_epoch=20),
    )


def _synthetic(method: str = "uaps") -> Config:
    cfg = _neu(method)
    cfg.data = dataclasses.replace(
        cfg.data, name="synthetic", image_size=(64, 64), batch_size=8)
    cfg.run = dataclasses.replace(cfg.run, epochs=3, iter_per_epoch=5,
                                  out_dir="runs/synthetic")
    return cfg


PRESETS = {
    "neu": _neu,
    "dagm": _dagm,
    "mtiles": _mtiles,
    "kosdd2": _kosdd2,
    "synthetic": _synthetic,
}


def preset(name: str, **kwargs) -> Config:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; known: {sorted(PRESETS)}")
    return PRESETS[name](**kwargs)
