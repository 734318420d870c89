"""Model factory: the port's counterpart of `uaps_tpu/models/factory.py`.

Registers the U-Net family (`unet`: baseline, mt, uamt, dct; `unet_uaps`;
`unet_cct`: cct; `unet_ucc`: ucc; `unet_ccps`; the deep-supervision nets
`unet_f`: cps, `unet_g`, `unet_h`) with the JAX factory's keyword
arguments, and initialises the weights as flax does (lecun_normal conv
kernels, zero biases, BN scale 1 / bias 0, running mean 0 / var 1) from an
explicit `torch.Generator`. The ResNet BaseNets come later (ROADMAP.md
Queue A, "Remainder").
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn as nn

from uaps_tpu_torch.models.unet import (Conv3x3, DeepSupervisionUNet,
                                        MultiDecoderUNet, PointwiseConv, UNet,
                                        lecun_normal_)

# name -> constructor(num_classes, in_chns, dtype, **knobs) -> nn.Module
MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {}

_UNPORTED = {
    f"basenet_{bk}": "ROADMAP.md Queue A, 'Remainder' (models/resnet.py)"
    for bk in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")}


def _register(name):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn
    return deco


def _multi(perturbations):
    def make(num_classes, in_chns, dtype, nchw_levels=0,
             conv_backend="auto", head_variant="taps", pool_backend="auto",
             bn_backend="auto", packed_heads=False, dropout_backend="auto",
             conv_variant="taps"):
        return MultiDecoderUNet(
            num_classes, perturbations, in_chns, dtype, nchw_levels,
            conv_backend, head_variant, pool_backend, bn_backend,
            packed_heads, dropout_backend, conv_variant)
    return make


@_register("unet")
def _unet(num_classes, in_chns, dtype, nchw_levels=0, conv_backend="auto",
          head_variant="taps", pool_backend="auto", bn_backend="auto",
          dropout_backend="auto", conv_variant="taps"):
    return UNet(num_classes, in_chns, dtype, nchw_levels, conv_backend,
                head_variant, pool_backend, bn_backend, dropout_backend,
                conv_variant)


@_register("unet_uaps")
def _unet_uaps(num_classes, in_chns, dtype, n_aux=3, **kw):
    """UAPS net; the aux perturbation kinds cycle through the reference
    order, as in the JAX factory."""
    base = ("feature_noise", "dropout", "feature_dropout")
    kinds = tuple(base[i % 3] for i in range(n_aux))
    return _multi(kinds)(num_classes, in_chns, dtype, **kw)


# arch-identical to unet_uaps (CCT/CCT_unet.py:261-286)
MODEL_REGISTRY["unet_cct"] = _multi(
    ("feature_noise", "dropout", "feature_dropout"))
MODEL_REGISTRY["unet_ucc"] = _multi(("feature_noise",))
MODEL_REGISTRY["unet_ccps"] = _multi(("feature_dropout",))


def _deep_supervision(perturbation):
    """JAX passes these nets only conv_backend, conv_variant and remat
    (which the port ignores: ROADMAP.md Queue A, 'Remainder')."""
    def make(num_classes, in_chns, dtype, conv_backend="auto",
             conv_variant="taps"):
        return DeepSupervisionUNet(num_classes, perturbation, in_chns, dtype,
                                   conv_backend, conv_variant)
    return make


# m_unet.py UNet_f (cps), UNet_g, UNet_h
MODEL_REGISTRY["unet_f"] = _deep_supervision("none")
MODEL_REGISTRY["unet_g"] = _deep_supervision("feature_dropout")
MODEL_REGISTRY["unet_h"] = _deep_supervision("feature_noise")


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers, drawn from `generator` in module order."""
    for m in model.modules():
        if isinstance(m, (Conv3x3, PointwiseConv)):
            lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def net_factory(net_type: str, in_chns: int = 3, class_num: int = 4,
                dtype: torch.dtype = torch.float32, *,
                generator: torch.Generator, **kwargs: Any) -> nn.Module:
    """Build a model by name on the CPU and initialise it from `generator`.
    Unlike flax, torch sizes the first conv up front, so `in_chns` is
    used."""
    if net_type in _UNPORTED:
        raise NotImplementedError(
            f"{net_type!r} is not ported yet: {_UNPORTED[net_type]}")
    if net_type not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown net_type {net_type!r}; known: {sorted(MODEL_REGISTRY)}")
    model = MODEL_REGISTRY[net_type](class_num, in_chns, dtype, **kwargs)
    init_weights(model, generator)
    return model
