"""Model factory: the port's counterpart of `uaps_tpu/models/factory.py`.

Registers the U-Net family (`unet`: baseline, mt, uamt, dct; `unet_uaps`;
`unet_cct`: cct; `unet_ucc`: ucc; `unet_ccps`; the deep-supervision nets
`unet_f`: cps, `unet_g`, `unet_h`) with the JAX factory's keyword
arguments, and the ResNet BaseNets (`basenet_resnet18` ... `_resnet152`,
models/resnet.py), which ignore the U-Net knobs as JAX's `make` does
(factory.py:158-163). Initialises the weights as flax does from an
explicit `torch.Generator`: the U-Nets' conv kernels lecun_normal with zero
biases; the ResNet trunk and the head's 3x3 conv JAX's `_kaiming`
(truncated normal, fan_out, scale 2.0), the head's f32 1x1 conv flax's
default (lecun_normal, zero bias); BN scale 1 / bias 0, running mean 0 /
var 1.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
import torch.nn as nn

from uaps_tpu_torch.models import resnet
from uaps_tpu_torch.models.unet import (Conv3x3, DeepSupervisionUNet,
                                        MultiDecoderUNet, PointwiseConv, UNet,
                                        lecun_normal_)

# name -> constructor(num_classes, in_chns, dtype, **knobs) -> nn.Module
MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {}


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


def _basenet(backbone):
    def make(num_classes, in_chns, dtype, **knobs):
        del knobs   # the trunk has no kernel knobs (JAX factory.py:158-163)
        return resnet.BaseNet(backbone, num_classes, in_chns, dtype)
    return make


for _bk in resnet.BACKBONES:
    MODEL_REGISTRY[f"basenet_{_bk}"] = _basenet(_bk)


def kaiming_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """JAX `_kaiming` on a torch conv weight [Cout, Cin, kh, kw]:
    variance_scaling(2.0, "fan_out", "truncated_normal"), a normal
    truncated at 2 std with std = sqrt(2 / fan_out) / 0.8796..."""
    fan_out = t.shape[0] * math.prod(t.shape[2:])
    std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers, drawn from `generator` in module order."""
    for m in model.modules():
        if isinstance(m, (Conv3x3, PointwiseConv)) or (
                isinstance(m, resnet.Conv2d) and m.init == "lecun"):
            lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, resnet.Conv2d):
            kaiming_normal_(m.weight, generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def net_factory(net_type: str, in_chns: int = 3, class_num: int = 4,
                dtype: torch.dtype = torch.float32, *,
                generator: torch.Generator, **kwargs: Any) -> nn.Module:
    """Build a model by name on the CPU and initialise it from `generator`.
    Unlike flax, torch sizes the first conv up front, so `in_chns` is
    used."""
    if net_type not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown net_type {net_type!r}; known: {sorted(MODEL_REGISTRY)}")
    model = MODEL_REGISTRY[net_type](class_num, in_chns, dtype, **kwargs)
    init_weights(model, generator)
    return model
