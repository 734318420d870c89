"""Model construction from a config: the port's part of
`uaps_tpu/methods/base.py` that serving needs (`build_model` and its enum
validation). The optimizer, the supervised loss and the train/eval steps
come with the training slice (ROADMAP.md Queue A items 4-5)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from uaps_tpu_torch.models import net_factory

# Accepted values of the ModelConfig enum knobs; a test holds this equal
# to uaps_tpu.methods.base._MODEL_ENUMS.
_MODEL_ENUMS = {
    "conv_backend": {"auto", "fused", "chain", "xla"},
    "conv_variant": {"taps", "im2col", "dhdw", "flat", "dwout", "dwnp",
                     "dwm", "dwmf", "fullh"},
    "head_variant": {"taps", "im2col", "dhdw", "dwnp", "dwm", "dwmf",
                     "xla"},
    "dropout_backend": {"auto", "xla", "pallas"},
    "pool_backend": {"auto", "pallas", "maskpool", "xla"},
    "bn_backend": {"auto", "4d", "flat"},
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device that is not there
    (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev


def build_model(cfg, device, generator: Optional[torch.Generator] = None
                ) -> nn.Module:
    """The config's model in eval mode on `device`, initialised from
    `generator` (default: seeded with cfg.run.seed)."""
    for field, allowed in _MODEL_ENUMS.items():
        v = getattr(cfg.model, field)
        if v not in allowed:
            raise ValueError(f"ModelConfig.{field}={v!r}; "
                             f"expected one of {sorted(allowed)}")
    if cfg.model.stack_decoders:
        raise NotImplementedError(
            "stack_decoders is not ported yet: ROADMAP.md Queue A item 10")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.run.seed)
    # the knobs the eval forward reads: every Pallas conv variant is the
    # one CUDA conv, dropout is the identity in eval, and remat only
    # trades memory in the backward
    m = cfg.model
    kwargs = {"nchw_levels": m.nchw_levels, "conv_backend": m.conv_backend,
              "head_variant": m.head_variant,
              "pool_backend": m.pool_backend, "bn_backend": m.bn_backend}
    if m.name == "unet_uaps":
        kwargs["n_aux"] = m.n_aux
    if m.name in ("unet_uaps", "unet_cct", "unet_ucc", "unet_ccps"):
        kwargs["packed_heads"] = m.packed_heads
    model = net_factory(m.name, in_chns=cfg.data.in_channels,
                        class_num=cfg.data.num_classes,
                        dtype=_DTYPES[m.compute_dtype],
                        generator=generator, **kwargs)
    return model.to(dev).eval()
