"""Carry weights into the port's modules.

  * `state_dict_from_jax(params, batch_stats)`: the JAX package's flax
    trees (numpy arrays) -> a torch state dict under the reference's names,
    through `uaps_tpu.utils.torch_import.export_state_dict`;
  * `load_jax_params(model, params, batch_stats)`: load those, strict;
  * `load_pth(model, path)`: a `.pth` file, either a raw state dict or the
    reference's training dict `{'state_dict': ...}`, with or without
    DataParallel's `module.` prefix (as `uaps_tpu.utils.torch_import`).

A JAX-trained model reaches the port as a `.pth` written by
`uaps_tpu.utils.torch_import.save_pth`; reading Orbax checkpoints without
jax is out of scope.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from uaps_tpu.utils.torch_import import export_state_dict


def strip_module(sd: Dict) -> Dict:
    """Remove DataParallel's 'module.' prefix (UAPS_model.py:13)."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """Flax (params, batch_stats) trees -> torch-named state dict."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in export_state_dict(params, batch_stats).items()}


def load_jax_params(model: nn.Module, params, batch_stats) -> nn.Module:
    model.load_state_dict(state_dict_from_jax(params, batch_stats),
                          strict=True)
    return model


def load_state_dict(model: nn.Module, sd: Dict) -> nn.Module:
    """Load a raw or `{'state_dict': ...}` dict, 'module.'-prefixed or not,
    with strict=True."""
    sd = sd.get("state_dict", sd)
    model.load_state_dict(strip_module(sd), strict=True)
    return model


def load_pth(model: nn.Module, path: str) -> nn.Module:
    """Load a reference or `save_pth` checkpoint file into `model`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return load_state_dict(model, blob)
