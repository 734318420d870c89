"""Carry weights into and out of the port's modules.

  * `state_dict_from_jax(params, batch_stats)`: the JAX package's flax
    trees (nested dicts of numpy arrays) -> a torch state dict under the
    reference's names, for `unet` (top modules `encoder`, `decoder`), the
    multi-decoder nets (`encoder`, `main_decoder`, `aux_decoderN`) and the
    deep-supervision nets (flax `main_decoder`, holding `out_conv_dp1..3`,
    is torch `decoder`, m_unet.py:277);
  * `load_jax_params(model, params, batch_stats)`: load those, strict;
  * `load_pth(model, path)`: a `.pth` file, either a raw state dict or the
    reference's training dict `{'state_dict': ...}`, with or without
    DataParallel's `module.` prefix;
  * `save_pth(model, path, extra)`: the training dict the reference writes.

Name translation (flax -> torch): a ConvBlock's Conv_0 / BatchNorm_0 /
Conv_1 / BatchNorm_1 are `conv_conv.{0,1,4,5}`, `downI/ConvBlock_0` is
`downI.maxpool_conv.1`, `upI/Conv_0` is `upI.conv1x1` and `upI/ConvBlock_0`
is `upI.conv`. Conv kernels go HWIO -> OIHW; BN scale/bias become
weight/bias and the batch stats mean/var running_mean/running_var (with
`num_batches_tracked` 0, which flax does not keep).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn


def _convblock(prefix: str) -> Dict:
    return {"Conv_0": f"{prefix}.conv_conv.0",
            "BatchNorm_0": f"{prefix}.conv_conv.1",
            "Conv_1": f"{prefix}.conv_conv.4",
            "BatchNorm_1": f"{prefix}.conv_conv.5"}


def _encoder() -> Dict:
    m = {"in_conv": _convblock("encoder.in_conv")}
    for i in range(1, 5):
        m[f"down{i}"] = {"ConvBlock_0": _convblock(
            f"encoder.down{i}.maxpool_conv.1")}
    return m


def _decoder(prefix: str) -> Dict:
    m = {f"up{i}": {"Conv_0": f"{prefix}.up{i}.conv1x1",
                    "ConvBlock_0": _convblock(f"{prefix}.up{i}.conv")}
         for i in range(1, 5)}
    m["out_conv"] = f"{prefix}.out_conv"
    return m


def _ds_decoder(prefix: str) -> Dict:
    """Decoder_mcps: `_decoder` and the heads dp1..dp3 (the reference's
    unused out_conv_dp4 is not in JAX's tree either)."""
    m = _decoder(prefix)
    for i in (1, 2, 3):
        m[f"out_conv_dp{i}"] = f"{prefix}.out_conv_dp{i}"
    return m


def _name_map(params) -> Dict:
    m = {}
    for top in params:
        if top == "encoder":
            m[top] = _encoder()
        elif top == "main_decoder" and "out_conv_dp1" in params[top]:
            m[top] = _ds_decoder("decoder")
        elif top == "decoder" or top == "main_decoder" or \
                top.startswith("aux_decoder"):
            m[top] = _decoder(top)
        else:
            raise ValueError(f"no torch mapping for module {top!r}")
    return m


def strip_module(sd: Dict) -> Dict:
    """Remove DataParallel's 'module.' prefix."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """Flax (params, batch_stats) trees -> torch-named state dict."""
    names = _name_map(params)
    out: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    def walk_params(sub_map, sub):
        for k, v in sub.items():
            entry = sub_map[k]
            if "kernel" in v:                           # Conv
                out[f"{entry}.weight"] = t(
                    np.transpose(np.asarray(v["kernel"]), (3, 2, 0, 1)))
                out[f"{entry}.bias"] = t(v["bias"])
            elif "scale" in v:                          # BatchNorm
                out[f"{entry}.weight"] = t(v["scale"])
                out[f"{entry}.bias"] = t(v["bias"])
            else:
                walk_params(entry, v)

    def walk_stats(sub_map, sub):
        for k, v in sub.items():
            entry = sub_map[k]
            if "mean" in v:
                out[f"{entry}.running_mean"] = t(v["mean"])
                out[f"{entry}.running_var"] = t(v["var"])
                out[f"{entry}.num_batches_tracked"] = torch.tensor(
                    0, dtype=torch.int64)
            else:
                walk_stats(entry, v)

    for k, v in params.items():
        walk_params(names[k], v)
    for k, v in batch_stats.items():
        walk_stats(names[k], v)
    return out


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
    """Load a reference, port or JAX-exported checkpoint into `model`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return load_state_dict(model, blob)


def save_pth(model: nn.Module, path: str, extra=None) -> None:
    """Write `{'state_dict': ..., **extra}` with CPU tensors."""
    blob = {"state_dict": {k: v.detach().cpu()
                           for k, v in model.state_dict().items()}}
    blob.update(extra or {})
    torch.save(blob, path)
