"""Training methods of the port, one module per method, as in
`uaps_tpu/methods`: `init_state(cfg, device) -> (TrainState, model)`,
`make_train_step(cfg, model) -> (state, batch) -> (state, metrics)`, and
`base.make_eval_step` for validation. All eight are ported: `baseline`,
`uaps`, `cct`, `mt`, `uamt` (with the mean teacher in
`TrainState.ema_model`), `cps` (with its second net in
`TrainState.second`), `dct` and `ucc`; each step holds no host value, so a
CUDA graph can capture it (uaps_tpu_torch/dispatch.py)."""
import importlib

from uaps_tpu_torch.methods.base import build_model, resolve_device

METHODS = ("uaps", "baseline", "mt", "uamt", "cps", "cct", "dct", "ucc")


def get_method(name: str):
    """The method's module; ValueError for an unknown name."""
    if name not in METHODS:
        raise ValueError(f"unknown method {name!r}; known: {METHODS}")
    return importlib.import_module(f"uaps_tpu_torch.methods.{name}")


__all__ = ["METHODS", "build_model", "get_method", "resolve_device"]
