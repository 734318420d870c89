"""Training methods of the port, one module per method, as in
`uaps_tpu/methods`: `init_state(cfg, device) -> (TrainState, model)`,
`make_train_step(cfg, model) -> (state, batch) -> (state, metrics)`, and
`base.make_eval_step` for validation. `baseline` and `uaps` are ported."""
import importlib

from uaps_tpu_torch.methods.base import build_model, resolve_device

METHODS = ("uaps", "baseline", "mt", "uamt", "cps", "cct", "dct", "ucc")
_PORTED = ("baseline", "uaps")


def get_method(name: str):
    """The method's module; NotImplementedError for a method not ported."""
    if name not in METHODS:
        raise ValueError(f"unknown method {name!r}; known: {METHODS}")
    if name not in _PORTED:
        raise NotImplementedError(
            f"method {name!r} is not ported yet: ROADMAP.md Queue A, "
            "'The other methods'")
    return importlib.import_module(f"uaps_tpu_torch.methods.{name}")


__all__ = ["METHODS", "build_model", "get_method", "resolve_device"]
