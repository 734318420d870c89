"""Training methods of the port; so far only model construction."""
from uaps_tpu_torch.methods.base import build_model, resolve_device

__all__ = ["build_model", "resolve_device"]
