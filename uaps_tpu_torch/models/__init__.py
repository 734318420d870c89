"""The U-Net family (eval and train mode) and its factory."""
from uaps_tpu_torch.models.factory import MODEL_REGISTRY, net_factory

__all__ = ["MODEL_REGISTRY", "net_factory"]
