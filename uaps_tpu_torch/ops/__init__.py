"""Loss and metric functions of the port (NHWC logits, integer labels)."""
from uaps_tpu_torch.ops.losses import cross_entropy_loss, softmax_dice_loss
from uaps_tpu_torch.ops.metrics import mean_dice, segmentation_metrics

__all__ = ["cross_entropy_loss", "softmax_dice_loss", "mean_dice",
           "segmentation_metrics"]
