"""Loss, metric, ramp and perturbation functions of the port (NHWC logits,
integer labels, NCHW features)."""
from uaps_tpu_torch.ops.losses import (cross_entropy_loss, kl_divergence_map,
                                       softmax_dice_loss, symmetric_mse_loss)
from uaps_tpu_torch.ops.metrics import (mean_dice, per_class_iou,
                                        segmentation_metrics)
from uaps_tpu_torch.ops.ramps import (cosine_rampdown, linear_rampup,
                                      sigmoid_rampup)

__all__ = ["cross_entropy_loss", "softmax_dice_loss", "kl_divergence_map",
           "symmetric_mse_loss", "mean_dice", "per_class_iou",
           "segmentation_metrics", "sigmoid_rampup", "linear_rampup",
           "cosine_rampdown"]
