"""Segmentation metrics on the device: the port's `uaps_tpu/ops/metrics.py`.

As in JAX: the prediction is the argmax over classes; a class absent from
the label map contributes NaN, and the mean over classes 1..C-1 (background
excluded) ignores NaN; smooth = 1e-10 in numerator and denominator.
"""
from __future__ import annotations

from typing import Dict

import torch


def _class_counts(pred: torch.Tensor, label: torch.Tensor, n: int):
    """Per-class (intersection, pred count, label count), f32 [n] each."""
    classes = torch.arange(n, device=pred.device)
    p = (pred.reshape(-1, 1) == classes).float()
    lab = (label.reshape(-1, 1) == classes).float()
    return (p * lab).sum(0), p.sum(0), lab.sum(0)


def _iou(intersect, pred_count, label_count, smooth):
    union = pred_count + label_count - intersect
    return torch.where(label_count > 0,
                       (intersect + smooth) / (union + smooth), torch.nan)


def _dice(intersect, pred_count, label_count, smooth):
    union = pred_count + label_count - intersect
    dice = 2.0 * (intersect + smooth) / (union + intersect + smooth)
    return torch.where(label_count > 0, dice, torch.nan)


def mean_dice(logits: torch.Tensor, label: torch.Tensor, n_classes: int,
              smooth: float = 1e-10) -> torch.Tensor:
    """NaN-mean over classes 1..C-1 of 2 (I + s) / (U + I + s)."""
    counts = _class_counts(torch.argmax(logits, dim=-1), label, n_classes)
    return torch.nanmean(_dice(*counts, smooth)[1:])


def per_class_iou(logits: torch.Tensor, label: torch.Tensor, n_classes: int,
                  smooth: float = 1e-10) -> torch.Tensor:
    """[n_classes] IoU of each class, background included; NaN where the
    class is absent from `label` (JAX metrics.py:47-58)."""
    counts = _class_counts(torch.argmax(logits, dim=-1), label, n_classes)
    return _iou(*counts, smooth)


def segmentation_metrics(logits: torch.Tensor, label: torch.Tensor,
                         n_classes: int, smooth: float = 1e-10
                         ) -> Dict[str, torch.Tensor]:
    """{'miou', 'mdice', 'pixel_acc'} from one pass of class counts."""
    pred = torch.argmax(logits, dim=-1)
    counts = _class_counts(pred, label, n_classes)
    dice, iou = _dice(*counts, smooth), _iou(*counts, smooth)
    return {"miou": torch.nanmean(iou[1:]),
            "mdice": torch.nanmean(dice[1:]),
            "pixel_acc": (pred == label).float().mean()}
