"""Segmentation losses: the port's part of `uaps_tpu/ops/losses.py` that the
supervised, UAPS and eval steps use. CE and Dice are also the plain pair
that `methods.base.supervised_ce_dice` takes where the fused CE+Dice kernel
is not used; `kl_divergence_map` is the plain uncertainty map beside the
fused uncertainty kernel.

Conventions (as in JAX): logits [..., C] float, labels [...] integer.
"""
from __future__ import annotations

import torch


def _one_hot(labels: torch.Tensor, c: int, dtype) -> torch.Tensor:
    """jax.nn.one_hot: an all-zero row for a label outside [0, C)."""
    return (labels[..., None] == torch.arange(c, device=labels.device)
            ).to(dtype)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Multi-class CE, mean over pixels (torch.nn.CrossEntropyLoss
    semantics); labels are clipped to [0, C-1] as in JAX."""
    c = logits.shape[-1]
    log_probs = torch.log_softmax(logits, dim=-1)
    one_hot = _one_hot(labels.clamp(0, c - 1), c, log_probs.dtype)
    return -(log_probs * one_hot).sum(-1).mean()


def softmax_dice_loss(logits: torch.Tensor, labels: torch.Tensor,
                      eps: float = 1e-7) -> torch.Tensor:
    """Soft Dice loss over C >= 2 classes: per-class intersection and
    cardinality summed over batch and space, dice averaged over classes
    (background included), 1 - dice; eps in the denominator only."""
    probs = torch.softmax(logits, dim=-1)
    one_hot = _one_hot(labels, logits.shape[-1], logits.dtype)
    dims = tuple(range(probs.ndim - 1))
    intersection = (probs * one_hot).sum(dims)
    cardinality = (probs + one_hot).sum(dims)
    return 1.0 - torch.mean(2.0 * intersection / (cardinality + eps))


def symmetric_mse_loss(input1: torch.Tensor,
                       input2: torch.Tensor) -> torch.Tensor:
    """mean((a - b)^2), gradients to both sides."""
    return torch.mean((input1 - input2) ** 2)


def kl_divergence_map(logits: torch.Tensor,
                      target_probs: torch.Tensor) -> torch.Tensor:
    """Per-pixel KL uncertainty map sum_c p_c (log p_c - log_softmax(x)_c),
    the class axis reduced. xlogy gives 0 log 0 = 0. Gradients flow
    through BOTH arguments (the reference never detaches the decoders'
    mean prediction)."""
    logq = torch.log_softmax(logits, dim=-1)
    p = target_probs
    return (torch.xlogy(p, p) - p * logq).sum(-1)
