"""Fully supervised baseline: loss = 0.5 (CE + Dice) on labelled data only.

The port's `uaps_tpu/methods/baseline.py`: one step is the train-mode
forward, the loss, the backward (kernels where the model routes there),
Adam, and the metrics of the step's logits.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from uaps_tpu_torch.methods import base
from uaps_tpu_torch.ops import segmentation_metrics


init_state = base.init_state


def make_train_step(cfg, model: nn.Module, group=None):
    """(state, batch) -> (state, metrics); batch holds device tensors
    "image" [B, H, W, C] f32 and "label" [B, H, W] int32. The metrics stay
    on the device, and the step makes no host sync (a CUDA graph can
    capture it). With a process group (`group`) it is this rank's step
    (methods/base.py `step_ranks`): the gradients, BN running stats and
    metrics averaged over the ranks where JAX's pmean_if sits."""
    ranks = base.step_ranks(cfg, group)
    n_classes = cfg.data.num_classes
    backend = cfg.model.conv_backend

    def train_step(state: base.TrainState, batch
                   ) -> Tuple[base.TrainState, Dict[str, torch.Tensor]]:
        logits = base.apply_train(model, batch["image"], state.generator)
        ce, dice = base.supervised_ce_dice(logits, batch["label"], backend)
        loss = 0.5 * (ce + dice)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        base.pmean_step_(ranks, [state.optimizer], [model])
        state.optimizer.step()
        with torch.no_grad():
            m = segmentation_metrics(logits, batch["label"], n_classes)
        state.tick()
        return state, base.pmean_metrics(
            {"loss": loss.detach(), "ce_loss": ce.detach(),
             "dice_loss": dice.detach(), "train_miou": m["miou"],
             "train_mdice": m["mdice"]}, ranks)

    return base.in_scope(train_step, ranks)
