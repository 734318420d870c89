"""Fully supervised baseline: loss = 0.5 (CE + Dice) on labelled data only.

The port's `uaps_tpu/methods/baseline.py`: one step is the train-mode
forward, the loss, the backward (kernels where the model routes there),
Adam, and the metrics of the step's logits.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from uaps_tpu_torch.methods import base
from uaps_tpu_torch.ops import segmentation_metrics


def init_state(cfg, device="cuda",
               generator: Optional[torch.Generator] = None
               ) -> Tuple[base.TrainState, nn.Module]:
    model = base.build_model(cfg, device, generator)
    return base.init_model_state(cfg, model), model


def make_train_step(cfg, model: nn.Module):
    """(state, batch) -> (state, metrics); batch holds device tensors
    "image" [B, H, W, C] f32 and "label" [B, H, W] int32. The metrics stay
    on the device."""
    n_classes = cfg.data.num_classes
    backend = cfg.model.conv_backend

    def train_step(state: base.TrainState, batch
                   ) -> Tuple[base.TrainState, Dict[str, torch.Tensor]]:
        logits = base.apply_train(model, batch["image"], state.generator)
        ce, dice = base.supervised_ce_dice(logits, batch["label"], backend)
        loss = 0.5 * (ce + dice)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        with torch.no_grad():
            m = segmentation_metrics(logits, batch["label"], n_classes)
        state.step += 1
        return state, {"loss": loss.detach(), "ce_loss": ce.detach(),
                       "dice_loss": dice.detach(), "train_miou": m["miou"],
                       "train_mdice": m["mdice"]}

    return train_step
