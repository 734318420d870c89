"""CCT: cross-consistency training over the multi-decoder net.

The port's `uaps_tpu/methods/cct.py`. One step, on `unet_cct` (the main
decoder and three perturbed auxiliary decoders):
  sup  = (sum_d CE_d + sum_d Dice_d) / (2 D)          (labelled batch)
  cons = mean over the aux decoders of mean((soft_main - soft_aux)^2),
         symmetric: neither side is detached (the reference takes none)
  loss = sup + w(t) cons, w = consistency1 * sigmoid_rampup(step // 150)
then Adam. The labelled and unlabelled forwards run one after the other in
train mode, so the second continues the first's BN running stats. Every
draw (dropout and perturbation seeds) comes from `state.generator`, and
the ramp weight from the device counter: the step holds no host value.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from uaps_tpu_torch.methods import base
from uaps_tpu_torch.ops import segmentation_metrics, symmetric_mse_loss


init_state = base.init_state


def make_train_step(cfg, model: nn.Module, group=None):
    """(state, batch) -> (state, metrics); batch holds device tensors
    "image" and "uimage" [B, H, W, C] f32 and "label" [B, H, W] int32.
    With a process group (`group`) it is
    this rank's step (methods/base.py `step_ranks`): the gradients, BN
    running stats and metrics averaged over the ranks where JAX's pmean_if
    sits."""
    ranks = base.step_ranks(cfg, group)
    mcfg = cfg.method
    n_classes = cfg.data.num_classes
    backend = cfg.model.conv_backend

    def train_step(state: base.TrainState, batch
                   ) -> Tuple[base.TrainState, Dict[str, torch.Tensor]]:
        outs = base.apply_train(model, batch["image"], state.generator)
        un_outs = base.apply_train(model, batch["uimage"], state.generator)
        labels = batch["label"]
        pairs = [base.supervised_ce_dice(o, labels, backend) for o in outs]
        ces = [p[0] for p in pairs]
        dices = [p[1] for p in pairs]
        sup = (sum(ces) + sum(dices)) / (2 * len(outs))
        softs = [torch.softmax(o, -1) for o in un_outs]
        cons = sum(symmetric_mse_loss(softs[0], s)
                   for s in softs[1:]) / (len(softs) - 1)
        w = base.ramp_weight(mcfg.consistency1, state.counter, 150,
                             mcfg.consistency_rampup)
        loss = sup + w * cons

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        base.pmean_step_(ranks, [state.optimizer], [model])
        state.optimizer.step()
        with torch.no_grad():
            m = segmentation_metrics(outs[0], labels, n_classes)
        state.tick()
        return state, base.pmean_metrics({
            "loss": loss.detach(), "ce_loss": (sum(ces) / len(ces)).detach(),
            "dice_loss": (sum(dices) / len(dices)).detach(),
            "consistency_loss": cons.detach(), "consistency_w1": w,
            "train_miou": m["miou"], "train_mdice": m["mdice"]}, ranks)

    return base.in_scope(train_step, ranks)
