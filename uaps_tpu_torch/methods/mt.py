"""Mean Teacher: student / EMA-teacher consistency.

The port's `uaps_tpu/methods/mt.py`. One step, on `unet`:
  teacher = the EMA model (TrainState.ema_model), in train mode under
            no_grad on uimage + clamp(N(0, 0.1), -0.2, 0.2); its forward
            moves its own BN running stats
  sup     = 0.5 (CE + Dice) on the labelled batch
  cons    = mean((soft(student(uimage)) - soft(teacher))^2), 0 while
            step < consistency_start_iter (a device-side select)
  loss    = sup + w(t) cons, w = consistency1 * sigmoid_rampup(step // 150)
then Adam, then the EMA of the parameters with alpha = min(1 - 1/(step +
1), ema_decay) (base.ema_update). The student's labelled and unlabelled
forwards run one after the other in train mode (BN stats continue). Every
draw (the teacher's noise, dropout seeds) comes from `state.generator`, and
the gate, the ramp and alpha from the device counter: the step holds no
host value. `batch["tnoise"]`, where given, replaces the teacher's noise
draw (JAX's hook, with which the tests feed both packages one draw).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from uaps_tpu_torch.methods import base
from uaps_tpu_torch.ops import segmentation_metrics
from uaps_tpu_torch.parallel.ranks import batch_mean, rows


def init_state(cfg, device="cuda",
               generator: Optional[torch.Generator] = None
               ) -> Tuple[base.TrainState, nn.Module]:
    """The student, its state, and the teacher as a copy of the student."""
    model = base.build_model(cfg, device, generator)
    state = base.init_model_state(cfg, model)
    state.ema_model = base.make_teacher(model)
    return state, model


def teacher_noise(generator: torch.Generator, x: torch.Tensor,
                  samples: int = 1) -> torch.Tensor:
    """x + clamp(N(0, 0.1), -0.2, 0.2), drawn from `generator`; x holds
    `samples` copies of the batch, sample-major (uamt's T-pass). On ranks,
    the rank's rows of the draw over the global batch (parallel/ranks.py
    `rows`)."""
    b, tail = x.shape[0] // samples, x.shape[1:]

    def draw(nb):
        return torch.randn((samples * nb, *tail), generator=generator,
                           device=x.device, dtype=x.dtype).view(
                               samples, nb, *tail)

    n = rows(draw, b, dim=1).reshape(x.shape)
    return x + torch.clamp(n * 0.1, -0.2, 0.2)


def teacher_softmax(state: base.TrainState, x: torch.Tensor) -> torch.Tensor:
    """The teacher's softmax on x: one train-mode forward (moving the
    teacher's BN running stats) under no_grad."""
    with torch.no_grad():
        return torch.softmax(base.apply_train(state.ema_model, x,
                                              state.generator), -1)


def make_train_step(cfg, model: nn.Module, group=None):
    """(state, batch) -> (state, metrics); batch holds device tensors
    "image" and "uimage" [B, H, W, C] f32, "label" [B, H, W] int32 and
    optionally "tnoise" [B, H, W, C] f32. With a process group (`group`) it is
    this rank's step (methods/base.py `step_ranks`): the gradients, BN
    running stats and metrics averaged over the ranks where JAX's pmean_if
    sits. The teacher's
    running stats are averaged with the student's."""
    ranks = base.step_ranks(cfg, group)
    mcfg = cfg.method
    n_classes = cfg.data.num_classes
    backend = cfg.model.conv_backend

    def train_step(state: base.TrainState, batch
                   ) -> Tuple[base.TrainState, Dict[str, torch.Tensor]]:
        uimage = batch["uimage"]
        ema_in = (uimage + batch["tnoise"] if "tnoise" in batch
                  else teacher_noise(state.generator, uimage))
        ema_soft = teacher_softmax(state, ema_in)

        logits = base.apply_train(model, batch["image"], state.generator)
        un_logits = base.apply_train(model, uimage, state.generator)
        ce, dice = base.supervised_ce_dice(logits, batch["label"], backend)
        sup = 0.5 * (ce + dice)
        cons = batch_mean((torch.softmax(un_logits, -1) - ema_soft) ** 2)
        cons = torch.where(state.counter < mcfg.consistency_start_iter,
                           0.0, cons)
        w = base.ramp_weight(mcfg.consistency1, state.counter, 150,
                             mcfg.consistency_rampup)
        loss = sup + w * cons

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        base.pmean_step_(ranks, [state.optimizer], [model, state.ema_model])
        state.optimizer.step()
        base.ema_update(model, state.ema_model, mcfg.ema_decay,
                        state.counter)
        with torch.no_grad():
            m = segmentation_metrics(logits, batch["label"], n_classes)
        state.tick()
        return state, base.pmean_metrics({
            "loss": loss.detach(), "ce_loss": ce.detach(),
            "dice_loss": dice.detach(), "consistency_loss": cons.detach(),
            "consistency_w1": w, "train_miou": m["miou"],
            "train_mdice": m["mdice"]}, ranks)

    return base.in_scope(train_step, ranks)
