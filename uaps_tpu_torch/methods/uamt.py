"""UAMT: uncertainty-aware mean teacher.

The port's `uaps_tpu/methods/uamt.py`: MT (methods/mt.py) with the
consistency masked by the teacher's uncertainty.
  * the teacher pass for the target, as in MT (it moves the teacher's BN
    running stats);
  * T = uamt_num_samples teacher passes on noised copies of uimage, run as
    ONE train-mode forward of [T B, H, W, C] images; their BN batch stats
    are discarded as JAX discards them: the teacher's running stats are
    copied before the pass and copied back after it;
  * uncertainty = -sum_c pbar log(pbar + 1e-6), pbar the mean softmax of
    the T passes; mask = uncertainty < (0.75 + 2.5 w) ln 2;
  * cons = sum(mask (soft(student(uimage)) - soft(teacher))^2)
    / (2 sum(mask) + 1e-16), with no start gate;
  * w = consistency1 * sigmoid_rampup(step // ramp_iters) (80, not 150).
Then Adam and the EMA of the parameters, as in MT. `batch["tnoise"]` and
`batch["tnoise_T"]` ([T B, H, W, C]), where given, replace the two noise
draws (JAX's hooks).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn

from uaps_tpu_torch.methods import base
from uaps_tpu_torch.methods.mt import (init_state, teacher_noise,  # noqa: F401
                                       teacher_softmax)
from uaps_tpu_torch.ops import segmentation_metrics
from uaps_tpu_torch.parallel.ranks import batch_mean, batch_sum


def uncertainty_samples(state: base.TrainState, rep: torch.Tensor,
                        t: int) -> torch.Tensor:
    """The predictive entropy [B, H, W] of the teacher's mean softmax over
    the T = t passes batched in `rep` ([t B, ...], sample-major), leaving
    the teacher's BN running stats as they were."""
    stats = list(state.ema_model.buffers())
    saved = [b.clone() for b in stats]
    soft = teacher_softmax(state, rep)
    torch._foreach_copy_(stats, saved)
    mean_soft = soft.reshape(t, -1, *soft.shape[1:]).mean(0)
    return -(mean_soft * torch.log(mean_soft + 1e-6)).sum(-1)


def make_train_step(cfg, model: nn.Module, group=None):
    """(state, batch) -> (state, metrics); batch as methods/mt.py's, with
    optionally "tnoise_T" [T B, H, W, C] f32. With a process group
    (`group`) it is this rank's step (methods/base.py `step_ranks`): the
    gradients, BN running stats and metrics averaged over the ranks where
    JAX's pmean_if sits. The teacher's running stats are averaged with the
    student's."""
    ranks = base.step_ranks(cfg, group)
    mcfg = cfg.method
    n_classes = cfg.data.num_classes
    backend = cfg.model.conv_backend
    t = mcfg.uamt_num_samples

    def train_step(state: base.TrainState, batch
                   ) -> Tuple[base.TrainState, Dict[str, torch.Tensor]]:
        uimage = batch["uimage"]
        ema_in = (uimage + batch["tnoise"] if "tnoise" in batch
                  else teacher_noise(state.generator, uimage))
        ema_soft = teacher_softmax(state, ema_in)
        rep = uimage.repeat(t, 1, 1, 1)
        rep = (rep + batch["tnoise_T"] if "tnoise_T" in batch
               else teacher_noise(state.generator, rep, t))
        uncertainty = uncertainty_samples(state, rep, t)

        logits = base.apply_train(model, batch["image"], state.generator)
        un_logits = base.apply_train(model, uimage, state.generator)
        ce, dice = base.supervised_ce_dice(logits, batch["label"], backend)
        sup = 0.5 * (ce + dice)
        w = base.ramp_weight(mcfg.consistency1, state.counter,
                             mcfg.ramp_iters, mcfg.consistency_rampup)
        dist = (torch.softmax(un_logits, -1) - ema_soft) ** 2
        threshold = (0.75 + 2.5 * w) * math.log(2.0)
        mask = (uncertainty < threshold).to(dist.dtype)[..., None]
        cons = (batch_sum(torch.sum(mask * dist))
                / (2.0 * batch_sum(torch.sum(mask)) + 1e-16))
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
            "consistency_w1": w, "mean_uncertainty": batch_mean(uncertainty),
            "train_miou": m["miou"], "train_mdice": m["mdice"]}, ranks)

    return base.in_scope(train_step, ranks)
