"""UCC: uncertainty-aware cross-head cross-augmentation with CutMix.

The port's `uaps_tpu/methods/ucc.py`. One step, on `unet_ucc` (a main
head and a feature-noise auxiliary head):
  data   the labelled batch CutMixed within itself (p = 0.2), and the
         labelled images cross-CutMixed into the weak and strong unlabelled
         views (p = 0.3, one mask and gate a weak / strong pair), on the
         device (ops/cutmix.py)
  sup    = 0.5 (CE + Dice)(head 1) + 0.5 (CE + Dice)(head 2), mixed labels
  var_1  = KL(soft(u2_st) || soft(u1_wk)), var_2 = KL(soft(u2_wk) ||
           soft(u1_st)): cross-head and cross-augmentation, per pixel
  pseudo_1 = argmax soft(u2_wk), pseudo_2 = argmax soft(u1_wk), detached
  ps_i   = 0.5 (CE + Dice)(u_i_st, pseudo_i) * mean(exp(-var_i))
           + mean(var_i)   (the reference's scalar-loss-times-mean-gate)
  loss   = sup + w(t) (ps_1 + ps_2), w = consistency1 *
           sigmoid_rampup(step // 150)
then Adam. The three forwards (mixed labelled, weak, strong) run one after
the other in train mode, each continuing the last's BN running stats. The
metrics are taken on the mixed labels. Every draw (the mixes, dropout and
noise seeds) comes from `state.generator`: the step holds no host value.
`batch["mix_img_l"]`, `"mix_lab_l"`, `"mix_wk"` and `"mix_st"`, where
given, replace the mixes (JAX's hooks).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from uaps_tpu_torch.methods import base
from uaps_tpu_torch.ops import kl_divergence_map, segmentation_metrics
from uaps_tpu_torch.ops.cutmix import generate_crossmix_data, \
    generate_mix_data
from uaps_tpu_torch.parallel.ranks import batch_mean


init_state = base.init_state


def mixed_batch(state: base.TrainState, batch):
    """(labelled images, their labels, weak, strong) after the mixes, or
    the hooks' arrays."""
    if "mix_img_l" in batch:
        return (batch["mix_img_l"], batch["mix_lab_l"], batch["mix_wk"],
                batch["mix_st"])
    img_l, lab_l = generate_mix_data(state.generator, batch["image"],
                                     batch["label"], p=0.2)
    wk, st = generate_crossmix_data(state.generator, img_l, batch["uimage"],
                                    batch["uimage_strong"], p=0.3)
    return img_l, lab_l, wk, st


def make_train_step(cfg, model: nn.Module, group=None):
    """(state, batch) -> (state, metrics); batch holds device tensors "image",
    "uimage" and "uimage_strong" [B, H, W, C] f32 and "label" [B, H, W]
    int32 (or the four mix hooks). With a process group (`group`) it is
    this rank's step (methods/base.py `step_ranks`): the gradients, BN
    running stats and metrics averaged over the ranks where JAX's pmean_if
    sits. CutMix pastes within a rank's rows in both modes (JAX's shard_map
    mode does so within a device's)."""
    ranks = base.step_ranks(cfg, group)
    mcfg = cfg.method
    n_classes = cfg.data.num_classes
    backend = cfg.model.conv_backend

    def ce_dice(logits, labels):
        ce, dice = base.supervised_ce_dice(logits, labels, backend)
        return ce, dice, 0.5 * (ce + dice)

    def train_step(state: base.TrainState, batch
                   ) -> Tuple[base.TrainState, Dict[str, torch.Tensor]]:
        img_l, lab_l, wk, st = mixed_batch(state, batch)
        o1, o2 = base.apply_train(model, img_l, state.generator)
        u1_wk, u2_wk = base.apply_train(model, wk, state.generator)
        u1_st, u2_st = base.apply_train(model, st, state.generator)

        ce1, dice1, sup1 = ce_dice(o1, lab_l)
        ce2, dice2, sup2 = ce_dice(o2, lab_l)
        sup = sup1 + sup2
        s1_wk = torch.softmax(u1_wk, -1)
        s2_wk = torch.softmax(u2_wk, -1)
        s2_st = torch.softmax(u2_st, -1)
        var_1 = kl_divergence_map(u1_wk, s2_st)
        var_2 = kl_divergence_map(u1_st, s2_wk)
        pseudo_1 = s2_wk.detach().argmax(-1).to(torch.int32)
        pseudo_2 = s1_wk.detach().argmax(-1).to(torch.int32)
        ps_1 = (ce_dice(u1_st, pseudo_1)[2] * batch_mean(torch.exp(-var_1))
                + batch_mean(var_1))
        ps_2 = (ce_dice(u2_st, pseudo_2)[2] * batch_mean(torch.exp(-var_2))
                + batch_mean(var_2))
        ps_loss = ps_1 + ps_2
        w = base.ramp_weight(mcfg.consistency1, state.counter, 150,
                             mcfg.consistency_rampup)
        loss = sup + w * ps_loss

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        base.pmean_step_(ranks, [state.optimizer], [model])
        state.optimizer.step()
        with torch.no_grad():
            m = segmentation_metrics(o1, lab_l, n_classes)
        state.tick()
        return state, base.pmean_metrics({
            "loss": loss.detach(), "sup_loss": sup.detach(),
            "ps_loss": ps_loss.detach(),
            "ce_loss": ((ce1 + ce2) / 2).detach(),
            "dice_loss": ((dice1 + dice2) / 2).detach(),
            "consistency_w1": w, "train_miou": m["miou"],
            "train_mdice": m["mdice"]}, ranks)

    return base.in_scope(train_step, ranks)
