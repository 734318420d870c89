"""DCT: rotation-consistency training on a plain U-Net.

The port's `uaps_tpu/methods/dct.py`. One step, on `unet`:
  k    ~ U{0..3}, one draw a step from `state.generator`, on the device
  cons = mean((soft(f(rot90^k(uimage))) - rot90^k(soft(f(uimage))))^2),
         gradients through both forwards (the reference detaches neither)
  loss = 0.5 (CE + Dice) + w(t) cons, w = consistency1 *
         sigmoid_rampup(step // 150)
then Adam. The three forwards (labelled, uimage, the rotated uimage) run
one after the other in train mode, each continuing the last's BN running
stats. k never reaches the host: `rot_k` computes the four rotations and
picks one with `index_select` on the 0-d k tensor, so the step can be
captured in a CUDA graph. `batch["rot_k"]`, where given, replaces the draw
(JAX's hook). A rotation by 90 degrees needs square images (JAX's
lax.switch over the four rotations cannot trace a non-square one either).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from uaps_tpu_torch.methods import base
from uaps_tpu_torch.ops import segmentation_metrics
from uaps_tpu_torch.parallel.ranks import batch_mean


init_state = base.init_state


def rot_k(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """rot90^k over the spatial axes (1, 2) of NHWC x (from axis 1 toward
    axis 2, as jnp.rot90(x, k, axes=(1, 2))), k a 0-d integer tensor on
    x's device."""
    rots = torch.stack([torch.rot90(x, j, dims=(1, 2)) for j in range(4)])
    return rots.index_select(0, k.reshape(1).to(torch.int64)).squeeze(0)


def make_train_step(cfg, model: nn.Module, group=None):
    """(state, batch) -> (state, metrics); batch holds device tensors
    "image" and "uimage" [B, H, W, C] f32, "label" [B, H, W] int32 and
    optionally "rot_k" (an integer in 0..3). With a process group
    (`group`) it is this rank's step (methods/base.py `step_ranks`): the
    gradients, BN running stats and metrics averaged over the ranks where
    JAX's pmean_if sits."""
    ranks = base.step_ranks(cfg, group)
    h, w = cfg.data.image_size
    if h != w:
        raise ValueError(
            f"method 'dct' rotates the unlabelled images by 90 degrees and "
            f"needs square images; image_size={cfg.data.image_size!r}")
    mcfg = cfg.method
    n_classes = cfg.data.num_classes
    backend = cfg.model.conv_backend

    def train_step(state: base.TrainState, batch
                   ) -> Tuple[base.TrainState, Dict[str, torch.Tensor]]:
        uimage = batch["uimage"]
        k = (torch.as_tensor(batch["rot_k"], device=uimage.device)
             if "rot_k" in batch else
             torch.randint(0, 4, (), generator=state.generator,
                           device=uimage.device))
        logits = base.apply_train(model, batch["image"], state.generator)
        un_logits = base.apply_train(model, uimage, state.generator)
        rot_logits = base.apply_train(model, rot_k(uimage, k),
                                      state.generator)
        ce, dice = base.supervised_ce_dice(logits, batch["label"], backend)
        sup = 0.5 * (ce + dice)
        cons = batch_mean((torch.softmax(rot_logits, -1)
                           - rot_k(torch.softmax(un_logits, -1), k)) ** 2)
        wt = base.ramp_weight(mcfg.consistency1, state.counter, 150,
                              mcfg.consistency_rampup)
        loss = sup + wt * cons

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        base.pmean_step_(ranks, [state.optimizer], [model])
        state.optimizer.step()
        with torch.no_grad():
            m = segmentation_metrics(logits, batch["label"], n_classes)
        state.tick()
        return state, base.pmean_metrics({
            "loss": loss.detach(), "ce_loss": ce.detach(),
            "dice_loss": dice.detach(), "consistency_loss": cons.detach(),
            "consistency_w1": wt, "train_miou": m["miou"],
            "train_mdice": m["mdice"]}, ranks)

    return base.in_scope(train_step, ranks)
