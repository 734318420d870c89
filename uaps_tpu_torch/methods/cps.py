"""CPS: cross pseudo supervision between two independently initialised nets.

The port's `uaps_tpu/methods/cps.py`. Two deep-supervision nets (`unet_f`),
net 1 the model and net 2 `state.second`, each with its own Adam; only
their dp0 heads are read. One step:
  sup         = 0.5 (CE1 + Dice1) + 0.5 (CE2 + Dice2)    (labelled batch)
  labeled_cps = each net supervised by the argmax of the other net's
                detached labelled logits: 0.5 CE + 0.5 Dice (`_ps_pair`)
  unl_cps     = the same on the unlabelled batch
  loss        = sup + w(t) unl_cps + w(t) labeled_cps, w = consistency1 *
                sigmoid_rampup(step // 150)
then one backward and both Adams. Each net runs its labelled forward, then
its unlabelled one, in train mode, so the second continues the first's BN
running stats. Every draw (the four forwards' dropout seeds) comes from
`state.generator`, and the ramp weight from the device counter: the step
holds no host value, so a CUDA graph can capture it.
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
    """Net 1 from `generator` (default: seeded with cfg.run.seed) and its
    TrainState, whose `second` holds net 2, initialised from a generator of
    its own seeded by a draw from net 1's (JAX splits its rng,
    cps.py:31-37), with its own Adam."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.run.seed)
    state, model = base.init_state(cfg, device, generator)
    seed2 = int(torch.randint(0, 2 ** 62, (), generator=generator))
    model2 = base.build_model(cfg, device,
                              torch.Generator().manual_seed(seed2))
    state.second = base.SecondNet(
        model2, base.make_optimizer(model2.parameters(), cfg.optim,
                                    state.counter.device))
    return state, model


def make_train_step(cfg, model: nn.Module, group=None):
    """(state, batch) -> (state, metrics); batch holds device tensors
    "image" and "uimage" [B, H, W, C] f32 and "label" [B, H, W] int32.
    With a process group (`group`) it is
    this rank's step (methods/base.py `step_ranks`): the gradients, BN
    running stats and metrics averaged over the ranks where JAX's pmean_if
    sits. Both nets' gradients go in one
    all-reduce."""
    ranks = base.step_ranks(cfg, group)
    mcfg = cfg.method
    n_classes = cfg.data.num_classes
    backend = cfg.model.conv_backend

    def ps_pair(logits, pseudo):
        """0.5 CE(logits, pseudo) + 0.5 Dice(pseudo, logits) (JAX
        `_ps_pair`)."""
        ce, dice = base.supervised_ce_dice(logits, pseudo, backend)
        return 0.5 * ce + 0.5 * dice

    def pseudo(logits):
        return logits.detach().argmax(-1).to(torch.int32)

    def train_step(state: base.TrainState, batch
                   ) -> Tuple[base.TrainState, Dict[str, torch.Tensor]]:
        net2 = state.second.model
        o1 = base.apply_train(model, batch["image"], state.generator)
        u1 = base.apply_train(model, batch["uimage"], state.generator)
        o2 = base.apply_train(net2, batch["image"], state.generator)
        u2 = base.apply_train(net2, batch["uimage"], state.generator)

        labels = batch["label"]
        ce1, dice1 = base.supervised_ce_dice(o1, labels, backend)
        ce2, dice2 = base.supervised_ce_dice(o2, labels, backend)
        sup = 0.5 * (ce1 + dice1) + 0.5 * (ce2 + dice2)
        labeled_cps = ps_pair(o1, pseudo(o2)) + ps_pair(o2, pseudo(o1))
        unl_cps = ps_pair(u1, pseudo(u2)) + ps_pair(u2, pseudo(u1))
        w = base.ramp_weight(mcfg.consistency1, state.counter, 150,
                             mcfg.consistency_rampup)
        loss = sup + w * unl_cps + w * labeled_cps

        opts = (state.optimizer, state.second.optimizer)
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        loss.backward()
        base.pmean_step_(ranks, opts, [model, net2])
        for opt in opts:
            opt.step()
        with torch.no_grad():
            m = segmentation_metrics(o1, labels, n_classes)
        state.tick()
        return state, base.pmean_metrics({
            "loss": loss.detach(), "sup_loss": sup.detach(),
            "labeled_cps_loss": labeled_cps.detach(),
            "unlabeled_cps_loss": unl_cps.detach(), "consistency_w1": w,
            "train_miou": m["miou"], "train_mdice": m["mdice"]}, ranks)

    return base.in_scope(train_step, ranks)
