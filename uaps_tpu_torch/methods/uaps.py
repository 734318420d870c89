"""UAPS: uncertainty-aware, dynamically mixed pseudo-label training.

The port's `uaps_tpu/methods/uaps.py`. One step:
  sup      = mean_d 0.5 (CE_d + Dice_d)                 (labelled batch)
  var_d    = sum_c KL(p || softmax(un_d)), p = mean_d softmax(un_d)
  l_uncert = mean(mean_d var_d)
  w        = batch["mix_w"], or ~ Dirichlet(1, ..., 1) (one draw per step),
             or uniform without dynamic mixing
  pseudo   = argmax(sum_d w_d stopgrad(softmax(un_d)))
  ps_d     = 0.5 (CE(un_d, pseudo) + Dice(un_d, pseudo))
  ps_loss  = mean_d [ps_d * mean(exp(-var_d))]   (the reference's quirk: a
             SCALAR loss times the mean gate)
  loss     = sup + w1(t) ps_loss + w2(t) l_uncert
             (+ l_uncert unramped with `unramped_uncertainty`, the MTiles
             variant; + decoder_consistency_weight * mean_{d>0}
             MSE(softmax(un_0), softmax(un_d)) where that weight is > 0)
with w_i(t) = consistency_i * sigmoid_rampup(step // ramp_iters, rampup),
then Adam. The labelled and unlabelled forwards run one after the other in
train mode, so the second continues the first's BN running stats
(`fused_batch` runs them as one batch instead). Every random draw (dropout
and perturbation seeds, the Dirichlet mix) comes from `state.generator`.

The routes of the uncertainty maps and the pseudo-label are JAX's
(methods/uaps.py:116-144):
  * kernels on (conv_backend != "xla"), `fused_uncertainty` and no
    decoder-consistency term: both from the fused uncertainty module;
  * kernels on otherwise (`fused_uncertainty=False`, or
    `decoder_consistency_weight > 0`, which needs the softmaxes): the
    softmaxes, mean prediction and KL maps as plain torch ops, the
    pseudo-label from the fused pseudo-label module;
  * conv_backend="xla": all plain ops, the argmax of the detached mix.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from uaps_tpu_torch.kernels.pseudo_label import fused_pseudo_label
from uaps_tpu_torch.kernels.uncertainty import fused_uncertainty
from uaps_tpu_torch.methods import base
from uaps_tpu_torch.ops import (kl_divergence_map, segmentation_metrics,
                                symmetric_mse_loss)


def init_state(cfg, device="cuda",
               generator: Optional[torch.Generator] = None
               ) -> Tuple[base.TrainState, nn.Module]:
    model = base.build_model(cfg, device, generator)
    return base.init_model_state(cfg, model), model


def make_train_step(cfg, model: nn.Module):
    """(state, batch) -> (state, metrics); batch holds device tensors
    "image" and "uimage" [B, H, W, C] f32, "label" [B, H, W] int32 and
    optionally "mix_w" [1 + n_aux] f32. The metrics stay on the device
    (the ramp weights on the CPU)."""
    mcfg = cfg.method
    n_classes = cfg.data.num_classes
    n_dec = 1 + cfg.model.n_aux
    backend = cfg.model.conv_backend
    kernels = backend != "xla"
    fused = (kernels and mcfg.fused_uncertainty
             and mcfg.decoder_consistency_weight == 0)

    def forwards(state, batch):
        if mcfg.fused_batch:
            nb = batch["image"].shape[0]
            both = torch.cat([batch["image"], batch["uimage"]])
            outs = base.apply_train(model, both, state.generator)
            return [o[:nb] for o in outs], [o[nb:] for o in outs]
        outs = base.apply_train(model, batch["image"], state.generator)
        return outs, base.apply_train(model, batch["uimage"],
                                      state.generator)

    def mix_weights(state, batch, device):
        if "mix_w" in batch:
            return batch["mix_w"]
        if mcfg.dynamic_mixing:
            e = torch.empty(n_dec, device=device).exponential_(
                generator=state.generator)
            return e / e.sum()
        return torch.full((n_dec,), 1.0 / n_dec, device=device)

    def train_step(state: base.TrainState, batch
                   ) -> Tuple[base.TrainState, Dict[str, torch.Tensor]]:
        outs, un_outs = forwards(state, batch)
        labels = batch["label"]
        pairs = [base.supervised_ce_dice(o, labels, backend) for o in outs]
        ces = [p[0] for p in pairs]
        dices = [p[1] for p in pairs]
        sup = sum(0.5 * (c + d) for c, d in zip(ces, dices)) / n_dec
        w = mix_weights(state, batch, labels.device)

        if fused:
            var_stack, pseudo = fused_uncertainty(un_outs, w)
            variances = list(var_stack)
            l_uncert = var_stack.mean()
        else:
            softmaxes = [torch.softmax(o, -1) for o in un_outs]
            preds = sum(softmaxes) / n_dec
            variances = [kl_divergence_map(o, preds) for o in un_outs]
            l_uncert = torch.mean(sum(variances) / n_dec)
            if kernels:
                pseudo = fused_pseudo_label(un_outs, w)
            else:
                mixed = sum(wi * s.detach() for wi, s in zip(w, softmaxes))
                pseudo = mixed.argmax(-1).to(torch.int32)

        ps_terms = []
        for o, var in zip(un_outs, variances):
            ps_ce, ps_dice = base.supervised_ce_dice(o, pseudo, backend)
            ps = 0.5 * (ps_ce + ps_dice)
            if mcfg.uncertainty_gate:
                ps = ps * torch.mean(torch.exp(-var))
            ps_terms.append(ps)
        ps_loss = sum(ps_terms) / n_dec

        w1 = base.ramp_weight(mcfg.consistency1, state.step,
                              mcfg.ramp_iters, mcfg.consistency_rampup)
        w2 = base.ramp_weight(mcfg.consistency2, state.step,
                              mcfg.ramp_iters, mcfg.consistency_rampup)
        loss = sup + w1 * ps_loss
        loss = loss + (l_uncert if mcfg.unramped_uncertainty
                       else w2 * l_uncert)
        if mcfg.decoder_consistency_weight > 0:
            dec_cons = sum(symmetric_mse_loss(softmaxes[0], s)
                           for s in softmaxes[1:]) / max(n_dec - 1, 1)
            loss = loss + mcfg.decoder_consistency_weight * dec_cons

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        with torch.no_grad():
            m = segmentation_metrics(outs[0], labels, n_classes)
        state.step += 1
        return state, {
            "loss": loss.detach(), "sup_loss": sup.detach(),
            "ce_loss": (sum(ces) / n_dec).detach(),
            "dice_loss": (sum(dices) / n_dec).detach(),
            "ps_loss": ps_loss.detach(),
            "uncertainty_loss": l_uncert.detach(),
            "consistency_w1": w1, "consistency_w2": w2,
            "train_miou": m["miou"], "train_mdice": m["mdice"]}

    return train_step
