"""Shared training machinery: the port's `uaps_tpu/methods/base.py`.

`build_model` (with the JAX enum validation), the train state, Adam with a
settable learning rate and the host-side plateau scheduler, the train-mode
forward, the supervised CE + Dice pair (the fused kernel where JAX's gate
sends it there), the ramped consistency weight and the main-decoder eval
step.

Where JAX threads an immutable state pytree through a jitted step, the port
keeps the parameters and BN running stats in the `nn.Module`, which the
step updates in place; `TrainState` carries the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from uaps_tpu_torch.kernels.ce_dice import fused_ce_dice
from uaps_tpu_torch.models import net_factory
from uaps_tpu_torch.ops import (cross_entropy_loss, mean_dice,
                                segmentation_metrics, sigmoid_rampup,
                                softmax_dice_loss)

# Accepted values of the ModelConfig enum knobs; a test holds this equal
# to uaps_tpu.methods.base._MODEL_ENUMS.
_MODEL_ENUMS = {
    "conv_backend": {"auto", "fused", "chain", "xla"},
    "conv_variant": {"taps", "im2col", "dhdw", "flat", "dwout", "dwnp",
                     "dwm", "dwmf", "fullh"},
    "head_variant": {"taps", "im2col", "dhdw", "dwnp", "dwm", "dwmf",
                     "xla"},
    "dropout_backend": {"auto", "xla", "pallas"},
    "pool_backend": {"auto", "pallas", "maskpool", "xla"},
    "bn_backend": {"auto", "4d", "flat"},
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device that is not there
    (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev


def build_model(cfg, device, generator: Optional[torch.Generator] = None
                ) -> nn.Module:
    """The config's model in eval mode on `device`, initialised from
    `generator` (default: seeded with cfg.run.seed) on the CPU."""
    for field, allowed in _MODEL_ENUMS.items():
        v = getattr(cfg.model, field)
        if v not in allowed:
            raise ValueError(f"ModelConfig.{field}={v!r}; "
                             f"expected one of {sorted(allowed)}")
    if cfg.model.stack_decoders:
        raise NotImplementedError(
            "stack_decoders is not ported yet: ROADMAP.md Queue A, "
            "'Remainder'")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.run.seed)
    # remat only trades memory in the backward: accepted and ignored
    m = cfg.model
    kwargs = {"nchw_levels": m.nchw_levels, "conv_backend": m.conv_backend,
              "conv_variant": m.conv_variant,
              "head_variant": m.head_variant,
              "pool_backend": m.pool_backend, "bn_backend": m.bn_backend,
              "dropout_backend": m.dropout_backend}
    if m.name == "unet_uaps":
        kwargs["n_aux"] = m.n_aux
    if m.name in ("unet_uaps", "unet_cct", "unet_ucc", "unet_ccps"):
        kwargs["packed_heads"] = m.packed_heads
    model = net_factory(m.name, in_chns=cfg.data.in_channels,
                        class_num=cfg.data.num_classes,
                        dtype=_DTYPES[m.compute_dtype],
                        generator=generator, **kwargs)
    return model.to(dev).eval()


@dataclasses.dataclass
class TrainState:
    """What evolves in training besides the model's parameters and BN
    buffers: the step count, the optimizer (with its moments and learning
    rate) and the generator of every random draw: dropout and perturbation
    seeds, the Dirichlet mix (JAX's state.key)."""
    step: int
    optimizer: torch.optim.Optimizer
    generator: torch.Generator


def make_optimizer(params, optim_cfg) -> torch.optim.Optimizer:
    """Adam with the config's lr, betas and eps; the lr stays settable
    (JAX: optax.inject_hyperparams(optax.adam))."""
    return torch.optim.Adam(params, lr=optim_cfg.base_lr,
                            betas=(optim_cfg.b1, optim_cfg.b2),
                            eps=optim_cfg.eps)


def get_lr(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_lr(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


class PlateauScheduler:
    """ReduceLROnPlateau(mode='max', factor, patience, min_lr) on the host,
    stepped once per validation epoch on val mDice."""

    THRESHOLD = 1e-4   # relative: metric > best * (1 + 1e-4) improves

    def __init__(self, optim_cfg):
        self.factor = optim_cfg.plateau_factor
        self.patience = optim_cfg.plateau_patience
        self.min_lr = optim_cfg.min_lr
        self.best = -float("inf")
        self.bad_epochs = 0

    def step(self, state: TrainState, metric: float) -> TrainState:
        if metric > self.best * (1.0 + self.THRESHOLD) or \
                self.best == -float("inf"):
            self.best = metric
            self.bad_epochs = 0
            return state
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            state = set_lr(state, max(get_lr(state) * self.factor,
                                      self.min_lr))
        return state


def init_model_state(cfg, model: nn.Module) -> TrainState:
    """Step 0, Adam over the model's parameters, and a dropout generator on
    the model's device seeded with cfg.run.seed."""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(cfg.run.seed)
    return TrainState(step=0,
                      optimizer=make_optimizer(model.parameters(), cfg.optim),
                      generator=gen)


def apply_train(model: nn.Module, x: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """One training-mode forward (BN batch stats, which also update the
    running stats in place; dropout from `generator`)."""
    model.train()
    return model(x, generator)


def supervised_ce_dice(logits: torch.Tensor, labels: torch.Tensor,
                       backend: str = "auto"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(CE, Dice) on NHWC logits. JAX's gate (methods/base.py:205-210): a
    backend other than "xla" with H % 8 == 0 and W % 128 == 0 goes to the
    fused CE+Dice kernel module, anything else to the plain pair."""
    h, w = logits.shape[1:3]
    if backend != "xla" and h % 8 == 0 and w % 128 == 0:
        return fused_ce_dice(logits, labels)
    return (cross_entropy_loss(logits, labels),
            softmax_dice_loss(logits, labels))


def ramp_weight(cmax: float, step: int, ramp_iters: int,
                rampup_length: float) -> torch.Tensor:
    """cmax * sigmoid_rampup(step // ramp_iters, rampup), a 0-d f32
    tensor on the CPU."""
    return cmax * sigmoid_rampup(step // ramp_iters, rampup_length)


def make_eval_step(cfg, model: nn.Module) -> Callable:
    """Main-decoder validation step: loss = 0.5 (CE + (1 - mDice)) and the
    metrics, per batch (the caller averages over batches)."""
    n_classes = cfg.data.num_classes
    forward = getattr(model, "main_only", model)

    def eval_step(batch) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            logits = forward(batch["image"])
            labels = batch["label"]
            ce = cross_entropy_loss(logits, labels)
            m = segmentation_metrics(logits, labels, n_classes)
            dice_loss = 1.0 - mean_dice(logits, labels, n_classes)
        return {"val_loss": 0.5 * (ce + dice_loss), "val_ce": ce,
                "val_dice_loss": dice_loss, "val_miou": m["miou"],
                "val_mdice": m["mdice"], "val_acc": m["pixel_acc"]}

    return eval_step
