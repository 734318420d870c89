"""Shared training machinery: the port's `uaps_tpu/methods/base.py`.

`build_model` (with the JAX enum validation), the train state (with cps's
second net), Adam with a settable learning rate and the host-side plateau
scheduler, the train-mode forward, the mean teacher (its copy of the
student and its EMA update), the supervised CE + Dice pair (the fused
kernel where JAX's gate sends it there), the ramped consistency weight,
the main-decoder eval step, and the collectives of a step on ranks
(`step_ranks`, `pmean_`, `pmean_step_`, `pmean_metrics`: JAX's
`pmean_if`; `in_scope` runs a step on its ranks, parallel/ranks.py).

Where JAX threads an immutable state pytree through a jitted step, the port
keeps the parameters and BN running stats in the `nn.Module`, which the
step updates in place; `TrainState` carries the rest.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from uaps_tpu_torch.kernels.ce_dice import fused_ce_dice
from uaps_tpu_torch.models import net_factory
from uaps_tpu_torch.parallel.ranks import Ranks, in_scope
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
# the deep-supervision nets, which JAX builds from conv_backend,
# conv_variant and remat alone (methods/base.py:120-136)
DS_NETS = ("unet_f", "unet_g", "unet_h")


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
    kwargs = {"conv_backend": m.conv_backend, "conv_variant": m.conv_variant}
    if m.name not in DS_NETS:
        kwargs.update(nchw_levels=m.nchw_levels, head_variant=m.head_variant,
                      pool_backend=m.pool_backend, bn_backend=m.bn_backend,
                      dropout_backend=m.dropout_backend)
    if m.name == "unet_uaps":
        kwargs["n_aux"] = m.n_aux
    if m.name in ("unet_uaps", "unet_cct", "unet_ucc", "unet_ccps"):
        kwargs["packed_heads"] = m.packed_heads
    model = net_factory(m.name, in_chns=cfg.data.in_channels,
                        class_num=cfg.data.num_classes,
                        dtype=_DTYPES[m.compute_dtype],
                        generator=generator, **kwargs)
    return model.to(dev).eval()


class TrainState:
    """What evolves in training besides the model's parameters and BN
    buffers: the step count, the optimizer (with its moments and learning
    rate) and the generator of every random draw: dropout and perturbation
    seeds, the Dirichlet mix (JAX's state.key).

    The step count lives twice. `counter` is a 0-d int64 tensor on the
    model's device: the step reads it (the ramp weights) and advances it in
    place, so a step holds no host value and a CUDA graph of it stays right
    on every replay. `step` is its host copy, which `tick` advances beside
    the counter and `advance` alone (a replay of K captured steps advances
    the host copy by K, a capture by nothing); setting `step` writes both.

    `ema_model` is the mean teacher of `mt` and `uamt` (JAX's
    `ema_params` and `ema_batch_stats`): a module on the model's device
    with the EMA parameters and the teacher's own BN running stats, which
    only its own forwards move. None for the other methods.

    `second` is cps's net 2 (JAX's `second`, a `SecondNet`): its module and
    its own Adam. It shares this state's counter and generator. None for
    the other methods.
    """

    def __init__(self, step: int, optimizer: torch.optim.Optimizer,
                 generator: torch.Generator, counter: torch.Tensor,
                 ema_model: Optional[nn.Module] = None,
                 second: Optional["SecondNet"] = None):
        self.optimizer = optimizer
        self.generator = generator
        self.counter = counter
        self.ema_model = ema_model
        self.second = second
        self.step = step

    @property
    def step(self) -> int:
        return self._step

    @step.setter
    def step(self, value: int) -> None:
        self._step = int(value)
        self.counter.fill_(self._step)

    def tick(self) -> None:
        """One step done: the counter on the device, and its host copy."""
        self.counter.add_(1)
        self._step += 1

    def advance(self, n: int) -> None:
        """Move the host copy by n steps (the device counter moves itself)."""
        self._step += n


class SecondNet:
    """cps's net 2 (JAX `TrainState.second`): its module, whose parameters
    and BN buffers the step updates in place, and its own Adam with its own
    lr tensor. `get_lr` and `set_lr` take it as they take a TrainState, so
    that a second plateau scheduler steps its lr (JAX train.py:183-187)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer):
        self.model = model
        self.optimizer = optimizer


def make_optimizer(params, optim_cfg, device) -> torch.optim.Optimizer:
    """Adam with the config's lr, betas and eps (JAX:
    optax.inject_hyperparams(optax.adam)). The lr is a 0-d tensor on
    `device` that `set_lr` fills in place, so a change reaches a captured
    step. On CUDA the update is capturable (its step counts stay on the
    device, its bias corrections are f32 there, and so is the lr). On the
    CPU, where torch refuses that, it is the same update with
    capturable=False, whose step size torch takes in double from an f64
    lr: the float-lr update, bit for bit."""
    dev = torch.device(device)
    lr = torch.tensor(optim_cfg.base_lr, device=dev,
                      dtype=torch.float32 if dev.type == "cuda"
                      else torch.float64)
    return torch.optim.Adam(params, lr=lr,
                            betas=(optim_cfg.b1, optim_cfg.b2),
                            eps=optim_cfg.eps,
                            capturable=dev.type == "cuda")


def get_lr(state) -> float:
    """The lr of a TrainState's Adam, or of a SecondNet's."""
    return float(state.optimizer.param_groups[0]["lr"])


def set_lr(state, lr: float):
    """Fill the lr tensor of a TrainState's Adam, or of a SecondNet's, in
    place (every group shares it)."""
    for group in state.optimizer.param_groups:
        group["lr"].fill_(lr)
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
    """Step 0 (the counter on the model's device), Adam over the model's
    parameters, and a dropout generator on the model's device seeded with
    cfg.run.seed."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.run.seed)
    return TrainState(step=0,
                      optimizer=make_optimizer(model.parameters(), cfg.optim,
                                               dev),
                      generator=gen,
                      counter=torch.zeros((), dtype=torch.int64, device=dev))


def init_state(cfg, device="cuda",
               generator: Optional[torch.Generator] = None
               ) -> Tuple[TrainState, nn.Module]:
    """The config's model on `device` and its TrainState: the `init_state`
    of every method without a teacher."""
    model = build_model(cfg, device, generator)
    return init_model_state(cfg, model), model


def make_teacher(model: nn.Module) -> nn.Module:
    """The mean teacher at init: a copy of the student, the same weights and
    the same BN running stats, outside autograd (JAX mt.py:28-37)."""
    teacher = copy.deepcopy(model)
    teacher.requires_grad_(False)
    return teacher


def ema_update(model: nn.Module, teacher: nn.Module, decay: float,
               counter: torch.Tensor) -> None:
    """The teacher's parameters <- alpha * teacher + (1 - alpha) * student,
    alpha = min(1 - 1 / (step + 1), decay) in f32 from the device counter
    (JAX mt.py ema_update): alpha is 0 at step 0, where the teacher becomes
    the student. Buffers are left alone, as JAX leaves ema_batch_stats."""
    alpha = torch.clamp(1.0 - 1.0 / (counter.to(torch.float32) + 1.0),
                        max=decay)
    ema, params = list(teacher.parameters()), list(model.parameters())
    with torch.no_grad():
        torch._foreach_mul_(ema, alpha)
        torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - alpha))


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


def ramp_weight(cmax: float, step, ramp_iters: int,
                rampup_length: float) -> torch.Tensor:
    """cmax * sigmoid_rampup(step // ramp_iters, rampup) with integer floor
    division, as JAX computes it: a 0-d f32 tensor on the device of `step`
    (the state's counter; a host int gives a CPU tensor)."""
    epoch = torch.div(torch.as_tensor(step), ramp_iters,
                      rounding_mode="floor")
    return cmax * sigmoid_rampup(epoch, rampup_length)


def step_ranks(cfg, group) -> Optional[Ranks]:
    """The Ranks a method's step runs on: None without a process group;
    with one, GSPMD mode where cfg.run.use_shard_map is False, else
    shard_map mode (JAX's auto rule: shard_map on more than one device).
    GSPMD mode on more than one rank takes the plain route only
    (conv_backend="xla", as JAX routes it): the CE+Dice kernel sums and
    the dropout kernel draws over a rank's rows alone."""
    if group is None:
        return None
    ranks = Ranks.of(group, sync=cfg.run.use_shard_map is False)
    if ranks.sync and cfg.model.conv_backend != "xla":
        raise ValueError("GSPMD mode runs the plain route: set "
                         "ModelConfig.conv_backend='xla' (the Trainer "
                         "does)")
    return ranks


def pmean_(tensors, ranks: Optional[Ranks]) -> None:
    """Each tensor, in place, the mean of its values over the ranks (JAX's
    pmean), one all-reduce of a flat buffer for each dtype: NCCL's average
    (each rank's value times 1 / world, summed: the bits of the sum over
    world for 1 and 2 ranks), else the sum divided by world. Nothing
    without ranks."""
    if ranks is None:
        return
    avg = dist.get_backend(ranks.group) == "nccl"
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=ranks.group, op=dist.ReduceOp.AVG
                        if avg else dist.ReduceOp.SUM)
        if not avg:
            flat.div_(ranks.world)
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in ts]), ts)])


def _running_stats(nets) -> list:
    return [b for net in nets for m in net.modules()
            if isinstance(m, nn.BatchNorm2d)
            for b in (m.running_mean, m.running_var)]


def pmean_step_(ranks: Optional[Ranks], optimizers, nets=()) -> None:
    """Between the backward and the optimizers' steps: the gradients of
    the optimizers' parameters averaged over the ranks (JAX's pmean of the
    grads) and, in shard_map mode, the BN running stats of `nets` (the
    student's, the teacher's, net 2's: JAX's pmean of batch_stats), in one
    all-reduce. GSPMD mode's running stats agree already (sync BN). Nothing
    without ranks."""
    if ranks is None:
        return
    grads = [p.grad for opt in optimizers for group in opt.param_groups
             for p in group["params"] if p.grad is not None]
    pmean_(grads + ([] if ranks.sync else _running_stats(nets)), ranks)


def pmean_metrics(metrics: Dict[str, torch.Tensor],
                  ranks: Optional[Ranks]) -> Dict[str, torch.Tensor]:
    """The step's metrics averaged over the ranks in shard_map mode (JAX's
    pmean); GSPMD mode's are the global batch's already, and without ranks
    they are returned as they are."""
    if ranks is None or ranks.sync:
        return metrics
    out = {k: v.detach().clone() for k, v in metrics.items()}
    pmean_(list(out.values()), ranks)
    return out


def make_eval_step(cfg, model: nn.Module) -> Callable:
    """Main-decoder validation step: loss = 0.5 (CE + (1 - mDice)) and the
    metrics, per batch (the caller averages over batches). The logits are
    `main_only`'s where the model has it, else the forward's: a
    deep-supervision net's forward returns dp0 (JAX base.py:231)."""
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
