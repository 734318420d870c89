"""A rank's place in data-parallel training, and what the forward and loss
code of a step does with it.

One process trains on one device (a rank); the ranks of a process group
each take their rows of the global batch and keep the state replicated.
Two modes, JAX's (`uaps_tpu/parallel/shardmap_step.py`, `train.py`):

  * shard_map mode (the default): each rank runs the method's step on its
    rows, BN normalises over the local batch, and the step averages the
    gradients, the BN running stats and the metrics over the ranks
    (methods/base.py `pmean_`, JAX's `pmean`). Every seed the model draws
    has the rank folded in (`device_seeds`, JAX's `device_keys`), so each
    rank's dropout and perturbation masks are its own;
  * GSPMD mode (`sync`): the numbers of one step on the global batch. BN's
    moments (models/unet.py) and every batch sum and mean of the losses and
    metrics (`batch_sum`, `batch_mean`) are taken over the global batch by
    `all_reduce_sum`, whose backward all-reduces the cotangent; the seeds
    stay shared and dropout keeps the rank's rows of the global batch's
    mask (`row_offset`: the counter-based generator offset by the rank's
    first element).

In both modes a per-example draw that is not seeded (mt's and uamt's
teacher noise, ucc's CutMix boxes and gates) is drawn over the global
batch and a rank keeps its rows (`rows`), so the generator advances alike
on every rank and its state stays replicated. Global draws (UAPS's
Dirichlet mix, dct's rotation) come from the same generator state on every
rank and agree without help.

`scope(ranks)` makes `ranks` the current rank for the body of a step; the
functions here read it (`current`), and do nothing without one: a step
with no ranks is the single-device step bit for bit, and so is one over a
group of one rank (`Ranks.of` turns sync off there, and rank 0 folds and
offsets nothing). Autograd backwards run outside the scope, so what a
backward needs (the group) is kept by its forward.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Iterator, Optional

import torch
import torch.distributed as dist

# added to a seed per rank (mod 2^31 - 1, a prime, so every rank's seed
# differs): rank 0 keeps the drawn seed
_FOLD = 0x5851F42D
_SEED_MOD = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class Ranks:
    """One rank of data-parallel training: its process group (None: the
    default group), its rank and the group's size, and the mode: `sync`
    for GSPMD mode, else shard_map mode."""
    group: Optional[object]
    rank: int
    world: int
    sync: bool

    @classmethod
    def of(cls, group, sync: bool) -> "Ranks":
        """This process's Ranks in `group` (a torch.distributed process
        group, or None for the default group); sync only where there is
        more than one rank."""
        world = dist.get_world_size(group)
        return cls(group, dist.get_rank(group), world, sync and world > 1)


_CURRENT: contextvars.ContextVar[Optional[Ranks]] = contextvars.ContextVar(
    "uaps_ranks", default=None)


def current() -> Optional[Ranks]:
    """The Ranks of the step being run, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def scope(ranks: Optional[Ranks]) -> Iterator[None]:
    """`ranks` is the current rank inside the block (None: no rank)."""
    token = _CURRENT.set(ranks)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def in_scope(step: Callable, ranks: Optional[Ranks]) -> Callable:
    """`step` run inside scope(ranks); `step` itself without ranks."""
    if ranks is None:
        return step

    def scoped(*args, **kwargs):
        with scope(ranks):
            return step(*args, **kwargs)

    scoped.__name__ = getattr(step, "__name__", "scoped")
    return scoped


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over the ranks of `group`, differentiable: the
    backward all-reduces the cotangent too. Every rank holds the same loss
    in GSPMD mode, so a rank's gradient comes out `world` times its share;
    the step's mean of the gradients over the ranks (`pmean_`) makes that
    the global batch's gradient."""
    return _AllReduceSum.apply(t, group)


def _sync() -> Optional[Ranks]:
    r = current()
    return r if r is not None and r.sync else None


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """A sum over the batch: over the global batch in GSPMD mode, else `t`
    (the caller's local sum) itself."""
    r = _sync()
    return t if r is None else all_reduce_sum(t, r.group)


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of every element of `t` (whose leading axis is the batch):
    over the global batch in GSPMD mode (equal rows on every rank), else
    `t.mean()`."""
    r = _sync()
    if r is None:
        return t.mean()
    return all_reduce_sum(t.sum(), r.group) / (t.numel() * r.world)


def batch_moments(s1: torch.Tensor, s2: torch.Tensor, n: int):
    """(s1, s2, n): per-channel sums and sums of squares over n elements,
    summed over the global batch in GSPMD mode (sync BN); as they are
    otherwise."""
    r = _sync()
    if r is None:
        return s1, s2, n
    s = all_reduce_sum(torch.stack([s1, s2]), r.group)
    return s[0], s[1], n * r.world


def gspmd() -> bool:
    """True in GSPMD mode: BN takes its moments, and the losses their
    sums, over the global batch."""
    return _sync() is not None


def device_seeds(seeds: torch.Tensor) -> torch.Tensor:
    """Seeds drawn alike on every rank, with the rank folded in in shard_map
    mode (JAX's device_keys; on the device, no host value): seed + rank *
    _FOLD mod 2^31 - 1. Rank 0, GSPMD mode and no rank keep them."""
    r = current()
    if r is None or r.sync or r.rank == 0:
        return seeds
    return torch.remainder(seeds + r.rank * _FOLD, _SEED_MOD)


def row_offset(x: torch.Tensor) -> int:
    """The flat index of this rank's first element of x in the global
    batch's tensor (GSPMD mode: dropout's masks are the global batch's);
    0 otherwise."""
    r = _sync()
    return 0 if r is None else r.rank * x.numel()


def rows(draw: Callable[[int], torch.Tensor], b: int,
         dim: int = 0) -> torch.Tensor:
    """A per-example draw of this rank's b rows: draw(world * b), which
    holds the batch along `dim`, narrowed to the rank's rows; draw(b)
    without ranks or with one."""
    r = current()
    if r is None or r.world == 1:
        return draw(b)
    return draw(b * r.world).narrow(dim, r.rank * b, b)
