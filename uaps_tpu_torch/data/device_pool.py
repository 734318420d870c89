"""Device-resident fixed pools: the port's `uaps_tpu/data/device_pool.py`.

Where the data carries fixed labelled and unlabelled pools (the synthetic
fixture's `_pool` / `_upool`, the quality runs' finite splits), they go to
the card once and every step samples its batch there: B labelled and B
unlabelled indices, uniform with replacement, then `index_select`. No step
copies anything from the host, so K sampled steps can be captured as one
CUDA graph (uaps_tpu_torch/dispatch.py) and replayed.

With `strong` (the `ucc` method's batches) a step also carries the strong
view of its unlabelled images, uimage + 0.1 N(0, 1) (JAX's
`weak_strong`), drawn on the card from the sampler's own generator (seeded
with seed + STRONG_SALT), which a CUDA graph registers and so replays with
new draws.

The indices are a pure function of (seed, epoch, step in the epoch), so a
resumed run draws the same batches: the epoch key is the kernels' counter
generator (`kernels/perturb.py` `random_bits`) at (seed + POOL_SALT,
epoch), and a step's 2 B draws are that generator at (epoch key, 2 B step +
j); a draw of 32 bits picks index floor(bits * n / 2^32). JAX draws with
`jax.random.randint` from fold_in(key(seed + 424242), epoch); its bits
cannot be matched, so the tests hold the port to the distribution and the
determinism. The sampler keeps its epoch and step on the device, and
`sample` advances the step in place.

`pool_eval` sweeps a resident validation pool in sequential slices and
averages the per-batch metrics as `Trainer.validate`'s host path does, from
one host copy of them.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict

import torch

from uaps_tpu_torch.kernels.perturb import random_bits

POOL_SALT = 424242   # JAX: jax.random.key(cfg.run.seed + 424242)
STRONG_SALT = 434343  # the strong views' generator: seed + STRONG_SALT


def has_pools(data) -> bool:
    """Whether the data carries fixed labelled and unlabelled pools."""
    return (getattr(data, "_pool", None) is not None
            and getattr(data, "_upool", None) is not None)


class PoolSampler:
    """The labelled and unlabelled pools of `data` on `device`, and the
    batches sampled from them: `start_epoch(epoch)`, then `sample()` once a
    step."""

    def __init__(self, data, batch_size: int, seed: int, device,
                 strong: bool = False):
        dev = torch.device(device)

        def put(a, dtype):
            return torch.as_tensor(a).to(dev, dtype)

        self.image = put(data._pool["image"], torch.float32)
        self.label = put(data._pool["label"], torch.int32)
        self.uimage = put(data._upool["image"], torch.float32)
        self.batch_size = batch_size
        self._seed = torch.tensor(seed + POOL_SALT, dtype=torch.int64,
                                  device=dev)
        self._epoch = torch.zeros((), dtype=torch.int64, device=dev)
        self._pos = torch.zeros((), dtype=torch.int64, device=dev)
        self._draw = torch.arange(2 * batch_size, device=dev)
        self._size = torch.tensor([len(self.image)] * batch_size
                                  + [len(self.uimage)] * batch_size,
                                  dtype=torch.int64, device=dev)
        self.generator = None
        if strong:
            self.generator = torch.Generator(device=dev)
            self.generator.manual_seed(seed + STRONG_SALT)

    def start_epoch(self, epoch: int) -> None:
        self._epoch.fill_(epoch)
        self._pos.zero_()

    def indices(self) -> torch.Tensor:
        """The step's 2 B indices (labelled, then unlabelled), and the step
        advanced."""
        key = random_bits(self._seed, self._epoch)
        bits = random_bits(key, self._pos * (2 * self.batch_size)
                           + self._draw)
        self._pos.add_(1)
        return (bits * self._size) >> 32

    def sample(self) -> Dict[str, torch.Tensor]:
        """The step's batch: "image", "label" and "uimage" on the device,
        and "uimage_strong" with `strong`."""
        idx = self.indices()
        il, iu = idx[:self.batch_size], idx[self.batch_size:]
        batch = {"image": self.image.index_select(0, il),
                 "label": self.label.index_select(0, il),
                 "uimage": self.uimage.index_select(0, iu)}
        if self.generator is not None:
            u = batch["uimage"]
            batch["uimage_strong"] = u + 0.1 * torch.randn(
                u.shape, generator=self.generator, device=u.device)
        return batch


def put_val_pool(data, batch_size: int, device):
    """The data's fixed validation pool on `device` as (image f32, label
    int32), or None where it has none, or where its size is no multiple of
    batch_size (with a warning): the host path sweeps the remainder batch
    too, and the device sweep would drop it."""
    val = getattr(data, "_val", None)
    if val is None:
        return None
    if len(val["image"]) % batch_size:
        logging.getLogger("uaps").warning(
            "val pool size %d not a multiple of batch_size %d; using the "
            "host validate() path", len(val["image"]), batch_size)
        return None
    dev = torch.device(device)
    return (torch.as_tensor(val["image"]).to(dev, torch.float32),
            torch.as_tensor(val["label"]).to(dev, torch.int32))


def pool_eval(eval_step: Callable, image: torch.Tensor, label: torch.Tensor,
              batch_size: int) -> Dict[str, float]:
    """The eval step over sequential batch_size slices of a resident pool
    (a batch multiple), and the plain mean of each metric over the batches,
    summed on the host in batch order as `Trainer.validate` sums them."""
    ms = [eval_step({"image": image[i:i + batch_size],
                     "label": label[i:i + batch_size]})
          for i in range(0, len(image), batch_size)]
    out = {}
    for k in ms[0]:
        total = 0.0
        for v in torch.stack([m[k] for m in ms]).cpu().tolist():
            total += v
        out[k] = total / len(ms)
    return out
