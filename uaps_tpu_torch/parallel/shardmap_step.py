"""shard_map mode's step: the port's `uaps_tpu/parallel/shardmap_step.py`.

JAX maps the method's step over the 'data' axis with `jax.shard_map`, the
state replicated and the batch sharded, each method averaging its
gradients, BN running stats and metrics with `pmean` over the axis. The
port runs the method's step in each rank's process on the rank's rows,
built with the process group (methods/base.py `step_ranks`), and the
same averages are explicit all-reduces inside it (`pmean_`): one flat
buffer for the gradients and running stats, one for the metrics, and no
`DistributedDataParallel`, whose reducer state a CUDA graph cannot hold.
BN normalises the local batch (the reference's nn.DataParallel), the
kernels run at the local shapes, and each rank's dropout and perturbation
seeds have its rank folded in (parallel/ranks.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable


def make_sharded_train_step(method, cfg, model, group=None) -> Callable:
    """`method`'s step for this rank of `group` (None: the default group)
    in shard_map mode, whatever cfg.run.use_shard_map says."""
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, use_shard_map=True))
    return method.make_train_step(cfg, model, group=group)
