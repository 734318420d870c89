"""Ranks, their batch rows and their replicated state: the port's
`uaps_tpu/parallel/mesh.py`.

JAX builds a one-axis device mesh ('data') inside one program; the port
runs one process per device (a rank) in a torch.distributed process group.
`distributed_init` joins the group from a launcher's environment (as JAX
reads its coordinator's), `data_ranks` is JAX's rule for the mesh size,
`local_batch_shard` slices a rank's rows out of the global batch that every
rank builds alike, and `replicate_state` makes every rank's state rank
0's. JAX's 'spatial' mesh axis (`make_mesh(spatial > 1)`) has no
counterpart: no entry point builds it (ROADMAP.md Queue A).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from uaps_tpu_torch.utils.checkpoint import load_state_tensors, state_tensors

# set before init_process_group: without async error handling the NCCL
# process group lets a CUDA graph capture its collectives
NCCL_CAPTURE_ENV = {"TORCH_NCCL_ASYNC_ERROR_HANDLING": "0",
                    "NCCL_ASYNC_ERROR_HANDLING": "0"}
# per-example arrays of a host batch; the rest (mix_w) is shared
SHARED_KEYS = ("mix_w",)


def launched() -> bool:
    """True where a launcher set RANK and WORLD_SIZE."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_group(rank: int, world: int, init_method: str,
               device, backend: Optional[str] = None) -> None:
    """Join a process group of `world` ranks as `rank` (NCCL on CUDA with
    the capture environment set first, gloo on the CPU, unless `backend`
    names one)."""
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    if backend == "nccl":
        os.environ.update(NCCL_CAPTURE_ENV)
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)


def distributed_init(backend: Optional[str] = None, device: str = "cuda"
                     ) -> Optional[Tuple[int, int, int]]:
    """Join the group a launcher describes (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT): (rank, world, local rank), the device
    cuda:LOCAL_RANK on CUDA. A no-op returning None without them."""
    if not launched():
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = (torch.device("cuda", local) if torch.device(device).type ==
           "cuda" else torch.device("cpu"))
    init_group(rank, world, "env://", dev, backend)
    return rank, world, local


def data_ranks(batch_size: int, available: int) -> int:
    """The ranks that train: the largest divisor of batch_size within
    `available` (JAX train.py:81-85)."""
    return max(d for d in range(1, max(available, 1) + 1)
               if batch_size % d == 0)


def local_batch_shard(batch: Dict[str, np.ndarray], rank: int,
                      world: int) -> Dict[str, np.ndarray]:
    """A rank's rows of the global batch that every rank builds alike (JAX
    `local_batch_shard`): rows rank * B / world .. of every per-example
    array; the shared ones (SHARED_KEYS) whole. The identity for one
    rank."""
    if world == 1:
        return batch
    out = {}
    for k, x in batch.items():
        if k in SHARED_KEYS:
            out[k] = x
            continue
        n = x.shape[0]
        if n % world:
            raise ValueError(f"global batch {n} ({k}) not divisible by "
                             f"{world} ranks")
        b = n // world
        out[k] = x[rank * b:(rank + 1) * b]
    return out


def _comm_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def replicate_state(state, model: torch.nn.Module, pools=None,
                    group=None) -> None:
    """Every rank's state made rank 0's, in place (JAX `replicate_state`):
    the parameters and buffers, Adam's moments, step and lr, the device
    counter and the generator's state, the teacher, cps's net 2 and its
    Adam (utils/checkpoint.py `state_tensors`), one broadcast per dtype."""
    tensors = state_tensors(state, model, pools)
    names = sorted(tensors)
    dev = _comm_device(group)
    by_dtype: Dict[torch.dtype, list] = {}
    for name in names:
        by_dtype.setdefault(tensors[name].dtype, []).append(name)
    out = {}
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for group_names in by_dtype.values():
        flat = torch.cat([tensors[n].detach().reshape(-1).to(dev)
                          for n in group_names])
        dist.broadcast(flat, src, group=group)
        for n, piece in zip(group_names, flat.split(
                [tensors[n].numel() for n in group_names])):
            out[n] = piece.view(tensors[n].shape).to(tensors[n].device)
    load_state_tensors(state, model, out, pools)
