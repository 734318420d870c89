"""K training steps per dispatch: the port's counterpart of JAX's
`run.steps_per_dispatch` (`uaps_tpu/train.py`: a jitted `lax.scan` of K
steps, one host round-trip per K steps).

`run_steps` is the K-step function: K calls of a method's step, each on the
next batch, and the steps' metrics stacked on a leading [K] axis. On the
CPU it runs as it is. On CUDA, `GraphedSteps` captures it once as one CUDA
graph and replays it, so that the host enqueues K steps with one launch:

  * warm-up: its first call runs the K steps eagerly on a side stream (real
    steps, so the run's trajectory is the eager one). That builds and loads
    every kernel library, initialises Adam's moments and allocates the
    CE+Dice scratch outside the graph's private memory pool;
  * capture: then `torch.cuda.graph` records the same K steps, with the
    state's generator registered, so that every replay advances its Philox
    offset and draws new dropout masks, perturbation seeds and mixing
    weights (an unregistered generator would replay the same draws); so is
    the sampler's, where it draws UCC's strong views. An eager step
    between replays continues the same stream. The capture runs
    no step: the host step count it advanced is set back, and the kernel
    launch counters it ticked are not reset here (they count calls of the
    wrappers; a replay ticks none);
  * replay: each later call copies K host batches into static device
    buffers (through pinned memory, without a sync) or, with device pools,
    samples them inside the graph, replays, advances the host step count
    by K and returns a copy of the graph's [K] metrics.

On a rank of data-parallel training (uaps_tpu_torch/parallel/) the step's
NCCL all-reduces are captured with it and replay with it; the process
group must be NCCL's, joined with the capture environment set
(parallel/mesh.py `init_group`). A failed capture raises: nothing runs
the eager steps in its place.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# the step's arrays of a host batch, and their dtypes on the device
BATCH_DTYPES = {"image": np.float32, "uimage": np.float32,
                "uimage_strong": np.float32, "label": np.int32,
                "mix_w": np.float32}
# K on a CUDA device when RunConfig.steps_per_dispatch is 0 (JAX: 4 on a
# single TPU)
AUTO_STEPS_CUDA = 4


def steps_per_dispatch(run, device) -> int:
    """K for `run` on `device`: run.steps_per_dispatch, where 0 means
    AUTO_STEPS_CUDA on a CUDA device and 1 on the CPU; profile_steps
    forces 1."""
    if run.profile_steps:
        return 1
    k = run.steps_per_dispatch
    if k == 0:
        k = AUTO_STEPS_CUDA if torch.device(device).type == "cuda" else 1
    return max(1, k)


def run_steps(step: Callable, state, next_batch: Callable[[int], Dict],
              k: int):
    """K steps of `step`, step i on next_batch(i): (state, {metric: [K]})."""
    metrics = []
    for i in range(k):
        state, m = step(state, next_batch(i))
        metrics.append(m)
    return state, {name: torch.stack([m[name] for m in metrics])
                   for name in metrics[0]}


def stack_batches(host_batches: List[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """K host batches as one array per key of BATCH_DTYPES: [K, ...]."""
    return {name: np.stack([np.asarray(b[name], dt) for b in host_batches])
            for name, dt in BATCH_DTYPES.items() if name in host_batches[0]}


class GraphedSteps:
    """K steps of `step` as one CUDA graph on `device` (see the module
    docstring). Batches come from `sampler` (a data.device_pool
    PoolSampler) or, per call, from K host batches."""

    def __init__(self, step: Callable, k: int, device, sampler=None):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"GraphedSteps needs a CUDA device, got "
                             f"{self.device}; run_steps runs on the CPU")
        self.step, self.k, self.sampler = step, k, sampler
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.metrics: Dict[str, torch.Tensor] = {}
        self.static: Dict[str, torch.Tensor] = {}
        self._pinned: Dict[str, torch.Tensor] = {}
        self._copied: Optional[torch.cuda.Event] = None
        self.capture_seconds = 0.0

    def _batch(self, i: int) -> Dict[str, torch.Tensor]:
        if self.sampler is not None:
            return self.sampler.sample()
        return {name: buf[i] for name, buf in self.static.items()}

    def _load(self, host_batches) -> None:
        """Copy K host batches into the static buffers: into pinned memory
        once the previous copy out of it is done, then to the card without
        a sync."""
        if self.sampler is not None:
            if host_batches is not None:
                raise ValueError("batches come from the device pools")
            return
        if len(host_batches) != self.k:
            raise ValueError(f"{len(host_batches)} batches for {self.k} "
                             "steps")
        stacked = stack_batches(host_batches)
        if not self.static:
            self._copied = torch.cuda.Event()
            for name, a in stacked.items():
                t = torch.from_numpy(a)
                self._pinned[name] = torch.empty(t.shape, dtype=t.dtype,
                                                 pin_memory=True)
                self.static[name] = torch.empty(t.shape, dtype=t.dtype,
                                                device=self.device)
        self._copied.synchronize()
        for name, a in stacked.items():
            self._pinned[name].numpy()[...] = a
            self.static[name].copy_(self._pinned[name], non_blocking=True)
        self._copied.record()

    def __call__(self, state, host_batches=None):
        """The next K steps: (state, {metric: [K] on the device})."""
        with torch.cuda.device(self.device):
            self._load(host_batches)
            if self.graph is None:
                return self._warm_up_and_capture(state)
            self.graph.replay()
        state.advance(self.k)
        return state, {name: v.clone() for name, v in self.metrics.items()}

    def _warm_up_and_capture(self, state):
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            state, metrics = run_steps(self.step, state, self._batch,
                                       self.k)
        main.wait_stream(side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        if getattr(self.sampler, "generator", None) is not None:
            graph.register_generator_state(self.sampler.generator)
        steps = state.step
        # backward allocates the captured steps' .grad in the graph's pool:
        # every optimizer's, cps's second net's too
        state.optimizer.zero_grad(set_to_none=True)
        if state.second is not None:
            state.second.optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            _, self.metrics = run_steps(self.step, state, self._batch,
                                        self.k)
        state.advance(steps - state.step)   # the capture ran no step
        self.capture_seconds = time.perf_counter() - t0
        self.graph = graph
        return state, metrics
