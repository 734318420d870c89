"""Step-indexed full-state checkpoints: the port's
`uaps_tpu/utils/checkpoint.py`.

`CheckpointManager` has the JAX manager's methods and semantics (`save`,
`restore`, `best_step`, `latest_step`, `wait`, `close`) in a format of the
port's own (JAX's Orbax checkpoints stay unread). Each step is a directory
`<directory>/<step>/` holding

  * `state.pt`: `torch.save` of a flat {name: tensor} dict, CPU tensors
    only, read back with `weights_only=True`;
  * `host.json`: the host state (epoch, best dice, the schedulers);
  * `metrics.json`: the metrics the step was saved with.

A save writes the directory under a temporary name and renames it into
place, as Orbax does, so a step directory is whole or absent. Retention
is Orbax's with `best_fn = val_mdice`, `best_mode = "max"` and
`max_to_keep = keep` (its `BestN` policy): once more than `keep` steps
exist, the `keep` with the largest val_mdice stay (ties: the later step)
and the others go, the newest included if it ranks below them all.
Saves are synchronous, so `wait` and `close` have nothing to do. On ranks
(`group`: a torch.distributed process group, parallel/) rank 0 alone
writes and prunes, and every rank waits at a barrier after a save; every
rank restores the same step directory.

`state_tensors` flattens what a run carries into that dict: the model's
parameters and BN buffers, Adam's moments, step and lr, the device step
counter, the state's generator, mt's and uamt's teacher (`ema_model`),
cps's net 2 and its Adam (`second`), and the device pools' strong-view
generator (ucc). `load_state_tensors` writes such a dict back into a
freshly built run in place, so that every tensor a CUDA graph will
capture keeps its address.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

STATE_FILE, HOST_FILE, METRICS_FILE = "state.pt", "host.json", "metrics.json"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 2, group=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.group = group
        self.writer = group is None or dist.get_rank(group) == 0

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def steps(self) -> list:
        """The saved steps, ascending."""
        return sorted(int(e) for e in os.listdir(self.directory)
                      if e.isdigit())

    def _metric(self, step: int) -> float:
        with open(os.path.join(self._path(step), METRICS_FILE)) as f:
            return json.load(f).get("val_mdice", 0.0)

    def _by_metric(self) -> list:
        """The steps in increasing metric order (stable: in a tie the
        later step ranks higher), as Orbax sorts them."""
        return sorted(self.steps(), key=self._metric)

    def save(self, step: int, state: Dict[str, torch.Tensor],
             host_state: Optional[dict] = None,
             metrics: Optional[dict] = None) -> None:
        if self.writer:
            self._write(step, state, host_state, metrics)
        if self.group is not None:
            dist.barrier(group=self.group)

    def _write(self, step: int, state: Dict[str, torch.Tensor],
               host_state: Optional[dict], metrics: Optional[dict]) -> None:
        final = self._path(step)
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} exists in "
                                  f"{self.directory}")
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({k: v.detach().cpu() for k, v in state.items()},
                   os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, HOST_FILE), "w") as f:
            json.dump(host_state or {}, f)
        with open(os.path.join(tmp, METRICS_FILE), "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
        os.rename(tmp, final)
        self._prune()

    def _prune(self) -> None:
        """Orbax's BestN(n=keep): nothing goes while at most `keep` steps
        exist; then all but the `keep` best."""
        steps = self.steps()
        if len(steps) <= self.keep:
            return
        kept = set(self._by_metric()[-self.keep:] if self.keep else [])
        for step in steps:
            if step not in kept:
                shutil.rmtree(self._path(step))

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def restore(self, step: Optional[int] = None
                ) -> Tuple[Optional[Dict[str, torch.Tensor]],
                           Optional[dict]]:
        """(state tensors on the CPU, host state) of `step`; None -> the
        latest; (None, None) where there is no checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        path = self._path(step)
        state = torch.load(os.path.join(path, STATE_FILE),
                           map_location="cpu", weights_only=True)
        with open(os.path.join(path, HOST_FILE)) as f:
            host = json.load(f)
        return state, host

    def best_step(self) -> Optional[int]:
        ranked = self._by_metric()
        return ranked[-1] if ranked else None

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing is held open."""


# ------------------------------------------------------- a run as tensors
def checkpoint_dir(path: str) -> str:
    """The checkpoint root of `path`: a run directory's `checkpoints/`
    where the run directory holds no step directory itself, else
    `path`."""
    sub = os.path.join(path, "checkpoints")
    if os.path.isdir(sub) and not any(e.isdigit()
                                      for e in os.listdir(path)):
        return sub
    return path


def restore_run(path: str, use_best: bool = True
                ) -> Tuple[Dict[str, torch.Tensor], int, str]:
    """(tensors, step, checkpoint root) of the best checkpoint by val
    mDice under `path` (a run directory or its `checkpoints/`), or with
    `use_best=False` of the latest; FileNotFoundError where there is
    none."""
    root = checkpoint_dir(path)
    manager = CheckpointManager(root)
    step = manager.best_step() if use_best else manager.latest_step()
    tensors, _ = manager.restore(step)
    if tensors is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    return tensors, step, root


def _module(out: Dict, prefix: str, module: torch.nn.Module) -> None:
    for k, v in module.state_dict().items():
        out[f"{prefix}.{k}"] = v


def _params(optimizer) -> list:
    return [p for group in optimizer.param_groups for p in group["params"]]


def _adam(out: Dict, prefix: str, optimizer) -> None:
    """Adam's per-parameter state (moments and step; a parameter that has
    had no gradient has none) by the parameter's index, and its lr."""
    for i, p in enumerate(_params(optimizer)):
        for k, v in optimizer.state.get(p, {}).items():
            out[f"{prefix}.state.{i}.{k}"] = v
    out[f"{prefix}.lr"] = torch.as_tensor(optimizer.param_groups[0]["lr"])


def state_tensors(state, model: torch.nn.Module, pools=None
                  ) -> Dict[str, torch.Tensor]:
    """A run's full state as one flat {name: tensor} dict (the module
    docstring lists it)."""
    out: Dict[str, torch.Tensor] = {}
    _module(out, "model", model)
    _adam(out, "optimizer", state.optimizer)
    out["counter"] = state.counter
    out["generator"] = state.generator.get_state()
    if state.ema_model is not None:
        _module(out, "ema_model", state.ema_model)
    if state.second is not None:
        _module(out, "second.model", state.second.model)
        _adam(out, "second.optimizer", state.second.optimizer)
    if getattr(pools, "generator", None) is not None:
        out["pools.generator"] = pools.generator.get_state()
    return out


class _Reader:
    """The saved tensors, each taken once; `done` raises for any left."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.left = dict(tensors)

    def take(self, name: str) -> torch.Tensor:
        if name not in self.left:
            raise KeyError(f"checkpoint holds no {name!r}")
        return self.left.pop(name)

    def prefixed(self, prefix: str) -> Dict[str, torch.Tensor]:
        names = [k for k in self.left if k.startswith(prefix)]
        return {k[len(prefix):]: self.left.pop(k) for k in names}

    def done(self) -> None:
        if self.left:
            raise KeyError(f"checkpoint tensors this run has no place "
                           f"for: {sorted(self.left)[:8]}")


def module_tensors(tensors: Dict[str, torch.Tensor], prefix: str = "model"
                   ) -> Dict[str, torch.Tensor]:
    """One module's state dict out of a checkpoint's tensors."""
    head = prefix + "."
    return {k[len(head):]: v for k, v in tensors.items()
            if k.startswith(head)}


def load_module(module: torch.nn.Module, tensors: Dict[str, torch.Tensor],
                prefix: str = "model") -> None:
    """Copy one module's parameters and buffers from a checkpoint's
    tensors, strict, in place."""
    module.load_state_dict(module_tensors(tensors, prefix))


def _load_adam(reader: _Reader, prefix: str, optimizer) -> None:
    """Adam's state copied in place where it exists, else made on the
    parameter's device (the step on the CPU for a non-capturable Adam, as
    torch makes it); the lr tensor filled in place, so that `set_lr` and a
    captured step still share it."""
    for i, p in enumerate(_params(optimizer)):
        saved = reader.prefixed(f"{prefix}.state.{i}.")
        st = optimizer.state[p]
        for k, v in saved.items():
            if k in st:
                st[k].copy_(v)
                continue
            on_cpu = k == "step" and not optimizer.defaults["capturable"]
            st[k] = v.to("cpu" if on_cpu else p.device).clone()
    lr = reader.take(f"{prefix}.lr")
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].copy_(lr)
        else:
            group["lr"] = float(lr)


def load_state_tensors(state, model: torch.nn.Module,
                       tensors: Dict[str, torch.Tensor], pools=None) -> None:
    """Write `state_tensors`' dict back into a run built from the same
    config, in place; raises KeyError where the two do not match."""
    reader = _Reader(tensors)
    with torch.no_grad():
        model.load_state_dict(reader.prefixed("model."))
        _load_adam(reader, "optimizer", state.optimizer)
        state.step = int(reader.take("counter"))
        state.generator.set_state(reader.take("generator"))
        if state.ema_model is not None:
            state.ema_model.load_state_dict(reader.prefixed("ema_model."))
        if state.second is not None:
            state.second.model.load_state_dict(
                reader.prefixed("second.model."))
            _load_adam(reader, "second.optimizer", state.second.optimizer)
        if getattr(pools, "generator", None) is not None:
            pools.generator.set_state(reader.take("pools.generator"))
    reader.done()
