"""Training CLI and single-device Trainer: the port's `uaps_tpu/train.py`.

    python -m uaps_tpu_torch.train --preset neu --method M \
        --dtype bfloat16 --dataset synthetic \
        [--epochs 2 --iter_per_epoch 20] [--device cuda] \
        [--steps_per_dispatch K] [--device_pools]

M is `uaps`, `baseline`, `cct`, `mt`, `uamt`, `cps`, `dct` or `ucc`
(`ucc` trains on the weak / strong stream, `train_iter_weak_strong`). The
loop is the JAX one on one device: `iter_per_epoch` train steps, the
epoch's metric means (the step metrics stay on the device until then), a
validation sweep of the main decoder, the plateau scheduler on val mDice, a
keep-best `best_model.pth` (the reference's training dict) and one line of
metrics JSONL per epoch under `--out_dir`. `cps` validates both nets (net
2's metrics as `val2_*`), steps net 2's lr with a second scheduler on
`val2_mdice`, keeps the best on the larger of the two mDice and writes net
2 beside net 1 as `best_model2.pth` (JAX train.py:183-187, :232-262,
:345-366). The step runs on `cuda` unless `--device cpu` is given.

K steps go in one dispatch (`RunConfig.steps_per_dispatch`; 0, the default,
means 4 on CUDA and 1 on the CPU; `profile_steps` forces 1): on CUDA one
CUDA graph of K steps, captured on the first full dispatch and replayed
(uaps_tpu_torch/dispatch.py), on the CPU the same K-step function run
eagerly; the remainder of an epoch (`iter_per_epoch % K`) runs single
steps. `RunConfig.device_pools` samples every batch on the device from the
data's fixed pools (data/device_pool.py) and sweeps a fixed validation
pool there; data without fixed pools is trained from the host stream, with
a warning, as in JAX. `profile_steps=(start, stop)` writes a torch.profiler
trace of epoch 1's steps start..stop to `out_dir/profile`.

Not ported yet: `--resume` (ROADMAP.md Queue A, "The rest of the Trainer
and CLIs"), more than one device ("Multi-GPU"), and the `RunConfig` knobs
of `UNPORTED_RUN_KNOBS`, which raise when set (`check_run_config`).
"""
from __future__ import annotations

import argparse
import logging
import os
import queue
import threading
import time
from typing import Dict, Iterator

import numpy as np
import torch

from uaps_tpu_torch import dispatch
from uaps_tpu_torch.data import DefectDataset, SyntheticDefects
from uaps_tpu_torch.data import device_pool
from uaps_tpu_torch.methods import base, get_method
from uaps_tpu_torch.utils.cli import parse_args
from uaps_tpu_torch.utils.config import RunConfig
from uaps_tpu_torch.utils.logging_utils import MetricWriter, get_logger
from uaps_tpu_torch.utils.weights import save_pth

# RunConfig knobs that the JAX Trainer reads and the port does not yet, with
# the ROADMAP.md Queue A item that ports each (prng_impl and use_shard_map
# are JAX's alone and stay accepted)
UNPORTED_RUN_KNOBS = {
    "save_every": "The rest of the Trainer and CLIs",
    "keep_checkpoints": "The rest of the Trainer and CLIs",
    "debug_nans": "The rest of the Trainer and CLIs",
}


def check_run_config(run: RunConfig) -> None:
    """Raise NotImplementedError for a knob of UNPORTED_RUN_KNOBS set away
    from its default, rather than train without it."""
    default = RunConfig()
    for name, item in UNPORTED_RUN_KNOBS.items():
        value = getattr(run, name)
        if value != getattr(default, name):
            raise NotImplementedError(
                f"RunConfig.{name}={value!r} is not ported yet: ROADMAP.md "
                f"Queue A, '{item}'")


def make_data(cfg, seed: int = 0):
    """The synthetic fixture, or the real-image pipeline (which raises)."""
    if cfg.data.name == "synthetic":
        return SyntheticDefects(cfg.data, seed=seed)
    return DefectDataset(cfg.data, seed=seed)


def _prefetch(it: Iterator, size: int = 4) -> Iterator:
    """Run a host iterator in a daemon thread with a bounded queue, so that
    building the next batch overlaps the device's step."""
    q: "queue.Queue" = queue.Queue(maxsize=size)

    def worker():
        for item in it:
            q.put(item)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        yield q.get()


def train_stream(data, weak_strong: bool) -> Iterator[Dict]:
    """The host batches, built in a prefetch thread; with `weak_strong`
    (`ucc`'s) they carry the strong view (JAX train.py `_train_stream`)."""
    if weak_strong:
        return _prefetch(data.train_iter_weak_strong())
    return _prefetch(data.train_iter())


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                            torch.Tensor]:
    """The step's arrays of a host batch on `device`: image, uimage and
    uimage_strong f32, label int32, and mix_w f32, those the batch has."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k], dt)).to(
        device) for k, dt in dispatch.BATCH_DTYPES.items() if k in batch}


class Trainer:
    def __init__(self, cfg, device="cuda", data=None):
        check_run_config(cfg.run)
        self.cfg = cfg
        self.device = base.resolve_device(device)
        self.logger = get_logger(cfg.run.out_dir)
        self.writer = MetricWriter(cfg.run.out_dir)
        self.method = get_method(cfg.method.name)
        self.data = data if data is not None else make_data(
            cfg, seed=cfg.run.seed)
        self.state, self.model = self.method.init_state(cfg, self.device)
        self.train_step = self.method.make_train_step(cfg, self.model)
        # (metric prefix, eval step) a net: cps validates both
        second = self.state.second
        self.eval_steps = [("val_", base.make_eval_step(cfg, self.model))]
        if second is not None:
            self.eval_steps.append(
                ("val2_", base.make_eval_step(cfg, second.model)))
        self.scheduler = base.PlateauScheduler(cfg.optim)
        # cps's net 2 has its own plateau scheduler (JAX train.py:183-187)
        self.scheduler2 = (base.PlateauScheduler(cfg.optim)
                           if second is not None else None)
        self.best_dice = -1.0
        self.epochs_since_best = 0
        self.k_dispatch = dispatch.steps_per_dispatch(cfg.run, self.device)
        self.weak_strong = cfg.method.name == "ucc"
        # device-resident pools, where the data has fixed ones (JAX
        # train.py:140-176)
        self.pools = None
        self._val_pool = None
        if cfg.run.device_pools and not device_pool.has_pools(self.data):
            logging.getLogger("uaps").warning(
                "device_pools requested but disabled: the dataset has no "
                "fixed _pool/_upool arrays; training from the host stream")
        elif cfg.run.device_pools:
            b = cfg.data.batch_size
            self.pools = device_pool.PoolSampler(
                self.data, b, cfg.run.seed, self.device,
                strong=self.weak_strong)
            self._val_pool = device_pool.put_val_pool(self.data, b,
                                                      self.device)
        self.graphed = None
        if self.k_dispatch > 1 and self.device.type == "cuda":
            self.graphed = dispatch.GraphedSteps(
                self.train_step, self.k_dispatch, self.device, self.pools)

    def validate(self) -> Dict[str, float]:
        """Mean over the validation batches of the eval step's metrics, of
        each net (cps's net 2 under `val2_` names)."""
        out: Dict[str, float] = {}
        if self._val_pool is not None:
            for prefix, eval_step in self.eval_steps:
                m = device_pool.pool_eval(eval_step, *self._val_pool,
                                          self.cfg.data.batch_size)
                out.update({k.replace("val_", prefix, 1): v
                            for k, v in m.items()})
            return out
        n = 0
        for batch in self.data.val_iter():
            batch = to_device(batch, self.device)
            for prefix, eval_step in self.eval_steps:
                for k, v in eval_step(batch).items():
                    k = k.replace("val_", prefix, 1)
                    out[k] = out.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in out.items()}

    def _dispatch(self, stream):
        """K steps in one dispatch: the CUDA graph, or on the CPU the K-step
        function; metrics [K] on the device."""
        k = self.k_dispatch
        host = None if self.pools else [next(stream) for _ in range(k)]
        if self.graphed is not None:
            return self.graphed(self.state, host)
        if self.pools:
            def next_batch(i):
                return self.pools.sample()
        else:
            stacked = {name: torch.from_numpy(a).to(self.device) for name, a
                       in dispatch.stack_batches(host).items()}

            def next_batch(i):
                return {name: v[i] for name, v in stacked.items()}
        return dispatch.run_steps(self.train_step, self.state, next_batch, k)

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profiler(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = os.path.join(self.cfg.run.out_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        self.logger.info(f"profile of steps {self.cfg.run.profile_steps} "
                         f"written to {out}")

    def run(self) -> float:
        cfg = self.cfg
        n_iter = cfg.run.iter_per_epoch
        stream = None if self.pools else train_stream(self.data,
                                                      self.weak_strong)
        self.logger.info(
            f"method={cfg.method.name} model={cfg.model.name} "
            f"device={self.device} batch={cfg.data.batch_size} "
            f"image={cfg.data.image_size} "
            f"steps_per_dispatch={self.k_dispatch} "
            f"device_pools={self.pools is not None}")
        prof = None
        for epoch in range(1, cfg.run.epochs + 1):
            t0 = time.time()
            epoch_metrics = []
            if self.pools:
                self.pools.start_epoch(epoch)
            it = 0
            while it < n_iter:
                if self.k_dispatch > 1 and n_iter - it >= self.k_dispatch:
                    self.state, metrics = self._dispatch(stream)
                    epoch_metrics.append(metrics)     # [K] arrays
                    it += self.k_dispatch
                    continue
                batch = (self.pools.sample() if self.pools
                         else to_device(next(stream), self.device))
                if (cfg.run.profile_steps and epoch == 1
                        and it == cfg.run.profile_steps[0]):
                    prof = self._profiler()
                self.state, metrics = self.train_step(self.state, batch)
                epoch_metrics.append(metrics)
                if prof is not None and (it == cfg.run.profile_steps[1]
                                         or it == n_iter - 1):
                    self._stop_profiler(prof)
                    prof = None
                it += 1
            # one device -> host copy per epoch
            stacked = {k: torch.cat([m[k].reshape(-1)
                                     for m in epoch_metrics]).cpu()
                       for k in epoch_metrics[0]}
            means = {k: float(np.nanmean(v.double().numpy()))
                     for k, v in stacked.items()}
            dt = time.time() - t0
            means["imgs_per_sec"] = n_iter * cfg.data.batch_size / dt
            means["lr"] = base.get_lr(self.state)
            if cfg.run.halt_on_nan and not np.isfinite(means["loss"]):
                raise FloatingPointError(
                    f"non-finite loss {means['loss']} at epoch {epoch}")

            val = self.validate()
            self.state = self.scheduler.step(self.state, val["val_mdice"])
            if self.scheduler2 is not None:
                self.scheduler2.step(self.state.second, val["val2_mdice"])
            self.writer.write(epoch, {**means, **val})
            self.logger.info(
                f"epoch {epoch:03d}/{cfg.run.epochs} "
                f"loss {means['loss']:.4f} "
                f"train_dice {means['train_mdice']:.4f} "
                f"val_dice {val['val_mdice']:.4f} "
                f"val_miou {val['val_miou']:.4f} "
                f"({means['imgs_per_sec']:.1f} img/s)")
            # keep-best on the better net's dice (JAX train.py:359-366)
            gate_dice = max(val["val_mdice"],
                            val.get("val2_mdice", float("-inf")))
            if gate_dice > self.best_dice:
                self.best_dice = gate_dice
                self.epochs_since_best = 0
                extra = {"epoch": epoch, "step": self.state.step,
                         "best_dice": self.best_dice}
                save_pth(self.model,
                         os.path.join(cfg.run.out_dir, "best_model.pth"),
                         extra)
                if self.state.second is not None:
                    save_pth(self.state.second.model,
                             os.path.join(cfg.run.out_dir,
                                          "best_model2.pth"), extra)
            else:
                self.epochs_since_best += 1
            if (cfg.run.early_stop_patience
                    and self.epochs_since_best >= cfg.run.early_stop_patience):
                self.logger.info(
                    f"early stop: no val mDice improvement in "
                    f"{self.epochs_since_best} epochs "
                    f"(best {self.best_dice:.4f})")
                break
        self.writer.close()
        return self.best_dice


def main(argv=None) -> float:
    cfg, _ = parse_args(argv)
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--num_devices", type=int, default=None)
    extra, _ = p.parse_known_args(argv)
    if extra.resume or (extra.num_devices or 1) > 1:
        raise NotImplementedError(
            "--resume and --num_devices > 1 are not ported yet: ROADMAP.md "
            "Queue A, 'The rest of the Trainer and CLIs' and 'Multi-GPU'")
    trainer = Trainer(cfg, device=extra.device)
    best = trainer.run()
    trainer.logger.info(f"done; best val mDice {best:.4f}")
    return best


if __name__ == "__main__":
    main()
