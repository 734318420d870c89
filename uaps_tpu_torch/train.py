"""Training CLI and single-device Trainer: the port's `uaps_tpu/train.py`.

    python -m uaps_tpu_torch.train --preset neu --method uaps \
        --dtype bfloat16 --dataset synthetic \
        [--epochs 2 --iter_per_epoch 20] [--device cuda]

The loop is the JAX one on one device: `iter_per_epoch` train steps, the
epoch's metric means (the step metrics stay on the device until then), a
validation sweep of the main decoder, the plateau scheduler on val mDice, a
keep-best `best_model.pth` (the reference's training dict) and one line of
metrics JSONL per epoch under `--out_dir`. The step runs on `cuda` unless
`--device cpu` is given. Not ported yet: `--resume` and device-resident
pools (ROADMAP.md Queue A, "The rest of the Trainer and CLIs"), more than
one device ("Multi-GPU").
"""
from __future__ import annotations

import argparse
import os
import queue
import threading
import time
from typing import Dict, Iterator

import numpy as np
import torch

from uaps_tpu_torch.data import DefectDataset, SyntheticDefects
from uaps_tpu_torch.methods import base, get_method
from uaps_tpu_torch.utils.cli import parse_args
from uaps_tpu_torch.utils.logging_utils import MetricWriter, get_logger
from uaps_tpu_torch.utils.weights import save_pth


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


_BATCH_DTYPES = {"image": np.float32, "uimage": np.float32,
                 "label": np.int32, "mix_w": np.float32}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                            torch.Tensor]:
    """The step's arrays of a host batch on `device`: image and uimage f32,
    label int32, and mix_w f32 where the batch has it."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k], dt)).to(
        device) for k, dt in _BATCH_DTYPES.items() if k in batch}


class Trainer:
    def __init__(self, cfg, device="cuda", data=None):
        self.cfg = cfg
        self.device = base.resolve_device(device)
        self.logger = get_logger(cfg.run.out_dir)
        self.writer = MetricWriter(cfg.run.out_dir)
        self.method = get_method(cfg.method.name)
        self.data = data if data is not None else make_data(
            cfg, seed=cfg.run.seed)
        self.state, self.model = self.method.init_state(cfg, self.device)
        self.train_step = self.method.make_train_step(cfg, self.model)
        self.eval_step = base.make_eval_step(cfg, self.model)
        self.scheduler = base.PlateauScheduler(cfg.optim)
        self.best_dice = -1.0
        self.epochs_since_best = 0

    def validate(self) -> Dict[str, float]:
        """Mean over the validation batches of the eval step's metrics."""
        sums: Dict[str, float] = {}
        n = 0
        for batch in self.data.val_iter():
            m = self.eval_step(to_device(batch, self.device))
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}

    def run(self) -> float:
        cfg = self.cfg
        stream = _prefetch(self.data.train_iter())
        self.logger.info(
            f"method={cfg.method.name} model={cfg.model.name} "
            f"device={self.device} batch={cfg.data.batch_size} "
            f"image={cfg.data.image_size}")
        for epoch in range(1, cfg.run.epochs + 1):
            t0 = time.time()
            epoch_metrics = []
            for _ in range(cfg.run.iter_per_epoch):
                batch = to_device(next(stream), self.device)
                self.state, metrics = self.train_step(self.state, batch)
                epoch_metrics.append(metrics)
            # one device -> host copy per epoch
            stacked = {k: torch.stack([m[k] for m in epoch_metrics]).cpu()
                       for k in epoch_metrics[0]}
            means = {k: float(np.nanmean(v.double().numpy()))
                     for k, v in stacked.items()}
            dt = time.time() - t0
            means["imgs_per_sec"] = (cfg.run.iter_per_epoch
                                     * cfg.data.batch_size / dt)
            means["lr"] = base.get_lr(self.state)
            if cfg.run.halt_on_nan and not np.isfinite(means["loss"]):
                raise FloatingPointError(
                    f"non-finite loss {means['loss']} at epoch {epoch}")

            val = self.validate()
            self.state = self.scheduler.step(self.state, val["val_mdice"])
            self.writer.write(epoch, {**means, **val})
            self.logger.info(
                f"epoch {epoch:03d}/{cfg.run.epochs} "
                f"loss {means['loss']:.4f} "
                f"train_dice {means['train_mdice']:.4f} "
                f"val_dice {val['val_mdice']:.4f} "
                f"val_miou {val['val_miou']:.4f} "
                f"({means['imgs_per_sec']:.1f} img/s)")
            if val["val_mdice"] > self.best_dice:
                self.best_dice = val["val_mdice"]
                self.epochs_since_best = 0
                save_pth(self.model,
                         os.path.join(cfg.run.out_dir, "best_model.pth"),
                         {"epoch": epoch, "step": self.state.step,
                          "best_dice": self.best_dice})
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
