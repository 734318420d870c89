"""Run logging: the port's copy of `uaps_tpu/utils/logging_utils.py`.

`get_logger` writes to stdout and `<log_dir>/run.log`; `MetricWriter`
appends one JSON line per call to `<log_dir>/metrics.jsonl` (the JAX
package's optional TensorBoard sink is left out). Metrics may arrive as
device tensors; they are converted once, here.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict


def get_logger(log_dir: str, name: str = "uaps") -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(f"{name}:{log_dir}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        fh = logging.FileHandler(os.path.join(log_dir, "run.log"))
        fh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict, prefix: str = ""):
        scalars = {}
        for k, v in metrics.items():
            try:
                scalars[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        rec = {"step": step, "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
