"""Hyperparameter ramp schedules: the port's `uaps_tpu/ops/ramps.py`
(the mean-teacher ramps), in f32 as JAX computes them. `current` is a
Python number or a tensor; each returns a 0-d f32 tensor."""
from __future__ import annotations

import math

import torch


def _f32(current) -> torch.Tensor:
    return torch.as_tensor(current, dtype=torch.float32)


def sigmoid_rampup(current, rampup_length) -> torch.Tensor:
    """exp(-5 (1 - t/T)^2), t clipped to [0, T]; 1 when T == 0."""
    if rampup_length == 0:
        return torch.tensor(1.0)
    current = torch.clamp(_f32(current), 0.0, rampup_length)
    phase = 1.0 - current / rampup_length
    return torch.exp(-5.0 * phase * phase)


def linear_rampup(current, rampup_length) -> torch.Tensor:
    """min(t/T, 1), clipped below at 0; 1 when T == 0."""
    if rampup_length == 0:
        return torch.tensor(1.0)
    return torch.clamp(_f32(current) / rampup_length, 0.0, 1.0)


def cosine_rampdown(current, rampdown_length) -> torch.Tensor:
    """0.5 (cos(pi t/T) + 1)."""
    return 0.5 * (torch.cos(math.pi * _f32(current) / rampdown_length) + 1.0)
