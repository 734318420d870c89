"""Fused cross-entropy + soft-Dice loss with its analytic gradient.

Counterpart of `uaps_tpu/pallas/ce_dice.py` (`fused_ce_dice`: forward
`_run_fwd` / `_fwd_kernel`, backward `_vjp_bwd` / `_bwd_kernel`). The CUDA
kernels are in `csrc/ce_dice.cu`; its note says what bounds them.

    forward:  stats [4, C] f32 = per class I_c = sum p_c y_c, P_c = sum p_c,
              Y_c = sum y_c (rows 0-2) and the nll sum (row 3, column 0),
              p = softmax(logits), y = one_hot(labels) (all-zero for a label
              outside [0, C)); CE = nll / N, Dice = 1 - mean_c 2 I_c /
              (P_c + Y_c + 1e-7) (eps in the denominator only).
    backward: dlogits = gce (p - y) + p (q - sum_c q_c p_c), q_c = qa_c y_c
              + qb_c, with qa = g_dice * -(2/C) / S, qb = g_dice * (2/C) I /
              S^2, S = P + Y + eps, gce = g_ce / N, formed here from the
              stats as at ce_dice.py:163-171.

Logits are f32 [B, H, W, C] with any dense strides (the model's NHWC logits
are a permuted view of the head's NCHW output; the kernels read them through
their strides and write dlogits with the same strides). On the kernel path
labels are int32 [B, H, W], contiguous (the data pipeline's dtype); the
plain versions take any integer dtype.

Dispatch: a CPU tensor goes to the plain versions (`ce_dice_stats_plain`,
`ce_dice_bwd_plain`); a CUDA tensor launches the kernels or raises. Launch
counts: `fwd_launches`, `bwd_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from uaps_tpu_torch.kernels import _build

EPS = 1e-7
MAX_CLASSES = 8
fwd_launches = 0  # forward kernel launches (reset by the caller)
bwd_launches = 0  # backward kernel launches


def _one_hot(labels: torch.Tensor, c: int) -> torch.Tensor:
    return (labels[..., None] == torch.arange(
        c, device=labels.device)).float()


def ce_dice_stats_plain(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """The plain forward: the [4, C] f32 stats, as the Pallas kernel
    computes them."""
    x = logits.float()
    c = x.shape[-1]
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    s = e.sum(-1, keepdim=True)
    p = e / s
    y = _one_hot(labels, c)
    nll = (torch.log(s) + m - (y * x).sum(-1, keepdim=True)).sum()
    dims = tuple(range(x.ndim - 1))
    row3 = torch.cat([nll[None], x.new_zeros(c - 1)])
    return torch.stack([(p * y).sum(dims), p.sum(dims), y.sum(dims), row3])


def ce_dice_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                      q: torch.Tensor, gce: torch.Tensor) -> torch.Tensor:
    """The plain backward: dlogits f32 from q [2C] (qa then qb) and gce
    [1]."""
    x = logits.float()
    c = x.shape[-1]
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    p = e / e.sum(-1, keepdim=True)
    y = _one_hot(labels, c)
    qv = q[:c] * y + q[c:]
    qdot = (qv * p).sum(-1, keepdim=True)
    return gce * (p - y) + p * (qv - qdot)


@functools.cache
def _fns():
    lib = _build.load("ce_dice")
    fwd = lib.uaps_ce_dice_fwd
    fwd.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4
                    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.uaps_ce_dice_bwd
    bwd.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4
                    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    lib.uaps_ce_dice_max_partials.restype = ctypes.c_int
    return lib, fwd, bwd, lib.uaps_ce_dice_max_partials()


def _check(logits: torch.Tensor, labels: torch.Tensor, what: str) -> None:
    if logits.dtype != torch.float32 or not 1 <= logits.shape[-1] <= \
            MAX_CLASSES:
        raise TypeError(f"{what}: logits must be float32 with 1..."
                        f"{MAX_CLASSES} classes; got {logits.dtype} "
                        f"{tuple(logits.shape)}")
    if labels.dtype != torch.int32 or not labels.is_contiguous():
        raise TypeError(f"{what}: labels must be contiguous int32 on the "
                        f"kernel path; got {labels.dtype}")
    if labels.device != logits.device:
        raise ValueError(f"{what}: labels on {labels.device}, logits on "
                         f"{logits.device}")


def _kernel_path(device: torch.device, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel for device {device}")


def ce_dice_stats(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits [B, H, W, C] f32, labels [B, H, W] -> stats [4, C] f32."""
    global fwd_launches
    if not _kernel_path(logits.device, "ce_dice_stats"):
        return ce_dice_stats_plain(logits, labels)
    _check(logits, labels, "ce_dice_stats")
    b, h, w, c = logits.shape
    lib, fwd, _, max_partials = _fns()
    part = torch.empty(max_partials * 4 * c, dtype=torch.float32,
                       device=logits.device)
    stats = torch.empty((4, c), dtype=torch.float32, device=logits.device)
    _build.call(lib, fwd, logits.device, "ce_dice_stats kernel launch",
                logits.data_ptr(), *logits.stride(), labels.data_ptr(),
                part.data_ptr(), stats.data_ptr(), b, h, w, c)
    fwd_launches += 1
    return stats


def ce_dice_bwd(logits: torch.Tensor, labels: torch.Tensor,
                q: torch.Tensor, gce: torch.Tensor) -> torch.Tensor:
    """dlogits (f32, the logits' strides) from q [2C] and gce [1]."""
    global bwd_launches
    if not _kernel_path(logits.device, "ce_dice_bwd"):
        return ce_dice_bwd_plain(logits, labels, q, gce)
    _check(logits, labels, "ce_dice_bwd")
    b, h, w, c = logits.shape
    out = torch.empty_like(logits)
    if out.stride() != logits.stride():
        raise ValueError("ce_dice_bwd: logits must be dense (a permuted "
                         "view is fine)")
    q = q.float().contiguous()
    gce = gce.float().contiguous()
    lib, _, bwd, _ = _fns()
    _build.call(lib, bwd, logits.device, "ce_dice_bwd kernel launch",
                logits.data_ptr(), *logits.stride(), labels.data_ptr(),
                q.data_ptr(), gce.data_ptr(), out.data_ptr(), b, h, w, c)
    bwd_launches += 1
    return out


def combine(stats: torch.Tensor, n: int) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(CE, Dice loss) from the stats of n pixels."""
    i_c, p_c, y_c = stats[0], stats[1], stats[2]
    dice = 1.0 - torch.mean(2.0 * i_c / (p_c + y_c + EPS))
    return stats[3, 0] / n, dice


def bwd_coefs(stats: torch.Tensor, g_ce, g_dice, n: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q [2C], gce [1]) of the backward for cotangents (g_ce, g_dice) of
    (CE, Dice) over n pixels: dDice/dp_c(x) = -(2/C) (y_c(x) S_c - I_c) /
    S_c^2, so q_c = qa_c y_c + qb_c (ce_dice.py:163-171)."""
    c = stats.shape[1]
    i_c, s_c = stats[0], stats[1] + stats[2] + EPS
    qa = g_dice * (-(2.0 / c) / s_c)
    qb = g_dice * ((2.0 / c) * i_c / (s_c * s_c))
    return torch.cat([qa, qb]), torch.reshape(
        torch.as_tensor(g_ce / n, dtype=torch.float32,
                        device=stats.device), (1,))


class _FusedCeDice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        stats = ce_dice_stats(logits, labels)
        ctx.save_for_backward(logits, labels, stats)
        return combine(stats, labels.numel())

    @staticmethod
    def backward(ctx, g_ce, g_dice):
        logits, labels, stats = ctx.saved_tensors
        q, gce = bwd_coefs(stats, g_ce, g_dice, labels.numel())
        return ce_dice_bwd(logits, labels, q, gce), None


def fused_ce_dice(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, H, W, C] f32, labels [B, H, W] int -> (ce, dice_loss)
    scalars; differentiable in logits."""
    if logits.ndim != 4 or tuple(labels.shape) != tuple(logits.shape[:3]):
        raise ValueError(f"fused_ce_dice: logits {tuple(logits.shape)}, "
                         f"labels {tuple(labels.shape)}; want [B,H,W,C], "
                         "[B,H,W]")
    return _FusedCeDice.apply(logits, labels)
