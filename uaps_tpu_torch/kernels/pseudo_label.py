"""Fused Dirichlet-mixed pseudo-label.

Counterpart of `uaps_tpu/pallas/pseudo_label.py` (`fused_pseudo_label`,
kernel `_kernel`, oracle `_reference_impl`). The CUDA kernel is in
`csrc/pseudo_label.cu`; its note says what bounds it.

    pseudo = argmax_c sum_d w_d softmax_c(logits_d)      (int32 [B, H, W])

in f32 after the load: per decoder the max-subtracted softmax, the mix in
decoder order, and ties to the lowest class. The logits are D tensors
[B, H, W, C], f32 or bf16, with any dense strides (the model's NHWC views
of NCHW head outputs), read through those strides: nothing is stacked or
transposed. `w` [D] stays on the device. The label is a constant: the
wrapper detaches its inputs and builds no autograd graph.

Dispatch: CPU tensors go to the plain version (`pseudo_label_plain`); CUDA
tensors launch the kernel or raise. Launch count: `launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from uaps_tpu_torch.kernels import _build

MAX_CLASSES = 8
# launch counts: a CUDA graph's capture ticks them, its replays do not
# (kernels/__init__.py)
launches = 0  # kernel launches (reset by the caller)


def mixture(logits: Sequence[torch.Tensor], w: torch.Tensor
            ) -> torch.Tensor:
    """sum_d w_d softmax(logits_d) in f32 [B, H, W, C], the kernel's
    formula: exp(x - max) * (1 / sum) per decoder, added in decoder
    order."""
    mix = None
    for d, lg in enumerate(logits):
        x = lg.detach().float()
        e = torch.exp(x - x.amax(-1, keepdim=True))
        term = w[d].detach().float() * (e * (1.0 / e.sum(-1, keepdim=True)))
        mix = term if mix is None else mix + term
    return mix


def pseudo_label_plain(logits: Sequence[torch.Tensor], w: torch.Tensor
                       ) -> torch.Tensor:
    """The plain version: the argmax of `mixture`, int32 [B, H, W], the
    first maximum winning."""
    return mixture(logits, w).argmax(-1).to(torch.int32)


@functools.cache
def _fns():
    lib = _build.load("pseudo_label")
    fn = lib.uaps_pseudo_label
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong), i32, vp, vp] + (
        [i32] * 5) + [vp]
    fn.restype = ctypes.c_int
    lib.uaps_pseudo_label_max_decoders.restype = ctypes.c_int
    return lib, fn, lib.uaps_pseudo_label_max_decoders()


def _kernel_path(logits: Sequence[torch.Tensor], w: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU);
    raises for another device or inputs the kernel does not take."""
    if not logits:
        raise ValueError("fused_pseudo_label: no logits")
    dev = logits[0].device
    shape = tuple(logits[0].shape)
    if (len(shape) != 4 or w.device != dev
            or any(tuple(lg.shape) != shape or lg.device != dev
                   for lg in logits)):
        raise ValueError(
            "fused_pseudo_label: want D logits [B, H, W, C] of one shape "
            "and w on one device; got "
            f"{[(tuple(lg.shape), str(lg.device)) for lg in logits]}, w on "
            f"{w.device}")
    if tuple(w.shape) != (len(logits),):
        raise ValueError(f"fused_pseudo_label: w {tuple(w.shape)}; want "
                         f"[{len(logits)}]")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"fused_pseudo_label: no kernel for device {dev}")
    max_dec = _fns()[2]
    dtype = logits[0].dtype
    if (not 1 <= len(logits) <= max_dec or not 1 <= shape[3] <= MAX_CLASSES
            or dtype not in _build.DTYPE_CODES
            or any(lg.dtype != dtype for lg in logits)):
        raise TypeError(
            f"fused_pseudo_label: the kernel takes 1..{max_dec} logits of "
            f"one dtype (float32 or bfloat16) with 1..{MAX_CLASSES} "
            f"classes; got {len(logits)} x {shape} "
            f"{[lg.dtype for lg in logits]}")
    return True


def fused_pseudo_label(logits: Sequence[torch.Tensor], w: torch.Tensor
                       ) -> torch.Tensor:
    """D logits [B, H, W, C], mix weights w [D] -> the mixed pseudo-label,
    int32 [B, H, W], contiguous, without gradient."""
    global launches
    logits = [lg.detach() for lg in logits]
    w = w.detach()
    if not _kernel_path(logits, w):
        return pseudo_label_plain(logits, w)
    d = len(logits)
    b, h, wd, c = logits[0].shape
    w = w.float().contiguous()
    pseudo = torch.empty((b, h, wd), dtype=torch.int32,
                         device=logits[0].device)
    lib, fn, _ = _fns()
    ptrs, strides = _build.decoder_arrays(logits)
    _build.call(lib, fn, logits[0].device, "fused_pseudo_label kernel launch",
                ptrs, strides, d, w.data_ptr(), pseudo.data_ptr(), b, h, wd,
                c, _build.DTYPE_CODES[logits[0].dtype])
    launches += 1
    return pseudo
