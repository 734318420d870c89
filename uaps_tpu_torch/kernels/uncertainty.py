"""Fused multi-decoder uncertainty maps + Dirichlet-mixed pseudo-label, with
the analytic gradient.

Counterpart of `uaps_tpu/pallas/uncertainty.py` (`fused_uncertainty`:
forward `_pallas_fwd` / `_fwd_kernel`, backward `_fused_bwd` /
`_bwd_kernel`, oracle `_reference_impl`). The CUDA kernels are in
`csrc/uncertainty.cu`; its note says what bounds them.

    forward:  s_d = softmax(logits_d), p = mean_d s_d,
              var_d = sum_c p_c (log max(p_c, 1e-30) - log s_{d,c}),
              pseudo = argmax_c sum_d w_d s_{d,c} (int32; first max wins);
    backward: dx_{d,c} = g_d (s_{d,c} - p_c) + (1/D) s_{d,c} (q_c - <s_d, q>)
              with q_c = G (1 + log p_c) - sum_e g_e log s_{e,c}, G = sum g;
              gradients flow through both the log-softmax and the shared
              mean p, as `ops.losses.kl_divergence_map` does.

The logits are D f32 tensors [B, H, W, C] with any dense strides (the
model's NHWC views of NCHW head outputs): the kernels read them, and the
backward writes each dx, through those strides, so nothing is stacked or
copied. `w` [D] stays on the device and is a constant (no gradient).

Dispatch: CPU tensors go to the plain versions (`uncertainty_fwd_plain`,
`uncertainty_bwd_plain`); CUDA tensors launch the kernels or raise. Launch
counts: `fwd_launches`, `bwd_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from uaps_tpu_torch.kernels import _build

TINY = 1e-30   # log clamp of the mean prediction, as in JAX
MAX_CLASSES = 8
# launch counts: a CUDA graph's capture ticks them, its replays do not
# (kernels/__init__.py)
fwd_launches = 0  # forward kernel launches (reset by the caller)
bwd_launches = 0  # backward kernel launches


def uncertainty_fwd_plain(logits: Sequence[torch.Tensor], w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: (var [D, B, H, W] f32, pseudo [B, H, W] int32),
    as JAX's `_reference_impl` computes them."""
    x = torch.stack([lg.float() for lg in logits])
    softs = torch.softmax(x, -1)
    preds = softs.mean(0)
    lp = torch.log(torch.clamp(preds, min=TINY))
    var = (preds * (lp - torch.log_softmax(x, -1))).sum(-1)
    mix = torch.einsum("d,dbhwc->bhwc", w.float(), softs)
    return var, mix.argmax(-1).to(torch.int32)


def uncertainty_bwd_plain(logits: Sequence[torch.Tensor],
                          g_var: torch.Tensor) -> List[torch.Tensor]:
    """The plain backward: each decoder's dlogits from the cotangent g_var
    [D, B, H, W] of var, the kernel's formula."""
    x = torch.stack([lg.float() for lg in logits])
    logs = torch.log_softmax(x, -1)
    s = torch.softmax(x, -1)
    p = s.mean(0)
    g = g_var.float()[..., None]
    q = g.sum(0) * (1.0 + torch.log(torch.clamp(p, min=TINY))) - (
        g * logs).sum(0)
    t = (s * q).sum(-1, keepdim=True)
    dx = g * (s - p) + (1.0 / len(logits)) * s * (q - t)
    return [d.to(lg.dtype) for d, lg in zip(dx.unbind(0), logits)]


@functools.cache
def _fns():
    lib = _build.load("uncertainty")
    ptrs, strides = (ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_longlong))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fwd = lib.uaps_uncertainty_fwd
    fwd.argtypes = [ptrs, strides, i32, vp, vp, vp] + [i32] * 4 + [vp]
    fwd.restype = ctypes.c_int
    bwd = lib.uaps_uncertainty_bwd
    bwd.argtypes = [ptrs, strides, i32, vp, ptrs] + [i32] * 4 + [vp]
    bwd.restype = ctypes.c_int
    lib.uaps_uncertainty_max_decoders.restype = ctypes.c_int
    return lib, fwd, bwd, lib.uaps_uncertainty_max_decoders()


def _kernel_path(logits: Sequence[torch.Tensor], what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU);
    raises for another device or logits the kernel does not take."""
    dev = logits[0].device
    shape = tuple(logits[0].shape)
    if len(shape) != 4 or any(tuple(lg.shape) != shape or lg.device != dev
                              for lg in logits):
        raise ValueError(f"{what}: want D logits [B, H, W, C] of one shape "
                         f"on one device; got "
                         f"{[(tuple(lg.shape), str(lg.device)) for lg in logits]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    max_dec = _fns()[3]
    if (not 1 <= len(logits) <= max_dec or not 1 <= shape[3] <= MAX_CLASSES
            or any(lg.dtype != torch.float32 for lg in logits)):
        raise TypeError(f"{what}: the kernel takes 1..{max_dec} float32 "
                        f"logits with 1..{MAX_CLASSES} classes; got "
                        f"{len(logits)} x {shape} "
                        f"{[lg.dtype for lg in logits]}")
    return True


def uncertainty_fwd(logits: Sequence[torch.Tensor], w: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(var [D, B, H, W] f32, pseudo [B, H, W] int32) of D logits."""
    global fwd_launches
    if not _kernel_path(logits, "fused_uncertainty"):
        return uncertainty_fwd_plain(logits, w)
    d = len(logits)
    b, h, wd, c = logits[0].shape
    if tuple(w.shape) != (d,) or w.device != logits[0].device:
        raise ValueError(f"fused_uncertainty: w {tuple(w.shape)} on "
                         f"{w.device}; want [{d}] on {logits[0].device}")
    w = w.float().contiguous()
    var = torch.empty((d, b, h, wd), dtype=torch.float32,
                      device=logits[0].device)
    pseudo = torch.empty((b, h, wd), dtype=torch.int32,
                         device=logits[0].device)
    lib, fwd, _, _ = _fns()
    ptrs, strides = _build.decoder_arrays(logits)
    _build.call(lib, fwd, logits[0].device, "fused_uncertainty kernel launch",
                ptrs, strides, d, w.data_ptr(), var.data_ptr(),
                pseudo.data_ptr(), b, h, wd, c)
    fwd_launches += 1
    return var, pseudo


def uncertainty_bwd(logits: Sequence[torch.Tensor],
                    g_var: torch.Tensor) -> List[torch.Tensor]:
    """Each decoder's dlogits (f32, that logits' strides) from the
    cotangent g_var [D, B, H, W] of var."""
    global bwd_launches
    if not _kernel_path(logits, "fused_uncertainty_bwd"):
        return uncertainty_bwd_plain(logits, g_var)
    d = len(logits)
    b, h, wd, c = logits[0].shape
    if tuple(g_var.shape) != (d, b, h, wd):
        raise ValueError(f"fused_uncertainty_bwd: g_var "
                         f"{tuple(g_var.shape)}; want {(d, b, h, wd)}")
    dx = [torch.empty_like(lg) for lg in logits]
    if any(o.stride() != lg.stride() for o, lg in zip(dx, logits)):
        raise ValueError("fused_uncertainty_bwd: logits must be dense (a "
                         "permuted view is fine)")
    g = g_var.float().contiguous()
    lib, _, bwd, _ = _fns()
    ptrs, strides = _build.decoder_arrays(logits)
    out = (ctypes.c_void_p * d)(*[o.data_ptr() for o in dx])
    _build.call(lib, bwd, logits[0].device,
                "fused_uncertainty_bwd kernel launch", ptrs, strides, d,
                g.data_ptr(), out, b, h, wd, c)
    bwd_launches += 1
    return dx


class _FusedUncertainty(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, *logits):
        var, pseudo = uncertainty_fwd(logits, w)
        ctx.save_for_backward(*logits)
        ctx.mark_non_differentiable(pseudo)
        return var, pseudo

    @staticmethod
    def backward(ctx, g_var, _):
        return (None, *uncertainty_bwd(ctx.saved_tensors, g_var))


def fused_uncertainty(logits: Sequence[torch.Tensor], w: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """D logits [B, H, W, C], mix weights w [D] -> (var [D, B, H, W] f32,
    differentiable in the logits; pseudo [B, H, W] int32, contiguous, no
    gradient)."""
    return _FusedUncertainty.apply(w.detach(), *logits)
