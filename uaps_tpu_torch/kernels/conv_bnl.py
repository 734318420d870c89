"""BN-normalise + LeakyReLU + 3x3 conv, differentiable: the second conv of
the fused ConvBlock (`conv_backend="fused"`).

Counterpart of `uaps_tpu/pallas/conv_bnl.py`: `conv3x3_bnl(y, f, s, w,
out_dtype)` = conv3x3_SAME(leaky(y * f + s), w), with the custom VJP of
conv_bnl.py:196-241 (dy = dz * leaky'(a) * f with df, ds reduced, and dW
from z recomputed in the prologue). y [B, C, H, W] is the first conv's raw
output (f32 or bf16; f64 on the plain path), f and s [C] f32 the first BN's
factor and shift, w [3, 3, C, Co] HWIO; the normalise runs in f32 and z is
cast to y's dtype before the conv; the halo outside the image is zero of z.

The same math as `kernels/block_conv.py`'s `chain_conv_bnl` with no dropout
and no moments, so on the card it launches the kernels of
`csrc/block_conv.cu` with the moments off, rate 0 and the cotangent
unfolded; the plain versions are `conv3x3_bnl_ref` (forward) and
block_conv's `chain_bwd_plain` (backward).

Dispatch: a CPU tensor goes to the plain versions; a CUDA tensor launches
the kernels (output dtype y's) or raises. Launch counts, one per call:
`fwd_launches`, `bwd_launches`.
"""
from __future__ import annotations

import torch

from uaps_tpu_torch.kernels import block_conv as bc
from uaps_tpu_torch.kernels.conv3x3_nchw import conv3x3_nchw_plain

# launch counts: a CUDA graph's capture ticks them, its replays do not
# (kernels/__init__.py)
fwd_launches = 0   # conv3x3_bnl forwards (reset by the caller)
bwd_launches = 0   # conv3x3_bnl backwards


def conv3x3_bnl_ref(y: torch.Tensor, f: torch.Tensor, s: torch.Tensor,
                    w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """JAX `conv3x3_bnl_reference`, differentiable through torch."""
    z = bc.prologue_plain(y, f, s, None, 0.0)
    return conv3x3_nchw_plain(z, w.to(z.dtype), out_dtype or y.dtype)


def _forward(y, f, s, w, out_dtype):
    global fwd_launches
    if not bc.kernel_path(y, "conv3x3_bnl"):
        with torch.no_grad():
            return conv3x3_bnl_ref(y, f, s, w, out_dtype)
    if out_dtype != y.dtype:
        raise TypeError(f"conv3x3_bnl: the kernel writes y's dtype "
                        f"{y.dtype}; asked for {out_dtype}")
    out, _ = bc.kernel_fwd(y.contiguous(), bc.w9(w, y.dtype), f, s, None, 0.0,
                           False, "conv3x3_bnl")
    fwd_launches += 1
    return out


def _backward(g, y, f, s, w):
    """(dy, df, ds, dW in w's dtype) from the output's cotangent g."""
    global bwd_launches
    g = g.to(y.dtype).contiguous()
    if not bc.kernel_path(y, "conv3x3_bnl"):
        dy, dw, df, ds = bc.chain_bwd_plain(g, y, w, f, s, None, 0.0)
    else:
        dy, dw, df, ds = bc.kernel_bwd(g, None, None, None, y,
                                       bc.w9(w, y.dtype), f, s, None, 0.0,
                                       True, "conv3x3_bnl")
        bwd_launches += 1
    return dy, df.to(f.dtype), ds.to(s.dtype), dw.to(w.dtype)


class _ConvBnl(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, f, s, w, out_dtype):
        ctx.save_for_backward(y, f, s, w)
        return _forward(y, f, s, w, out_dtype)

    @staticmethod
    def backward(ctx, g):
        y, f, s, w = ctx.saved_tensors
        return (*_backward(g, y, f, s, w), None)


def conv3x3_bnl(y: torch.Tensor, f: torch.Tensor, s: torch.Tensor,
                w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """y [B, C, H, W] raw conv output, f, s [C] f32, w [3, 3, C, Co] ->
    conv3x3_SAME(leaky(y * f + s), w) [B, Co, H, W] in out_dtype (default
    y's), no bias; differentiable in y, f, s and w."""
    if y.ndim != 4 or w.ndim != 4 or w.shape[:3] != (3, 3, y.shape[1]):
        raise ValueError(f"conv3x3_bnl: y {tuple(y.shape)}, w "
                         f"{tuple(w.shape)}; want [B,C,H,W], [3,3,C,Co]")
    out_dtype = out_dtype or y.dtype
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, f, s, w)):
        return _ConvBnl.apply(y, f, s, w, out_dtype)
    return _forward(y, f, s, w, out_dtype)
