"""3x3 SAME stride-1 convolution over NHWC activations, differentiable.

Counterpart of `uaps_tpu/pallas/conv3x3.py`: `conv3x3_forward` (the
implicit-GEMM kernel), `conv3x3_wgrad`, the custom VJP `conv3x3_small` and
the oracle `reference_conv3x3`. One CUDA source, `csrc/conv3x3_nhwc.cu`
(forward, dgrad as the forward with flipped weights, weight gradient; bf16
on the tensor cores, f32 on the CUDA cores); its note says what bounds it
and how the design answers that.

Contract (as in JAX): x [B, H, W, Cin] f32 or bf16 (f64 on the plain
path), w [3, 3, Cin, Cout] HWIO, cast to x's dtype; zero halo; f32
accumulation; output [B, H, W, Cout] in x's dtype. `conv3x3_wgrad(x, g)`,
g [B, H, W, Cout]: dW [3, 3, Cin, Cout] f32. The VJP of `conv3x3_small`:
dx = the forward of g (cast to x's dtype) with w flipped in (kh, kw) and
its in/out channels swapped, dW = `conv3x3_wgrad(x, g)` cast to w's dtype.

Dispatch: a CPU tensor goes to the plain versions
(`conv3x3_forward_plain`, `conv3x3_wgrad_plain`); a CUDA tensor launches
the kernels or raises, never falls back. Launch counts: `nhwc_launches`
(forward and dgrad), `nhwc_wgrad_launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from uaps_tpu_torch.kernels import _build
from uaps_tpu_torch.kernels.conv3x3_nchw import (conv3x3_nchw_plain,
                                                 conv3x3_nchw_wgrad_plain,
                                                 kernel_path, wgrad_strips)

# launch counts: a CUDA graph's capture ticks them, its replays do not
# (kernels/__init__.py)
nhwc_launches = 0        # forward kernel launches, dgrad included
nhwc_wgrad_launches = 0  # weight-gradient kernel launches


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def conv3x3_forward_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain forward: the plain NCHW conv of the NCHW view, in (at
    least) f32, cast to x's dtype, returned contiguous NHWC."""
    y = conv3x3_nchw_plain(_nchw(x), w.to(x.dtype))
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain weight gradient of the NCHW views: f32 [3, 3, Cin, Cout]
    (f64 for f64 inputs)."""
    return conv3x3_nchw_wgrad_plain(_nchw(x), _nchw(g))


def reference_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The oracle (JAX: XLA's conv): F.conv2d in the inputs' dtype, NHWC
    in and out."""
    return F.conv2d(_nchw(x), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


@functools.cache
def _fns():
    lib = _build.load("conv3x3_nhwc")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fwd = lib.uaps_conv3x3_nhwc_fwd
    fwd.argtypes = [vp] * 3 + [i32] * 10 + [vp]
    wgrad = lib.uaps_conv3x3_nhwc_wgrad
    wgrad.argtypes = [vp] * 4 + [i32] * 7 + [vp]
    for fn in (fwd, wgrad):
        fn.restype = ctypes.c_int
    return lib, fwd, wgrad


def _check(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    if x.ndim != 4 or w.ndim != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{what}: x {tuple(x.shape)}, w {tuple(w.shape)}; "
                         "want [B,H,W,Cin], [3,3,Cin,Cout]")


def _grid_groups(dtype: torch.dtype, cout: int) -> int:
    """The output-channel groups along the kernel grid's z (with the
    batch): bf16 runs the tensor-core tile (one group up to 32 channels,
    else groups of 64), f32 the CUDA-core tile (groups of 32)."""
    if dtype == torch.bfloat16:
        return 1 if cout <= 32 else -(-cout // 64)
    return -(-cout // 32)


def _launch(x: torch.Tensor, w: torch.Tensor, flipped: bool) -> torch.Tensor:
    """The CUDA conv of x with w (in x's dtype), or (flipped) with w
    flipped in (kh, kw) and its channels swapped, read through negated
    strides from w[2, 2, 0, 0] as the NCHW dgrad does. Counts nothing."""
    what = "conv3x3_nhwc dgrad" if flipped else "conv3x3_nhwc"
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"{what}: x {x.dtype} and w {w.dtype} must both be "
                        "float32 or both bfloat16")
    if not x.is_contiguous() or w.device != x.device:
        raise ValueError(f"{what}: x must be contiguous, w on its device")
    b, h, wd, cin = x.shape
    s_kh, s_kw, s_ci, s_co = w.stride()
    ptr = w.data_ptr()
    cout = w.shape[3]
    if flipped:
        cout = w.shape[2]
        ptr += (2 * s_kh + 2 * s_kw) * w.element_size()
        s_kh, s_kw, s_ci, s_co = -s_kh, -s_kw, s_co, s_ci
    groups = _grid_groups(x.dtype, cout)
    if b * groups > 65535:
        raise ValueError(f"{what}: B * {groups} channel groups = "
                         f"{b * groups} > 65535")
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    lib, fwd, _ = _fns()
    _build.call(lib, fwd, x.device, f"{what} kernel launch", x.data_ptr(),
                ptr, y.data_ptr(), b, cin, cout, h, wd, s_kh, s_kw, s_ci,
                s_co, _build.DTYPE_CODES[x.dtype])
    return y


def conv3x3_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, Cin], w [3, 3, Cin, Cout] -> [B, H, W, Cout] in x's
    dtype (JAX `conv3x3_forward`). Not differentiable (`conv3x3_small`
    is)."""
    global nhwc_launches
    _check(x, w, "conv3x3_forward")
    w = w.to(x.dtype)
    if not kernel_path(x, "conv3x3_forward"):
        return conv3x3_forward_plain(x, w)
    y = _launch(x, w, flipped=False)
    nhwc_launches += 1
    return y


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx [B, H, W, Cin] in g's dtype from g [B, H, W, Cout] and the
    forward's w [3, 3, Cin, Cout] (JAX: conv3x3_forward of g with
    `flip(w, (0, 1)).transpose(0, 1, 3, 2)`)."""
    global nhwc_launches
    w = w.to(g.dtype)
    if not kernel_path(g, "conv3x3_dgrad"):
        return conv3x3_forward_plain(g, w.flip((0, 1)).transpose(2, 3))
    dx = _launch(g, w, flipped=True)
    nhwc_launches += 1
    return dx


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, Cin], g [B, H, W, Cout] -> dW [3, 3, Cin, Cout] f32
    (JAX `conv3x3_wgrad`)."""
    global nhwc_wgrad_launches
    if x.ndim != 4 or g.ndim != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}; want [B,H,W,Cin], [B,H,W,Cout]")
    if not kernel_path(x, "conv3x3_wgrad"):
        return conv3x3_wgrad_plain(x, g)
    if x.dtype not in _build.DTYPE_CODES or g.dtype != x.dtype:
        raise TypeError(f"conv3x3_wgrad: x {x.dtype} and g {g.dtype} must "
                        "both be float32 or both bfloat16")
    if not (x.is_contiguous() and g.is_contiguous()) or g.device != x.device:
        raise ValueError("conv3x3_wgrad: x and g must be contiguous and on "
                         "one device")
    b, h, wd, cin = x.shape
    cout = g.shape[3]
    rows, n_part = wgrad_strips(x.dtype, b, cin, cout, h, wd)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    lib, _, wgrad = _fns()
    _build.call(lib, wgrad, x.device, "conv3x3_wgrad kernel launch",
                x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                b, cin, cout, h, wd, rows, _build.DTYPE_CODES[x.dtype])
    nhwc_wgrad_launches += 1
    return dw


class _Conv3x3Small(torch.autograd.Function):
    """conv3x3_forward with JAX's `conv3x3_small` VJP as its backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_forward(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype).contiguous()
        dx = conv3x3_dgrad(g, w) if ctx.needs_input_grad[0] else None
        dw = (conv3x3_wgrad(x, g).to(w.dtype)
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def conv3x3_small(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The differentiable NHWC conv (JAX `conv3x3_small`)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3Small.apply(x, w)
    return conv3x3_forward(x, w)
