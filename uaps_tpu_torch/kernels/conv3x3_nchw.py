"""3x3 SAME stride-1 convolution over NCHW activations, forward only.

Counterpart of `uaps_tpu/pallas/conv3x3_nchw.py` (`conv3x3_nchw` with its
default body `_fwd_kernel_dwkf`, and the entries `conv3x3_fast_nchw` and
`conv3x3_fast_flat`). The CUDA kernel is `csrc/conv3x3_nchw.cu`; its source
note says what bounds it and how the design answers that.

Contract (as in JAX): x [B, Cin, H, W], or the flat view [B, Cin, H*W] with
`hw=(H, W)` (the same memory in torch); w [3, 3, Cin, Cout] in HWIO order
(any strides, in x's dtype on the kernel path);
zero halo; f32 or bf16 input, f32 accumulation, output `out_dtype or
x.dtype`. The caller adds the bias.

Dispatch: a CPU tensor goes to the plain twin `conv3x3_nchw_plain`; a CUDA
tensor launches the kernel or raises, never falls back. Forward only until
the training slice brings the dgrad/wgrad kernels: a call that would need a
gradient raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from uaps_tpu_torch.kernels import _build

launches = 0  # kernel launches by conv3x3_nchw (reset by the caller)

_OUT_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32)}
MAX_COUT = 32


def conv3x3_nchw_plain(x: torch.Tensor, w: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """The plain twin: F.conv2d in f32 on the f32-cast inputs, cast to the
    output dtype. x [B, Cin, H, W], w [3, 3, Cin, Cout] HWIO."""
    y = F.conv2d(x.float(), w.float().permute(3, 2, 0, 1), padding=1)
    return y.to(out_dtype or x.dtype)


@functools.cache
def _fn():
    lib = _build.load("conv3x3_nchw")
    fn = lib.uaps_conv3x3_nchw_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(x: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    global launches
    b, cin, h, wd = x.shape
    if (x.dtype, out_dtype) not in _OUT_PAIRS:
        raise TypeError(f"conv3x3_nchw: unsupported dtypes {x.dtype} -> "
                        f"{out_dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_nchw: x must be contiguous")
    cout = w.shape[3]
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"conv3x3_nchw: w ({w.dtype}, {w.device}) must "
                         f"match x ({x.dtype}, {x.device})")
    if not 1 <= cout <= MAX_COUT or b > 65535:
        raise ValueError(f"conv3x3_nchw: Cout={cout} (max {MAX_COUT}), "
                         f"B={b} (max 65535)")
    y = torch.empty((b, cout, h, wd), dtype=out_dtype, device=x.device)
    codes = _build.DTYPE_CODES
    lib, fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # the kernel reads w (any HWIO view) through its strides
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, cin, cout,
                 h, wd, *w.stride(), codes[x.dtype], codes[out_dtype],
                 stream)
    _build.check(lib, err, "conv3x3_nchw kernel launch")
    launches += 1
    return y


def conv3x3_nchw(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
                 hw=None) -> torch.Tensor:
    """x [B, Cin, H, W] (or [B, Cin, H*W] with hw=(H, W)), w [3, 3, Cin,
    Cout] -> [B, Cout, H, W] (flat in, flat out)."""
    _build.forward_only("conv3x3_nchw", x, w)
    flat = hw is not None
    if flat:
        x = x.view(x.shape[0], x.shape[1], *hw)
    if x.ndim != 4 or w.ndim != 4 or w.shape[:3] != (3, 3, x.shape[1]):
        raise ValueError(f"conv3x3_nchw: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}; want [B,Cin,H,W], [3,3,Cin,Cout]")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        y = conv3x3_nchw_plain(x, w, out_dtype)
    elif x.device.type == "cuda":
        y = _launch(x, w, out_dtype)
    else:
        raise ValueError(f"conv3x3_nchw: no kernel for device {x.device}")
    return y.flatten(2) if flat else y


def conv3x3_fast_nchw(x: torch.Tensor, w: torch.Tensor,
                      out_dtype=None) -> torch.Tensor:
    """The NCHW entry (JAX `conv3x3_fast_nchw`; the logits head calls it
    with bf16 inputs and out_dtype=torch.float32)."""
    return conv3x3_nchw(x, w, out_dtype)


def conv3x3_fast_flat(x: torch.Tensor, w: torch.Tensor, hw,
                      out_dtype=None) -> torch.Tensor:
    """The flat entry (JAX `conv3x3_fast_flat`): x [B, Cin, H*W] ->
    [B, Cout, H*W]."""
    return conv3x3_nchw(x, w, out_dtype, hw=hw)


def conv_kernel_ok(h: int, w: int, cin: int, cout: int) -> bool:
    """The JAX shape gate for the Pallas conv (uaps_tpu/models/unet.py
    Conv3x3, `use_pallas`): where the model routes a conv to the kernel."""
    return (h >= 128 and w >= 128 and h % 8 == 0 and w % 128 == 0
            and cout <= MAX_COUT and cin <= 64)
