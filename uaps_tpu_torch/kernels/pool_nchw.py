"""2x2 stride-2 max-pool over NCHW activations, forward only.

Counterpart of `uaps_tpu/pallas/pool_nchw.py` (`max_pool_2x2_nchw`, body
`_fwd_kernel`, and the shape gate `pool_pallas_ok`). The CUDA kernel is
`csrc/pool_nchw.cu`. NaN propagates as with `jnp.maximum`.

Dispatch: a CPU tensor goes to the plain twin `max_pool_2x2_nchw_plain`
(`F.max_pool2d(x, 2)`); a CUDA tensor launches the kernel or raises. Forward
only until the training slice ports the first-max tie-routed backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from uaps_tpu_torch.kernels import _build

launches = 0  # kernel launches by max_pool_2x2_nchw (reset by the caller)

_VEC_COLS = {torch.float32: 4, torch.bfloat16: 8}  # columns per 16 B load


def max_pool_2x2_nchw_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain twin."""
    return F.max_pool2d(x, 2)


def _pick_rows(h: int) -> int:
    for r in (32, 16):
        if h % r == 0:
            return r
    return h


def pool_pallas_ok(x: torch.Tensor) -> bool:
    """The JAX shape gate (uaps_tpu/pallas/pool_nchw.py `pool_pallas_ok`):
    where the model routes a pool to the kernel."""
    if x.ndim != 4:
        return False
    _, c, h, w = x.shape
    return (h >= 16 and h % 16 == 0 and w >= 128 and w % 128 == 0
            and c <= 64 and c * _pick_rows(h) * w * 4 <= (2 << 20))


@functools.cache
def _fn():
    lib = _build.load("pool_nchw")
    fn = lib.uaps_max_pool_2x2_nchw_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(x: torch.Tensor) -> torch.Tensor:
    global launches
    b, c, h, w = x.shape
    if x.dtype not in _VEC_COLS:
        raise TypeError(f"max_pool_2x2_nchw: unsupported dtype {x.dtype}")
    if (not x.is_contiguous() or x.data_ptr() % 16 or h % 2
            or w % _VEC_COLS[x.dtype]):
        raise ValueError(
            f"max_pool_2x2_nchw: needs a contiguous 16-byte aligned x with "
            f"even H and W a multiple of {_VEC_COLS[x.dtype]}; got "
            f"{tuple(x.shape)}")
    y = torch.empty((b, c, h // 2, w // 2), dtype=x.dtype, device=x.device)
    lib, fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), b * c, h, w,
                 _build.DTYPE_CODES[x.dtype], stream)
    _build.check(lib, err, "max_pool_2x2_nchw kernel launch")
    launches += 1
    return y


def max_pool_2x2_nchw(x: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] -> [B, C, H/2, W/2], 2x2 window, stride 2."""
    _build.forward_only("max_pool_2x2_nchw", x)
    if x.ndim != 4:
        raise ValueError(f"max_pool_2x2_nchw: x {tuple(x.shape)} is not 4-D")
    if x.device.type == "cpu":
        return max_pool_2x2_nchw_plain(x)
    if x.device.type == "cuda":
        return _launch(x)
    raise ValueError(f"max_pool_2x2_nchw: no kernel for device {x.device}")
