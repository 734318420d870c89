"""2x2 stride-2 max-pool over NCHW activations, differentiable.

Counterpart of `uaps_tpu/pallas/pool_nchw.py` (`max_pool_2x2_nchw` with its
custom VJP: forward body `_fwd_kernel`, backward `_pool_bwd` / `_bwd_kernel`,
and the shape gate `pool_pallas_ok`). The CUDA kernels are in
`csrc/pool_nchw.cu`. The forward propagates NaN as `jnp.maximum` does; the
backward routes each window's cotangent (cast to x's dtype) to the FIRST
position, in row-major window order, that equals the window's max, and a
window whose max is NaN routes nothing.

Dispatch: a CPU tensor goes to the plain versions
(`max_pool_2x2_nchw_plain`, `max_pool_2x2_nchw_bwd_plain`); a CUDA tensor
launches the kernels or raises. The forward goes through the operator
`uaps::max_pool_2x2_nchw` on both devices (kernels/custom_ops.py, whose
CUDA implementation is `_launch_fwd`). Launch counts: `launches`
(forward), `bwd_launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from uaps_tpu_torch.kernels import _build

# launch counts: a CUDA graph's capture ticks them, its replays do not
# (kernels/__init__.py)
launches = 0      # forward kernel launches (reset by the caller)
bwd_launches = 0  # backward kernel launches

_VEC_COLS = {torch.float32: 4, torch.bfloat16: 8}  # columns per 16 B load


def max_pool_2x2_nchw_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain forward."""
    return F.max_pool2d(x, 2)


def max_pool_2x2_nchw_bwd_plain(x: torch.Tensor,
                                g: torch.Tensor) -> torch.Tensor:
    """The plain backward, first-max routing written out: dx [B, C, H, W]
    in x's dtype holds g at the first row-major position of each window
    equal to its max (none for a NaN max), zeros elsewhere."""
    b, c, h, w = x.shape
    win = (x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
           .reshape(b, c, h // 2, w // 2, 4))       # (0,0) (0,1) (1,0) (1,1)
    eq = win == win.amax(-1, keepdim=True)
    first = eq & (eq.cumsum(-1) == 1)
    d = torch.where(first, g.to(x.dtype)[..., None], x.new_zeros(()))
    return (d.reshape(b, c, h // 2, w // 2, 2, 2).permute(0, 1, 2, 4, 3, 5)
            .reshape(b, c, h, w))


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
def _fns():
    lib = _build.load("pool_nchw")
    fwd = lib.uaps_max_pool_2x2_nchw_fwd
    fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.uaps_max_pool_2x2_nchw_bwd
    bwd.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return lib, fwd, bwd


def _check(t: torch.Tensor, what: str) -> None:
    b, c, h, w = t.shape
    if t.dtype not in _VEC_COLS:
        raise TypeError(f"{what}: unsupported dtype {t.dtype}")
    if (not t.is_contiguous() or t.data_ptr() % 16 or h % 2
            or w % _VEC_COLS[t.dtype]):
        raise ValueError(
            f"{what}: needs a contiguous 16-byte aligned tensor with even H "
            f"and W a multiple of {_VEC_COLS[t.dtype]}; got {tuple(t.shape)}")


def _launch_fwd(x: torch.Tensor) -> torch.Tensor:
    global launches
    _check(x, "max_pool_2x2_nchw")
    b, c, h, w = x.shape
    y = torch.empty((b, c, h // 2, w // 2), dtype=x.dtype, device=x.device)
    lib, fwd, _ = _fns()
    _build.call(lib, fwd, x.device, "max_pool_2x2_nchw kernel launch",
                x.data_ptr(), y.data_ptr(), b * c, h, w,
                _build.DTYPE_CODES[x.dtype])
    launches += 1
    return y


def max_pool_2x2_nchw_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx [B, C, H, W] from the pool's input x and the cotangent g
    [B, C, H/2, W/2] (cast to x's dtype first, as JAX does)."""
    global bwd_launches
    b, c, h, w = x.shape
    if tuple(g.shape) != (b, c, h // 2, w // 2):
        raise ValueError(f"max_pool_2x2_nchw_bwd: g {tuple(g.shape)} does "
                         f"not pool x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return max_pool_2x2_nchw_bwd_plain(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool_2x2_nchw_bwd: no kernel for device "
                         f"{x.device}")
    g = g.to(x.dtype).contiguous()
    _check(x, "max_pool_2x2_nchw_bwd")
    if g.data_ptr() % 16 or g.device != x.device:
        raise ValueError("max_pool_2x2_nchw_bwd: g must be 16-byte aligned "
                         "and on x's device")
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    lib, _, bwd = _fns()
    _build.call(lib, bwd, x.device, "max_pool_2x2_nchw_bwd kernel launch",
                x.data_ptr(), g.data_ptr(), dx.data_ptr(), b * c, h, w,
                _build.DTYPE_CODES[x.dtype])
    bwd_launches += 1
    return dx


def _forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"max_pool_2x2_nchw: no kernel for device "
                         f"{x.device}")
    return torch.ops.uaps.max_pool_2x2_nchw.default(x)


class _MaxPool2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _forward(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return max_pool_2x2_nchw_bwd(x, g)


def max_pool_2x2_nchw(x: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] -> [B, C, H/2, W/2], 2x2 window, stride 2;
    differentiable in x."""
    if x.ndim != 4:
        raise ValueError(f"max_pool_2x2_nchw: x {tuple(x.shape)} is not 4-D")
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool2x2.apply(x)
    return _forward(x)
