"""Perturbation kernels with a counter-based generator, differentiable:
dropout, feature noise and feature dropout.

Counterpart of `uaps_tpu/pallas/perturb.py`: `fused_dropout` (bodies
`_dropout_kernel` / `_dropout_kernel_lanes`, called through `_elemwise_call`
and `_batched_call`), `fused_feature_noise` (`_noise_kernel(_lanes)`) and
`fused_feature_dropout` (`_fdrop_kernel`, backward `_fdrop_bwd`). The CUDA
kernels are in `csrc/perturb.cu`; its note says what bounds them.

The generator. The random value at an element is a pure function of the
call's seed and the element's index, so a backward regenerates its forward's
draw and nothing is stored:

    mix32(x)        = lowbias32: x ^= x >> 16; x *= 0x7FEB352D;
                      x ^= x >> 15; x *= 0x846CA68B; x ^= x >> 16  (mod 2^32)
    bits(seed, i)   = mix32(mix32(i ^ key) + s),  s = seed mod 2^32,
                      key = mix32(s ^ 0x9E3779B9)
    uniform24(bits) = (bits >> 8) * 2^-24, in [0, 1), exact in f32

  * dropout: i is the flat element index (masks differ per example); an
    element is kept when bits < round((1 - rate) * 2^32), and a kept value
    is x * f32(1 / (1 - rate)) in f32, cast once;
  * feature noise: i is the index within one example (the noise is shared
    across the batch); u = uniform24 * f32(2 r) - f32(r) in [-r, r), and
    the output is x * (1 + u) in f32, cast once;
  * feature dropout: one draw per call at i = 0 gives the scale
    uniform24 * 0.2 + 0.7 in [0.7, 0.9]; the attention is the channel mean
    in f32 (channels summed in order 0..C-1, times f32(1 / C)), and a pixel
    is kept where attention < (its example's largest attention) * scale.
The plain versions compute the same bits with torch int64 ops, so on the
card a kernel equals its plain version bit for bit. The bit-stream is not
JAX's (the TPU's in-core generator has no CPU counterpart); the CPU tests
feed JAX's own draws to the `*_apply` functions.

Seeds are 0-d int64 tensors on the data's device (a slice of one
`torch.randint` draw per forward): the kernels read them through a pointer,
so no call waits for the host.

Dispatch: a CPU tensor goes to the plain versions; a CUDA tensor launches
the kernels or raises. Launch counts: `dropout_launches` (forward and
backward), `noise_launches` (forward and backward), `fdrop_launches`,
`fdrop_bwd_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from uaps_tpu_torch.kernels import _build

dropout_launches = 0     # dropout kernel launches (reset by the caller)
noise_launches = 0       # feature-noise kernel launches
fdrop_launches = 0       # feature-dropout forwards (max pass + apply pass)
fdrop_bwd_launches = 0   # feature-dropout backwards

_M32 = 0xFFFFFFFF
_KEY_SALT = 0x9E3779B9
_FDROP_LO, _FDROP_SPAN = 0.7, 0.2


# ----------------------------------------------------------------- generator
def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """x * k mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    return (x * (k & 0xFFFF) + (((x * (k >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def random_bits(seed: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """bits(seed, i) as int64 in [0, 2^32) (the kernels' generator)."""
    s = seed.to(torch.int64) & _M32
    key = _mix32(s ^ _KEY_SALT)
    return _mix32((_mix32(index ^ key) + s) & _M32)


def uniform24(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def _keep_threshold(rate: float) -> int:
    return min(round((1.0 - rate) * 2 ** 32), 2 ** 32)


# ------------------------------------------------------------------- draws
def dropout_keep(seed: torch.Tensor, shape: Sequence[int],
                 rate: float) -> torch.Tensor:
    """bool keep mask of `shape`, P(keep) = 1 - rate, per element."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=seed.device)
    return (random_bits(seed, idx) < _keep_threshold(rate)).reshape(shape)


def noise_draw(seed: torch.Tensor, shape: Sequence[int],
               uniform_range: float = 0.3) -> torch.Tensor:
    """f32 noise in [-r, r) of `shape` (one example's shape)."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=seed.device)
    u = uniform24(random_bits(seed, idx)) * (2 * uniform_range)
    return (u - uniform_range).reshape(shape)


def fdrop_scale(seed: torch.Tensor) -> torch.Tensor:
    """The feature-dropout scale, a 0-d f32 tensor in [0.7, 0.9]."""
    bits = random_bits(seed, torch.zeros((), dtype=torch.int64,
                                         device=seed.device))
    return uniform24(bits) * _FDROP_SPAN + _FDROP_LO


# ----------------------------------------------------------------- applies
def dropout_apply(x: torch.Tensor, keep: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """where(keep, x / (1 - rate), 0): x * f32(1 / (1 - rate)) in f32, cast
    once (for rate 0.5 exactly JAX's x / 0.5)."""
    kept = (x.float() * (1.0 / (1.0 - rate))).to(x.dtype)
    return torch.where(keep, kept, x.new_zeros(()))


def feature_noise_apply(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x * (1 + noise) in f32, cast once; noise [C, H, W] is shared across
    the batch."""
    return (x.float() * (1.0 + noise.float())[None]).to(x.dtype)


def channel_mean(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] f32 mean over axis 1 of NCHW x, summed in channel order
    (the kernels' order, so the thresholds agree bit for bit)."""
    s = torch.zeros((x.shape[0], *x.shape[2:]), dtype=torch.float32,
                    device=x.device)
    for k in range(x.shape[1]):
        s = s + x[:, k].float()
    return s * (1.0 / x.shape[1])


def feature_dropout_mask(x: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """f32 [B, 1, H, W] keep mask: attention < per-example max * scale."""
    with torch.no_grad():
        att = channel_mean(x)
        thr = att.reshape(x.shape[0], -1).amax(1) * scale
        return (att < thr[:, None, None]).float()[:, None]


def feature_dropout_apply(x: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """x * mask in f32, cast once (mask held constant, as in JAX)."""
    return (x.float() * feature_dropout_mask(x, scale)).to(x.dtype)


# ----------------------------------------------------------- plain versions
def dropout_plain(x: torch.Tensor, seed: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """The dropout kernel's plain version (its backward is the same call
    on the cotangent)."""
    return dropout_apply(x, dropout_keep(seed, x.shape, rate), rate)


def feature_noise_plain(x: torch.Tensor, seed: torch.Tensor,
                        uniform_range: float) -> torch.Tensor:
    """The feature-noise kernel's plain version (and its backward on g)."""
    return feature_noise_apply(x, noise_draw(seed, x.shape[1:],
                                             uniform_range))


def feature_dropout_plain(x: torch.Tensor,
                          seed: torch.Tensor) -> torch.Tensor:
    """The feature-dropout forward's plain version."""
    return feature_dropout_apply(x, fdrop_scale(seed))


def feature_dropout_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                              seed: torch.Tensor) -> torch.Tensor:
    """g * mask(x), the mask regenerated from x and the seed."""
    mask = feature_dropout_mask(x, fdrop_scale(seed))
    return (g.float() * mask).to(g.dtype)


# ------------------------------------------------------------------ kernels
@functools.cache
def _fns():
    lib = _build.load("perturb")
    vp, ll, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    drop = lib.uaps_dropout
    drop.argtypes = [vp, vp, vp, ll, ctypes.c_ulonglong, f32, i32, vp]
    noise = lib.uaps_feature_noise
    noise.argtypes = [vp, vp, vp, i32, ll, f32, f32, i32, vp]
    fmax = lib.uaps_feature_dropout_max
    fmax.argtypes = [vp, vp, i32, i32, ll, f32, i32, vp]
    fapply = lib.uaps_feature_dropout_apply
    fapply.argtypes = [vp, vp, vp, vp, vp, i32, i32, ll, f32, i32, vp]
    for fn in (drop, noise, fmax, fapply):
        fn.restype = ctypes.c_int
    return lib, drop, noise, fmax, fapply


def _kernel_path(x: torch.Tensor, seed: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU);
    raises for another device or a malformed call."""
    if seed.dtype != torch.int64 or seed.ndim != 0:
        raise TypeError(f"{what}: seed must be a 0-d int64 tensor; got "
                        f"{seed.dtype} {tuple(seed.shape)}")
    if seed.device != x.device:
        raise ValueError(f"{what}: seed on {seed.device}, x on {x.device}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if not x.is_contiguous() or x.numel() >= 2 ** 32:
        raise ValueError(f"{what}: needs a contiguous tensor of fewer than "
                         f"2^32 elements; got {tuple(x.shape)}")
    return True


def _dropout(x: torch.Tensor, seed: torch.Tensor, rate: float
             ) -> torch.Tensor:
    global dropout_launches
    if not _kernel_path(x, seed, "fused_dropout"):
        return dropout_plain(x, seed, rate)
    out = torch.empty_like(x)
    lib, drop, _, _, _ = _fns()
    _build.call(lib, drop, x.device, "fused_dropout kernel launch",
                x.data_ptr(), out.data_ptr(), seed.data_ptr(), x.numel(),
                _keep_threshold(rate), 1.0 / (1.0 - rate),
                _build.DTYPE_CODES[x.dtype])
    dropout_launches += 1
    return out


def _noise(x: torch.Tensor, seed: torch.Tensor, uniform_range: float
           ) -> torch.Tensor:
    global noise_launches
    if x.ndim < 2:
        raise ValueError(f"feature_noise: x {tuple(x.shape)} has no batch "
                         "axis")
    if not _kernel_path(x, seed, "feature_noise"):
        return feature_noise_plain(x, seed, uniform_range)
    out = torch.empty_like(x)
    lib, _, noise, _, _ = _fns()
    _build.call(lib, noise, x.device, "feature_noise kernel launch",
                x.data_ptr(), out.data_ptr(), seed.data_ptr(), x.shape[0],
                x[0].numel(), 2 * uniform_range, uniform_range,
                _build.DTYPE_CODES[x.dtype])
    noise_launches += 1
    return out


def _fdrop_check(x: torch.Tensor, what: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"{what}: x {tuple(x.shape)} is not NCHW")


def _fdrop_fwd(x: torch.Tensor, seed: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, the per-example max as the kernels encode it, or None on the
    plain path)."""
    global fdrop_launches
    _fdrop_check(x, "feature_dropout")
    if not _kernel_path(x, seed, "feature_dropout"):
        return feature_dropout_plain(x, seed), None
    b, c, h, w = x.shape
    mx = torch.empty(b, dtype=torch.int32, device=x.device)
    out = torch.empty_like(x)
    lib, _, _, fmax, fapply = _fns()
    code = _build.DTYPE_CODES[x.dtype]
    _build.call(lib, fmax, x.device, "feature_dropout max kernel launch",
                x.data_ptr(), mx.data_ptr(), b, c, h * w, 1.0 / c, code)
    _build.call(lib, fapply, x.device, "feature_dropout kernel launch",
                x.data_ptr(), x.data_ptr(), out.data_ptr(), mx.data_ptr(),
                seed.data_ptr(), b, c, h * w, 1.0 / c, code)
    fdrop_launches += 1
    return out, mx


def _fdrop_bwd(x: torch.Tensor, g: torch.Tensor, seed: torch.Tensor,
               mx) -> torch.Tensor:
    """g * mask(x), in g's dtype: the mask from x, the forward's maxima and
    the seed's scale."""
    global fdrop_bwd_launches
    _fdrop_check(x, "feature_dropout_bwd")
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"feature_dropout_bwd: g {tuple(g.shape)}, x "
                         f"{tuple(x.shape)}")
    if not _kernel_path(x, seed, "feature_dropout_bwd"):
        return feature_dropout_bwd_plain(x, g, seed)
    g = g.to(x.dtype).contiguous()
    b, c, h, w = x.shape
    dx = torch.empty_like(x)
    lib, _, _, _, fapply = _fns()
    _build.call(lib, fapply, x.device, "feature_dropout_bwd kernel launch",
                g.data_ptr(), x.data_ptr(), dx.data_ptr(), mx.data_ptr(),
                seed.data_ptr(), b, c, h * w, 1.0 / c,
                _build.DTYPE_CODES[x.dtype])
    fdrop_bwd_launches += 1
    return dx


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.save_for_backward(seed)
        ctx.rate = rate
        return _dropout(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        seed, = ctx.saved_tensors
        return _dropout(g.contiguous(), seed, ctx.rate), None, None


class _Noise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, uniform_range):
        ctx.save_for_backward(seed)
        ctx.uniform_range = uniform_range
        return _noise(x, seed, uniform_range)

    @staticmethod
    def backward(ctx, g):
        seed, = ctx.saved_tensors
        return _noise(g.contiguous(), seed, ctx.uniform_range), None, None


class _FeatureDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed):
        out, mx = _fdrop_fwd(x, seed)
        ctx.save_for_backward(x, seed, mx)
        return out

    @staticmethod
    def backward(ctx, g):
        x, seed, mx = ctx.saved_tensors
        return _fdrop_bwd(x, g, seed, mx), None


def fused_dropout(x: torch.Tensor, seed: torch.Tensor,
                  rate: float = 0.5) -> torch.Tensor:
    """Inverted dropout of any shape; the backward regenerates the mask."""
    return _Dropout.apply(x, seed, rate)


def fused_feature_noise(x: torch.Tensor, seed: torch.Tensor,
                        uniform_range: float = 0.3) -> torch.Tensor:
    """x * (1 + U(-r, r)), the noise shared across the batch axis."""
    return _Noise.apply(x, seed, uniform_range)


def fused_feature_dropout(x: torch.Tensor,
                          seed: torch.Tensor) -> torch.Tensor:
    """Attention-thresholded spatial dropout of NCHW x; the backward is
    g * mask with the mask recomputed."""
    return _FeatureDropout.apply(x, seed)
