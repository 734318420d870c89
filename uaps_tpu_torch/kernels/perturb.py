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
    in f32 in a fixed grouped order (`channel_mean`: groups of FDROP_GROUP
    channels, each summed in channel order, the groups' sums added in
    group order, times f32(1 / C)), and a pixel is kept where attention <
    (its example's largest attention) * scale. The forward keeps the
    attention and the maxima for the backward, which never reads x.
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

# launch counts: a CUDA graph's capture ticks them, its replays do not
# (kernels/__init__.py)
dropout_launches = 0     # dropout kernel launches (reset by the caller)
noise_launches = 0       # feature-noise kernel launches
fdrop_launches = 0       # feature-dropout forwards (attention + apply pass)
fdrop_bwd_launches = 0   # feature-dropout backwards

_M32 = 0xFFFFFFFF
_KEY_SALT = 0x9E3779B9
_FDROP_LO, _FDROP_SPAN = 0.7, 0.2
# channels summed in order before the groups' sums are added in group order
# (csrc/perturb.cu kGroup)
FDROP_GROUP = 8


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
                 rate: float, offset: int = 0) -> torch.Tensor:
    """bool keep mask of `shape`, P(keep) = 1 - rate, per element; the
    elements' flat indices start at `offset` (a rank's rows of a larger
    tensor's mask)."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=seed.device)
    if offset:
        idx = idx + offset
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
    """[B, H, W] f32 mean over axis 1 of NCHW x in the kernels' order, so
    that the thresholds agree bit for bit: s_k = the f32 sum of channels
    FDROP_GROUP * k, ... in order (the last group may be short), then
    ((s_0 + s_1) + s_2) + ..., times f32(1 / C). For C <= FDROP_GROUP this
    is the sum in channel order."""
    c = x.shape[1]
    att = None
    for k0 in range(0, c, FDROP_GROUP):
        s = torch.zeros((x.shape[0], *x.shape[2:]), dtype=torch.float32,
                        device=x.device)
        for k in range(k0, min(k0 + FDROP_GROUP, c)):
            s = s + x[:, k].float()
        att = s if att is None else att + s
    return att * (1.0 / c)


def _fdrop_mask(att: torch.Tensor, mx: torch.Tensor, scale: torch.Tensor
                ) -> torch.Tensor:
    """f32 [B, 1, H, W]: att [B, H, W] < mx [B] * scale, per example."""
    return (att < (mx * scale)[:, None, None]).float()[:, None]


def feature_dropout_mask(x: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """f32 [B, 1, H, W] keep mask: attention < per-example max * scale."""
    with torch.no_grad():
        att = channel_mean(x)
        return _fdrop_mask(att, att.reshape(x.shape[0], -1).amax(1), scale)


def feature_dropout_apply(x: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """x * mask in f32, cast once (mask held constant, as in JAX)."""
    return (x.float() * feature_dropout_mask(x, scale)).to(x.dtype)


# ----------------------------------------------------------- plain versions
def dropout_plain(x: torch.Tensor, seed: torch.Tensor,
                  rate: float, offset: int = 0) -> torch.Tensor:
    """The dropout kernel's plain version (its backward is the same call
    on the cotangent); `offset` as in dropout_keep."""
    return dropout_apply(x, dropout_keep(seed, x.shape, rate, offset), rate)


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


def fdrop_apply_plain(src: torch.Tensor, att: torch.Tensor, mx: torch.Tensor,
                      seed: torch.Tensor) -> torch.Tensor:
    """The apply pass's plain version: src * mask in f32, cast once, the
    mask from the attention [B, H, W], each example's max attention [B]
    (f32) and the seed's scale; src is x (the forward) or g (the
    backward)."""
    with torch.no_grad():
        mask = _fdrop_mask(att, mx, fdrop_scale(seed))
    return (src.float() * mask).to(src.dtype)


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
    fatt = lib.uaps_feature_dropout_att
    fatt.argtypes = [vp, vp, vp, i32, i32, ll, f32, i32, vp]
    fapply = lib.uaps_feature_dropout_apply
    fapply.argtypes = [vp, vp, vp, vp, vp, i32, i32, ll, i32, vp]
    for fn in (drop, noise, fatt, fapply):
        fn.restype = ctypes.c_int
    return lib, drop, noise, fatt, fapply


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
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, the attention [B, H, W] f32, each example's max attention [B]:
    f32 on the plain path, the kernels' order keys as int32 on the card)."""
    global fdrop_launches
    _fdrop_check(x, "feature_dropout")
    if not _kernel_path(x, seed, "feature_dropout"):
        att = channel_mean(x)
        mx = att.reshape(x.shape[0], -1).amax(1)
        return fdrop_apply_plain(x, att, mx, seed), att, mx
    b, c, h, w = x.shape
    att = torch.empty((b, h, w), dtype=torch.float32, device=x.device)
    mx = torch.empty(b, dtype=torch.int32, device=x.device)
    out = torch.empty_like(x)
    lib, _, _, fatt, fapply = _fns()
    code = _build.DTYPE_CODES[x.dtype]
    _build.call(lib, fatt, x.device, "feature_dropout attention kernel "
                "launch", x.data_ptr(), att.data_ptr(), mx.data_ptr(), b, c,
                h * w, 1.0 / c, code)
    _build.call(lib, fapply, x.device, "feature_dropout kernel launch",
                x.data_ptr(), att.data_ptr(), mx.data_ptr(), seed.data_ptr(),
                out.data_ptr(), b, c, h * w, code)
    fdrop_launches += 1
    return out, att, mx


def _fdrop_bwd(g: torch.Tensor, seed: torch.Tensor, att: torch.Tensor,
               mx: torch.Tensor) -> torch.Tensor:
    """g * mask, in g's dtype: the mask from the forward's attention and
    maxima (`_fdrop_fwd`'s) and the seed's scale."""
    global fdrop_bwd_launches
    _fdrop_check(g, "feature_dropout_bwd")
    b, c, h, w = g.shape
    if tuple(att.shape) != (b, h, w) or tuple(mx.shape) != (b,):
        raise ValueError(f"feature_dropout_bwd: g {tuple(g.shape)}, att "
                         f"{tuple(att.shape)}, mx {tuple(mx.shape)}")
    if not _kernel_path(g, seed, "feature_dropout_bwd"):
        return fdrop_apply_plain(g, att, mx, seed)
    if (att.dtype != torch.float32 or mx.dtype != torch.int32
            or att.device != g.device or mx.device != g.device
            or not att.is_contiguous()):
        raise ValueError("feature_dropout_bwd: att and mx must be the "
                         "kernel forward's (contiguous f32 and int32 on "
                         f"{g.device}); got {att.dtype} on {att.device}, "
                         f"{mx.dtype} on {mx.device}")
    dx = torch.empty_like(g)
    lib, _, _, _, fapply = _fns()
    _build.call(lib, fapply, g.device, "feature_dropout_bwd kernel launch",
                g.data_ptr(), att.data_ptr(), mx.data_ptr(), seed.data_ptr(),
                dx.data_ptr(), b, c, h * w, _build.DTYPE_CODES[g.dtype])
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
        out, att, mx = _fdrop_fwd(x, seed)
        ctx.save_for_backward(att, mx, seed)
        ctx.dtype = x.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        att, mx, seed = ctx.saved_tensors
        return _fdrop_bwd(g.to(ctx.dtype).contiguous(), seed, att, mx), None


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
    g * mask, the mask from the forward's attention and maxima."""
    return _FeatureDropout.apply(x, seed)
