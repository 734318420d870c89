"""The fused ConvBlock chain: 3x3 convs that emit their BN moments and carry
the previous BN-normalise + LeakyReLU + dropout in their input prologue,
differentiable.

Counterpart of `uaps_tpu/pallas/block_conv.py` (`conv_backend="chain"`):
`chain_conv_plain(x, w) -> (y, s1, s2)` (kernel A: the conv and the raw
moments of its output) and `chain_conv_bnl(x, f, s, w, seed, rate) -> (y,
s1, s2)` (kernel B: the conv of dropout(leaky(x * f + s)), with f, s the
previous BN's per-channel factor and shift), with the custom VJPs of
block_conv.py:433-446 and :481-495. The CUDA kernels are in
`csrc/block_conv.cu` (shared with `kernels/conv_bnl.py`); its note says what
bounds them and how many launches a call takes.

Contract (as in JAX): x [B, Cin, H, W] f32 or bf16 (f64 on the plain path),
w [3, 3, Cin, Cout] HWIO cast to x's dtype, f and s [Cin] f32, the seed a
0-d integer tensor on x's device whose low 32 bits are JAX's int32 seed (the
port's `draw_seeds` values), `rate` a Python float. y [B, Cout, H, W] in x's
dtype, no bias; s1, s2 [Cout] f32, the sums of y and y^2 over (B, H, W): the
kernels take them from the f32 accumulator, the plain versions from y cast
to f32 (block_conv.py `_moments`, f32 even for f64 activations). The
prologue computes a = x * f + s in f32, z = leaky(a) (slope 0.01), drops an
element where the position hash says so (below), scales the kept ones by
f32(1 / (1 - rate)) and casts z to x's dtype; the halo outside the image is
zero of z.

The dropout mask (block_conv.py `_hash_u32`, `hash_keep_ref`): the position
pos = ((b * C + c) * H + h) * W + w of the element in x, with int32
wrapping, hashed with the seed (pos * 0x9E3779B9 ^ seed, then the murmur3
avalanche on uint32); the element is kept where the hash is <=
int((1 - rate) * (2^32 - 1)). The same bits on both sides, so the CPU tests
hold the masks to JAX's exactly; the backward regenerates the mask from the
seed and stores nothing, and the kernels read the seed through a pointer
(no host sync).

The backward: the moment cotangents are folded first, ge = g + ds1 + 2 y ds2
in f32 (at least), cast to y's dtype, a missing cotangent counting as zero
(block_conv.py `_fold`); dz = the conv of ge with w flipped in (kh, kw) and
its channels swapped, in f32; without the prologue dx = dz, with it da =
dz * keep * scale * leaky'(a), dx = da * f, df = sum(da * x), ds = sum(da)
(all f32); dW = the weight gradient of z (recomputed) against ge, f32, cast
to w's dtype.

Dispatch: a CPU tensor goes to the plain versions (`chain_plain_ref`,
`chain_bnl_ref`, `chain_bwd_plain`); a CUDA tensor launches the kernels or
raises. Launch counts, one per wrapper call: `plain_launches`,
`bnl_launches` (forwards), `plain_bwd_launches`, `bnl_bwd_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from uaps_tpu_torch.kernels import _build
from uaps_tpu_torch.kernels.conv3x3_nchw import (_acc_dtype,
                                                 conv3x3_nchw_plain,
                                                 conv3x3_nchw_wgrad_plain,
                                                 kernel_path, wgrad_strips)
from uaps_tpu_torch.kernels.perturb import _M32, _mul32

# launch counts: a CUDA graph's capture ticks them, its replays do not
# (kernels/__init__.py)
plain_launches = 0       # chain_conv_plain forwards (reset by the caller)
bnl_launches = 0         # chain_conv_bnl forwards
plain_bwd_launches = 0   # chain_conv_plain backwards
bnl_bwd_launches = 0     # chain_conv_bnl backwards

NEG_SLOPE = 0.01
_H1, _H2, _H3 = 0x9E3779B9, 0x85EBCA77, 0xC2B2AE3D
# the CUDA-core forward and dgrad tile (kTH, kTW in csrc/conv3x3_tile.cuh)
# and the tensor-core forward's (dg::kTH, dg::kTW in csrc/conv3x3_mma.cuh):
# one row of per-channel partials each
TILE_H, TILE_W = 8, 64
MMA_TILE_H, MMA_TILE_W = 8, 32


def fwd_tiles(dtype, b: int, h: int, wd: int) -> int:
    """Blocks of the forward kernel, one [2, Cout] moment partial each, and
    of the dgrad with the prologue, one [2, Cin] df/ds partial each (the
    scratch rows each fixed-order reduce adds): the tensor-core tile's grid
    for bf16, the CUDA-core tile's for f32 (csrc/block_conv.cu `fwd`,
    `bwd`)."""
    th, tw = ((MMA_TILE_H, MMA_TILE_W) if dtype == torch.bfloat16
              else (TILE_H, TILE_W))
    return b * -(-h // th) * -(-wd // tw)


# -------------------------------------------------------------- the mask
def hash_u32(pos: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """block_conv.py `_hash_u32` as int64 in [0, 2^32): pos (int64, taken
    mod 2^32) and the seed's low 32 bits."""
    h = _mul32(pos & _M32, _H1) ^ (seed.to(torch.int64) & _M32)
    h = h ^ (h >> 15)
    h = _mul32(h, _H2)
    h = h ^ (h >> 13)
    h = _mul32(h, _H3)
    return h ^ (h >> 16)


def keep_threshold(rate: float) -> int:
    """uint32 threshold: keep where hash <= it (JAX forms it in float64)."""
    return int((1.0 - rate) * (2 ** 32 - 1))


def hash_keep(seed: torch.Tensor, shape: Sequence[int],
              rate: float) -> torch.Tensor:
    """bool keep mask over a whole [B, C, H, W] tensor (`hash_keep_ref`)."""
    n = 1
    for d in shape:
        n *= d
    pos = torch.arange(n, dtype=torch.int64, device=seed.device)
    return (hash_u32(pos, seed) <= keep_threshold(rate)).reshape(shape)


# ----------------------------------------------------------- plain versions
def _ch(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def moments(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares) of y cast to f32, over (B, H, W)."""
    yf = y.to(torch.float32)
    return yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))


def prologue_plain(x: torch.Tensor, f: torch.Tensor, s: torch.Tensor,
                   seed: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """z = dropout(leaky(x * f + s)) in f32, cast to x's dtype."""
    a = x.to(torch.float32) * _ch(f) + _ch(s)
    z = torch.where(a >= 0, a, a * NEG_SLOPE)
    if rate > 0:
        keep = hash_keep(seed, x.shape, rate)
        z = torch.where(keep, z * (1.0 / (1.0 - rate)), z.new_zeros(()))
    return z.to(x.dtype)


def chain_plain_ref(x: torch.Tensor, w: torch.Tensor):
    """JAX `chain_ref_plain`, differentiable through torch: (y, s1, s2)."""
    y = conv3x3_nchw_plain(x, w.to(x.dtype))
    return (y, *moments(y))


def chain_bnl_ref(x: torch.Tensor, f: torch.Tensor, s: torch.Tensor,
                  w: torch.Tensor, seed: Optional[torch.Tensor] = None,
                  rate: float = 0.0):
    """JAX `chain_ref_bnl`, differentiable through torch: (y, s1, s2)."""
    z = prologue_plain(x, f, s, seed, rate)
    y = conv3x3_nchw_plain(z, w.to(x.dtype))
    return (y, *moments(y))


def fold_plain(g: torch.Tensor, y: torch.Tensor,
               ds1: Optional[torch.Tensor],
               ds2: Optional[torch.Tensor]) -> torch.Tensor:
    """ge = g + ds1 + (2 y) ds2 in (at least) f32, cast to y's dtype; a
    missing cotangent counts as zero and adds nothing."""
    if ds1 is None and ds2 is None:
        return g.to(y.dtype)
    ct = _acc_dtype(y)
    v = g.to(ct)
    if ds1 is not None:
        v = v + _ch(ds1.to(ct))
    if ds2 is not None:
        v = v + (2.0 * y.to(ct)) * _ch(ds2.to(ct))
    return v.to(y.dtype)


def chain_bwd_plain(ge: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    f: Optional[torch.Tensor], s: Optional[torch.Tensor],
                    seed: Optional[torch.Tensor], rate: float,
                    need_dx: bool = True):
    """The kernels' backward from the folded cotangent ge [B, Cout, H, W]:
    (dx or None, dW [3, 3, Cin, Cout] in the accumulation dtype, df, ds),
    df and ds None without the prologue (f None)."""
    ct = _acc_dtype(ge)
    w_rot = w.to(ge.dtype).flip((0, 1)).transpose(2, 3)
    dz = conv3x3_nchw_plain(ge, w_rot, ct) if need_dx or f is not None \
        else None
    df = ds = None
    if f is None:
        dx = dz.to(x.dtype) if need_dx else None
        z = x
    else:
        xf = x.to(torch.float32)
        a = xf * _ch(f) + _ch(s)
        dl = dz.to(torch.float32)
        if rate > 0:
            keep = hash_keep(seed, x.shape, rate)
            dl = torch.where(keep, dl * (1.0 / (1.0 - rate)),
                             dl.new_zeros(()))
        da = dl * torch.where(a >= 0, 1.0, NEG_SLOPE)
        dx = (da * _ch(f)).to(x.dtype)
        df = (da * xf).sum((0, 2, 3))
        ds = da.sum((0, 2, 3))
        z = prologue_plain(x, f, s, seed, rate)
    return dx, conv3x3_nchw_wgrad_plain(z, ge), df, ds


# ------------------------------------------------------------------ kernels
@functools.cache
def _fns():
    lib = _build.load("block_conv")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fwd = lib.uaps_block_conv_fwd
    fwd.argtypes = ([vp] * 8 + [i32] * 7
                    + [ctypes.c_uint, ctypes.c_float, i32, i32, vp])
    bwd = lib.uaps_block_conv_bwd
    bwd.argtypes = ([vp] * 14 + [i32] * 6
                    + [ctypes.c_uint, ctypes.c_float, i32, i32, i32, vp])
    for fn in (fwd, bwd):
        fn.restype = ctypes.c_int
    return lib, fwd, bwd


def w9(w: torch.Tensor, dtype) -> torch.Tensor:
    """HWIO [3, 3, Cin, Cout] -> the kernels' contiguous [9, Cin, Cout]."""
    cin, cout = w.shape[2:]
    return w.to(dtype).reshape(9, cin, cout).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _vec(v: Optional[torch.Tensor], n: int, dev, what: str):
    """A per-channel vector as the kernels take it: contiguous f32 [n]."""
    if v is None:
        return None
    if v.shape != (n,) or v.device != dev:
        raise ValueError(f"{what}: per-channel vector {tuple(v.shape)} on "
                         f"{v.device}; want [{n}] on {dev}")
    return v.to(torch.float32).contiguous()


def _check_seed(seed, x, rate, what):
    if rate <= 0:
        return None
    if (seed is None or seed.ndim != 0 or seed.device != x.device
            or seed.dtype != torch.int64):
        raise ValueError(f"{what}: dropout needs a 0-d int64 seed on "
                         f"{x.device}; got {seed!r}")
    return seed


def kernel_fwd(x: torch.Tensor, wk: torch.Tensor, f, s, seed, rate: float,
               moments_on: bool, what: str):
    """Launch the forward: y (and the [2, Cout] f32 moments, or None). x
    [B, Cin, H, W] contiguous CUDA, wk the [9, Cin, Cout] weight (`w9`) in
    x's dtype; f, s None for no prologue. Counts nothing."""
    if x.dtype not in _build.DTYPE_CODES or wk.dtype != x.dtype:
        raise TypeError(f"{what}: x {x.dtype} and w {wk.dtype} must both be "
                        "float32 or both bfloat16")
    if not (x.is_contiguous() and wk.is_contiguous()) \
            or wk.device != x.device:
        raise ValueError(f"{what}: x and w must be contiguous, on one device")
    b, cin, h, wd = x.shape
    cout = wk.shape[2]
    f = _vec(f, cin, x.device, what)
    s = _vec(s, cin, x.device, what)
    seed = _check_seed(seed, x, rate, what)
    y = torch.empty((b, cout, h, wd), dtype=x.dtype, device=x.device)
    part = mom = None
    if moments_on:
        part = torch.empty(fwd_tiles(x.dtype, b, h, wd) * 2 * cout,
                           dtype=torch.float32,
                           device=x.device)
        mom = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    lib, fwd, _ = _fns()
    _build.call(lib, fwd, x.device, f"{what} kernel launch", x.data_ptr(),
                wk.data_ptr(), _ptr(f), _ptr(s), _ptr(seed), y.data_ptr(),
                _ptr(part), _ptr(mom), b, cin, cout, h, wd, int(f is not None),
                int(moments_on), keep_threshold(rate), 1.0 / (1.0 - rate),
                int(rate > 0), _build.DTYPE_CODES[x.dtype])
    return y, mom


def kernel_bwd(g: torch.Tensor, y, ds1, ds2, x: torch.Tensor,
               wk: torch.Tensor, f, s, seed, rate: float, need_dx: bool,
               what: str):
    """Launch the backward: (dx or None, dW [3, 3, Cin, Cout] f32, df, ds);
    g, y and x contiguous in x's dtype (y only read with ds2). Counts
    nothing."""
    b, cin, h, wd = x.shape
    cout = wk.shape[2]
    if g.shape != (b, cout, h, wd) or g.dtype != x.dtype \
            or not g.is_contiguous():
        raise ValueError(f"{what}: cotangent {tuple(g.shape)} {g.dtype}; "
                         f"want contiguous {(b, cout, h, wd)} {x.dtype}")
    pro = f is not None
    f = _vec(f, cin, x.device, what)
    s = _vec(s, cin, x.device, what)
    ds1 = _vec(ds1, cout, x.device, what)
    ds2 = _vec(ds2, cout, x.device, what)
    seed = _check_seed(seed, x, rate, what)
    dx = torch.empty_like(x) if need_dx or pro else None
    part_d = dfds = None
    if pro:
        part_d = torch.empty(fwd_tiles(x.dtype, b, h, wd) * 2 * cin,
                             dtype=torch.float32,
                             device=x.device)
        dfds = torch.empty((2, cin), dtype=torch.float32, device=x.device)
    rows, n_part = wgrad_strips(x.dtype, b, cin, cout, h, wd)
    part_w = torch.empty(n_part, dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    lib, _, bwd = _fns()
    _build.call(lib, bwd, x.device, f"{what} backward kernel launch",
                g.data_ptr(), _ptr(y if ds2 is not None else None),
                _ptr(ds1), _ptr(ds2), x.data_ptr(), wk.data_ptr(), _ptr(f),
                _ptr(s), _ptr(seed), _ptr(dx), _ptr(part_d), _ptr(dfds),
                part_w.data_ptr(), dw.data_ptr(), b, cin, cout, h, wd,
                int(pro), keep_threshold(rate), 1.0 / (1.0 - rate),
                int(rate > 0), rows, _build.DTYPE_CODES[x.dtype])
    if pro:
        return dx, dw, dfds[0], dfds[1]
    return dx, dw, None, None


def _forward(x, f, s, w, seed, rate):
    """(y, s1, s2) of the plain chain conv (f None) or the bnl one."""
    global plain_launches, bnl_launches
    pro = f is not None
    what = "chain_conv_bnl" if pro else "chain_conv_plain"
    if not kernel_path(x, what):
        with torch.no_grad():
            if pro:
                return chain_bnl_ref(x, f, s, w, seed, rate)
            return chain_plain_ref(x, w)
    y, mom = kernel_fwd(x.contiguous(), w9(w, x.dtype), f, s, seed, rate,
                        True, what)
    if pro:
        bnl_launches += 1
    else:
        plain_launches += 1
    return y, mom[0], mom[1]


def _backward(g, ds1, ds2, y, x, f, s, w, seed, rate, need_dx):
    """(dx, dW in w's dtype, df, ds) from the three cotangents."""
    global plain_bwd_launches, bnl_bwd_launches
    pro = f is not None
    what = "chain_conv_bnl" if pro else "chain_conv_plain"
    if g is None:
        g = torch.zeros_like(y)
    if not kernel_path(x, what):
        dx, dw, df, ds = chain_bwd_plain(fold_plain(g, y, ds1, ds2), x, w,
                                         f, s, seed, rate, need_dx)
    else:
        dx, dw, df, ds = kernel_bwd(g.to(x.dtype).contiguous(), y, ds1, ds2,
                                    x, w9(w, x.dtype), f, s, seed, rate,
                                    need_dx, what)
        if pro:
            bnl_bwd_launches += 1
        else:
            plain_bwd_launches += 1
    if pro:
        df, ds = df.to(f.dtype), ds.to(s.dtype)
    return dx, dw.to(w.dtype), df, ds


class _ChainConv(torch.autograd.Function):
    """The chain conv with the JAX VJP (fold, then dgrad + wgrad) as its
    backward; f, s None for the plain chain conv."""

    @staticmethod
    def forward(ctx, x, f, s, w, seed, rate):
        ctx.set_materialize_grads(False)
        y, s1, s2 = _forward(x, f, s, w, seed, rate)
        ctx.save_for_backward(x, f, s, w, seed, y)
        ctx.rate = rate
        return y, s1, s2

    @staticmethod
    def backward(ctx, g, ds1, ds2):
        x, f, s, w, seed, y = ctx.saved_tensors
        dx, dw, df, ds = _backward(g, ds1, ds2, y, x, f, s, w, seed,
                                   ctx.rate, ctx.needs_input_grad[0])
        return dx, df, ds, dw, None, None


def _chain(x, f, s, w, seed, rate, what):
    if x.ndim != 4 or w.ndim != 4 or w.shape[:3] != (3, 3, x.shape[1]):
        raise ValueError(f"{what}: x {tuple(x.shape)}, w {tuple(w.shape)}; "
                         "want [B,Cin,H,W], [3,3,Cin,Cout]")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{what}: dropout rate {rate} not in [0, 1)")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, f, s, w)):
        return _ChainConv.apply(x, f, s, w, seed, rate)
    return _forward(x, f, s, w, seed, rate)


def chain_conv_plain(x: torch.Tensor, w: torch.Tensor):
    """x [B, Cin, H, W], w [3, 3, Cin, Cout] -> (y [B, Cout, H, W] raw conv,
    no bias; s1, s2 [Cout] f32 moments of y over B, H, W)."""
    return _chain(x, None, None, w, None, 0.0, "chain_conv_plain")


def chain_conv_bnl(x: torch.Tensor, f: torch.Tensor, s: torch.Tensor,
                   w: torch.Tensor, seed: Optional[torch.Tensor] = None,
                   rate: float = 0.0):
    """x [B, C, H, W] the raw previous conv output, f, s [C] f32 the
    previous BN's factor and shift -> (y, s1, s2) of
    conv3x3(dropout(leaky(x * f + s)), w) and its raw moments."""
    return _chain(x, f, s, w, seed if rate > 0 else None, rate,
                  "chain_conv_bnl")
