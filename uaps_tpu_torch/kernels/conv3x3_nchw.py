"""3x3 SAME stride-1 convolution over NCHW activations, differentiable.

Counterpart of `uaps_tpu/pallas/conv3x3_nchw.py`: `conv3x3_nchw` (default
body `_fwd_kernel_dwkf`), the entries `conv3x3_fast_nchw` and
`conv3x3_fast_flat` with their custom VJPs, `conv3x3_nchw_wgrad`, the
`fullh` variant (`conv3x3_nchw_fullh`, `conv3x3_nchw_wgrad_fullh`) and the
conv with its output's moments (`conv3x3_nchw_stats`,
`conv3x3_fast_nchw_stats`). Two CUDA sources: `csrc/conv3x3_nchw.cu`
(forward, and dgrad with flipped weights) and `csrc/conv3x3_wgrad_nchw.cu`
(weight gradient); their notes say what bounds each kernel and how the
design answers that. Both route by dtype inside the C entry points: bf16
runs on the tensor cores (`csrc/conv3x3_mma.cuh`), f32 on the CUDA cores.
The stats entries run the moments kernels of `csrc/block_conv.cu`
(through `kernels/block_conv.py`).

Variants: `variant` takes JAX's names (`VARIANTS`) and raises on another.
On the TPU they are Mosaic layouts of one function; here every name but
"fullh" runs the kernels above. "fullh" (one block per image on the TPU)
runs the same kernels through its own entries and counters, and keeps
JAX's contract: its output is x's dtype, cast to `out_dtype` after (a bf16
fullh conv with out_dtype=f32 returns bf16-rounded values); its VJP takes
the fullh dgrad and wgrad.

Stats (JAX `conv3x3_nchw_stats` and its VJP): y in x's dtype without a
bias, and s1, s2 the f32 sums of y and y^2 over (B, H, W), from the f32
accumulator on the kernel path and from y cast to f32 on the plain path.
The backward folds the moment cotangents first, dy_eff = dy + ds1 + 2 y
ds2 in f32 cast to x's dtype (block_conv.py `fold_plain`; the kernel folds
them in its dgrad and wgrad loaders), then runs the dgrad and the wgrad.

Contract (as in JAX): x [B, Cin, H, W], or the flat view [B, Cin, H*W] with
`hw=(H, W)` (the same memory in torch); w [3, 3, Cin, Cout] in HWIO order
(any strides, in x's dtype on the kernel path); zero halo; f32 or bf16
input, f32 accumulation, output `out_dtype or x.dtype`. The caller adds the
bias. The backward is the JAX VJP (`_vjp_bwd_flat`, `_vjp_bwd_nchw`): the
cotangent is first cast to x's dtype (the head's f32 cotangent goes in as
bf16); dx is the forward conv of it with w flipped in (kh, kw) and its
in/out channels swapped, in x's dtype, and only where x needs a gradient;
dW is the f32 weight gradient cast to w's dtype.

Dispatch: a CPU tensor goes to the plain versions (`conv3x3_nchw_plain`,
`conv3x3_nchw_dgrad_plain`, `conv3x3_nchw_wgrad_plain`; the stats entries
block_conv.py's `chain_plain_ref` and `chain_bwd_plain`); a CUDA tensor
launches the kernels or raises, never falls back. Launch counts:
`launches` (forward), `dgrad_launches`, `wgrad_launches`; for fullh
`fullh_launches`, `fullh_dgrad_launches`, `fullh_wgrad_launches`; for
stats `stats_launches`, `stats_bwd_launches` (one per call).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from uaps_tpu_torch.kernels import _build

# launch counts: a CUDA graph's capture ticks them, its replays do not
# (kernels/__init__.py)
launches = 0         # forward kernel launches (reset by the caller)
dgrad_launches = 0   # forward kernel launches made as dgrad
wgrad_launches = 0   # weight-gradient kernel launches
fullh_launches = 0         # the same three, made through the fullh entries
fullh_dgrad_launches = 0
fullh_wgrad_launches = 0
stats_launches = 0         # conv3x3_nchw_stats forwards
stats_bwd_launches = 0     # ... and backwards

# JAX's variant names (conv3x3_nchw.py VARIANTS); another name raises
VARIANTS = frozenset(
    {"taps", "im2col", "dhdw", "flat", "dwout", "dwnp", "dwm", "dwmf",
     "fullh"})

_OUT_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32)}
MAX_COUT = 32        # the JAX shape gate's Cout limit (see conv_kernel_ok)
STRIP_ROWS = 16      # image rows per f32 wgrad strip (wgrad::kStripRows)
MMA_TILE_ROWS = 4    # rows of the bf16 wgrad's tile (tc::wg::kTH): its strip
                     # heights are multiples of it
MMA_MIN_BLOCKS = 256  # bf16 wgrad blocks that fill the card, two an SM


def wgrad_strips(dtype, b: int, cin: int, cout: int, h: int,
                 wd: int):
    """(strip rows, f32 elements) of the scratch buffer that the weight
    gradient's partial pass writes: one [3, 3, Cin, Cout] partial per strip
    of `strip rows` image rows, b * ceil(h / rows) strips (the entry points'
    grid, csrc/conv3x3_mma.cuh launch_wgrad_mma and conv3x3_tile.cuh
    launch_wgrad). f32 takes the CUDA-core pass's fixed STRIP_ROWS. bf16
    takes the tallest of 16, 8 and 4 rows whose grid, strips x input-channel
    chunks (16 channels up to Cin 16, 32 up to 32, else 64) x output-channel
    chunks (32 channels above Cout 16, else one), still has MMA_MIN_BLOCKS
    blocks, two for each of the H100's 132 SMs, or 4 rows: taller strips
    write fewer partials and pay each block's fixed cost less often; on
    an H100 16 rows were fastest where they gave 256 blocks and 8 where
    16 gave 128."""
    if dtype != torch.bfloat16:
        return STRIP_ROWS, b * -(-h // STRIP_ROWS) * 9 * cin * cout
    chunks = -(-cin // (16 if cin <= 16 else 32 if cin <= 32 else 64)) * (
        -(-cout // 32) if cout > 16 else 1)
    rows = next((r for r in (16, 8) if b * -(-h // r) * chunks
                 >= MMA_MIN_BLOCKS), MMA_TILE_ROWS)
    return rows, b * -(-h // rows) * 9 * cin * cout


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' working dtype: at least f32 (f64 stays f64)."""
    return torch.promote_types(t.dtype, torch.float32)


def conv3x3_nchw_plain(x: torch.Tensor, w: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """The plain forward: F.conv2d in (at least) f32 on the cast inputs,
    cast to the output dtype. x [B, Cin, H, W], w [3, 3, Cin, Cout]
    HWIO."""
    ct = _acc_dtype(x)
    y = F.conv2d(x.to(ct), w.to(ct).permute(3, 2, 0, 1), padding=1)
    return y.to(out_dtype or x.dtype)


def conv3x3_nchw_dgrad_plain(g: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """The plain dgrad: the plain conv of g [B, Cout, H, W] with w flipped
    in (kh, kw) and its in/out channels swapped, in g's dtype."""
    return conv3x3_nchw_plain(g, w.flip((0, 1)).transpose(2, 3))


def conv3x3_nchw_wgrad_plain(x: torch.Tensor, g: torch.Tensor
                             ) -> torch.Tensor:
    """The plain weight gradient, f32 [3, 3, Cin, Cout] (f64 for f64
    inputs): for each tap, an einsum of the shifted zero-padded input with
    g over (B, H, W)."""
    h, w = g.shape[2:]
    ct = _acc_dtype(x)
    xp = F.pad(x.to(ct), (1, 1, 1, 1))
    gf = g.to(ct)
    return torch.stack([torch.stack([
        torch.einsum("bchw,bdhw->cd", xp[:, :, kh:kh + h, kw:kw + w], gf)
        for kw in range(3)]) for kh in range(3)])


@functools.cache
def _fwd_fn():
    lib = _build.load("conv3x3_nchw")
    fn = lib.uaps_conv3x3_nchw_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _wgrad_fn():
    lib = _build.load("conv3x3_wgrad_nchw")
    fn = lib.uaps_conv3x3_wgrad_nchw
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_io(x: torch.Tensor, w: torch.Tensor, out_dtype, what: str):
    if (x.dtype, out_dtype) not in _OUT_PAIRS:
        raise TypeError(f"{what}: unsupported dtypes {x.dtype} -> "
                        f"{out_dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"{what}: w ({w.dtype}, {w.device}) must match x "
                         f"({x.dtype}, {x.device})")


def _launch(x: torch.Tensor, w: torch.Tensor, out_dtype,
            flipped: bool) -> torch.Tensor:
    """The CUDA conv of x with w, or (flipped) with w flipped in (kh, kw)
    and its channels swapped: the kernel then reads w[2, 2, 0, 0] first,
    with negated kh/kw strides, so no flipped copy is made. Counts
    nothing."""
    what = "conv3x3_nchw dgrad" if flipped else "conv3x3_nchw"
    _check_io(x, w, out_dtype, what)
    b, cin, h, wd = x.shape
    s_kh, s_kw, s_ci, s_co = w.stride()
    ptr = w.data_ptr()
    cout = w.shape[3]
    if flipped:
        cout = w.shape[2]
        ptr += (2 * s_kh + 2 * s_kw) * w.element_size()
        s_kh, s_kw, s_ci, s_co = -s_kh, -s_kw, s_co, s_ci
    if b * -(-cout // 32) > 65535:
        raise ValueError(f"{what}: B * ceil(Cout / 32) = "
                         f"{b * -(-cout // 32)} > 65535")
    y = torch.empty((b, cout, h, wd), dtype=out_dtype, device=x.device)
    codes = _build.DTYPE_CODES
    lib, fn = _fwd_fn()
    _build.call(lib, fn, x.device, f"{what} kernel launch", x.data_ptr(),
                ptr, y.data_ptr(), b, cin, cout, h, wd, s_kh, s_kw, s_ci,
                s_co, codes[x.dtype], codes[out_dtype])
    return y


def kernel_path(t: torch.Tensor, what: str) -> bool:
    """True for the kernels (CUDA), False for the plain versions (CPU)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return True


def _forward(x, w, out_dtype):
    global launches
    if not kernel_path(x, "conv3x3_nchw"):
        return conv3x3_nchw_plain(x, w, out_dtype)
    y = _launch(x, w, out_dtype, flipped=False)
    launches += 1
    return y


def conv3x3_nchw_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx [B, Cin, H, W] in g's dtype from g [B, Cout, H, W] and the
    forward's HWIO w [3, 3, Cin, Cout] (JAX: conv3x3_fast_* of g with
    `flip(w, (0, 1)).transpose(0, 1, 3, 2)`)."""
    global dgrad_launches
    if not kernel_path(g, "conv3x3_nchw_dgrad"):
        return conv3x3_nchw_dgrad_plain(g, w)
    dx = _launch(g, w, g.dtype, flipped=True)
    dgrad_launches += 1
    return dx


def conv3x3_nchw_fullh(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """JAX `conv3x3_nchw_fullh`: x [B, Cin, H, W], w [3, 3, Cin, Cout]
    (cast to x's dtype) -> [B, Cout, H, W] in x's dtype; the forward
    kernel, counted in `fullh_launches`."""
    global fullh_launches
    w = w.to(x.dtype)
    if not kernel_path(x, "conv3x3_nchw_fullh"):
        return conv3x3_nchw_plain(x, w)
    y = _launch(x, w, x.dtype, flipped=False)
    fullh_launches += 1
    return y


def conv3x3_nchw_dgrad_fullh(g: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """The fullh VJP's dgrad (JAX: conv3x3_fast_nchw of g with the rotated
    w and variant "fullh"): `conv3x3_nchw_dgrad`, counted in
    `fullh_dgrad_launches`."""
    global fullh_dgrad_launches
    w = w.to(g.dtype)
    if not kernel_path(g, "conv3x3_nchw_dgrad_fullh"):
        return conv3x3_nchw_dgrad_plain(g, w)
    dx = _launch(g, w, g.dtype, flipped=True)
    fullh_dgrad_launches += 1
    return dx


def _check_wgrad(x: torch.Tensor, g: torch.Tensor, what: str) -> bool:
    """Validate a weight gradient's operands; True for the kernel path."""
    if (x.ndim != 4 or g.ndim != 4 or x.shape[0] != g.shape[0]
            or x.shape[2:] != g.shape[2:]):
        raise ValueError(f"{what}: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}; want [B,Cin,H,W], [B,Cout,H,W]")
    return kernel_path(x, what)


def conv3x3_nchw_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x [B, Cin, H, W], g [B, Cout, H, W] (same dtype) -> dW [3, 3, Cin,
    Cout] f32 (JAX `conv3x3_nchw_wgrad`)."""
    global wgrad_launches
    if not _check_wgrad(x, g, "conv3x3_nchw_wgrad"):
        return conv3x3_nchw_wgrad_plain(x, g)
    dw = _wgrad_launch(x, g)
    wgrad_launches += 1
    return dw


def conv3x3_nchw_wgrad_fullh(x: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """JAX `conv3x3_nchw_wgrad_fullh`: `conv3x3_nchw_wgrad`'s function,
    counted in `fullh_wgrad_launches`."""
    global fullh_wgrad_launches
    if not _check_wgrad(x, g, "conv3x3_nchw_wgrad_fullh"):
        return conv3x3_nchw_wgrad_plain(x, g)
    dw = _wgrad_launch(x, g)
    fullh_wgrad_launches += 1
    return dw


def _wgrad_launch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The CUDA weight gradient of CUDA x and g. Counts nothing."""
    if x.dtype not in _build.DTYPE_CODES or g.dtype != x.dtype:
        raise TypeError(f"conv3x3_nchw_wgrad: x {x.dtype} and g {g.dtype} "
                        "must both be float32 or both bfloat16")
    if not (x.is_contiguous() and g.is_contiguous()) or g.device != x.device:
        raise ValueError("conv3x3_nchw_wgrad: x and g must be contiguous "
                         "and on one device")
    b, cin, h, wd = x.shape
    cout = g.shape[1]
    rows, n_part = wgrad_strips(x.dtype, b, cin, cout, h, wd)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    lib, fn = _wgrad_fn()
    _build.call(lib, fn, x.device, "conv3x3_nchw_wgrad kernel launch",
                x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                b, cin, cout, h, wd, rows, _build.DTYPE_CODES[x.dtype])
    return dw


def _variant_forward(x, w, out_dtype, variant):
    if variant == "fullh":
        return conv3x3_nchw_fullh(x, w).to(out_dtype)
    return _forward(x, w, out_dtype)


class _Conv3x3(torch.autograd.Function):
    """The conv with the JAX VJP as its backward (the fullh entries for
    variant "fullh")."""

    @staticmethod
    def forward(ctx, x, w, out_dtype, variant):
        ctx.save_for_backward(x, w)
        ctx.fullh = variant == "fullh"
        return _variant_forward(x, w, out_dtype, variant)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype).contiguous()
        dgrad, wgrad = ((conv3x3_nchw_dgrad_fullh, conv3x3_nchw_wgrad_fullh)
                        if ctx.fullh else
                        (conv3x3_nchw_dgrad, conv3x3_nchw_wgrad))
        dx = dgrad(g, w) if ctx.needs_input_grad[0] else None
        dw = wgrad(x, g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def conv3x3_nchw(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
                 hw=None, variant: str = "taps") -> torch.Tensor:
    """x [B, Cin, H, W] (or [B, Cin, H*W] with hw=(H, W)), w [3, 3, Cin,
    Cout] -> [B, Cout, H, W] (flat in, flat out); differentiable in x and
    w. `variant`: one of VARIANTS ("fullh": see the module docstring)."""
    if variant not in VARIANTS:     # as JAX's conv3x3_nchw raises
        raise ValueError(f"unknown conv variant {variant!r}; "
                         f"expected one of {sorted(VARIANTS)}")
    flat = hw is not None
    if flat:
        x = x.view(x.shape[0], x.shape[1], *hw)
    if x.ndim != 4 or w.ndim != 4 or w.shape[:3] != (3, 3, x.shape[1]):
        raise ValueError(f"conv3x3_nchw: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}; want [B,Cin,H,W], [3,3,Cin,Cout]")
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _Conv3x3.apply(x, w, out_dtype, variant)
    else:
        y = _variant_forward(x, w, out_dtype, variant)
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


# ------------------------------------------------------------------ stats
def _block_conv():
    # the moments kernels' module (imported here: it imports this one)
    from uaps_tpu_torch.kernels import block_conv
    return block_conv


def conv3x3_nchw_stats(x: torch.Tensor, w: torch.Tensor):
    """JAX `conv3x3_nchw_stats`: x [B, Cin, H, W], w [3, 3, Cin, Cout]
    (cast to x's dtype) -> (y [B, Cout, H, W] in x's dtype, no bias; s1,
    s2 [Cout] f32, the sums of y and y^2 over (B, H, W)). Not
    differentiable (`conv3x3_fast_nchw_stats` is)."""
    global stats_launches
    kbc = _block_conv()
    _check_stats(x, w)
    if not kernel_path(x, "conv3x3_nchw_stats"):
        with torch.no_grad():
            return kbc.chain_plain_ref(x, w)
    y, mom = kbc.kernel_fwd(x.contiguous(), kbc.w9(w, x.dtype), None, None,
                            None, 0.0, True, "conv3x3_nchw_stats")
    stats_launches += 1
    return y, mom[0], mom[1]


def _check_stats(x, w):
    if x.ndim != 4 or w.ndim != 4 or w.shape[:3] != (3, 3, x.shape[1]):
        raise ValueError(f"conv3x3_nchw_stats: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}; want [B,Cin,H,W], [3,3,Cin,Cout]")


def _stats_backward(g, ds1, ds2, y, x, w, need_dx):
    """(dx or None, dW in w's dtype) from the three cotangents (None
    counts as zero)."""
    global stats_bwd_launches
    kbc = _block_conv()
    if g is None:
        g = torch.zeros_like(y)
    if not kernel_path(x, "conv3x3_nchw_stats"):
        dx, dw, _, _ = kbc.chain_bwd_plain(kbc.fold_plain(g, y, ds1, ds2),
                                           x, w, None, None, None, 0.0,
                                           need_dx)
    else:
        dx, dw, _, _ = kbc.kernel_bwd(
            g.to(x.dtype).contiguous(), y, ds1, ds2, x.contiguous(),
            kbc.w9(w, x.dtype), None, None, None, 0.0, need_dx,
            "conv3x3_nchw_stats")
        stats_bwd_launches += 1
    return dx, dw.to(w.dtype)


class _Stats(torch.autograd.Function):
    """conv3x3_nchw_stats with JAX's `_vjp_bwd_stats` as its backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.set_materialize_grads(False)
        y, s1, s2 = conv3x3_nchw_stats(x, w)
        ctx.save_for_backward(x, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, g, ds1, ds2):
        x, w, y = ctx.saved_tensors
        return _stats_backward(g, ds1, ds2, y, x, w,
                               ctx.needs_input_grad[0])


def conv3x3_fast_nchw_stats(x: torch.Tensor, w: torch.Tensor):
    """JAX `conv3x3_fast_nchw_stats`: (y, s1, s2) as conv3x3_nchw_stats,
    differentiable in x and w through all three."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Stats.apply(x, w)
    return conv3x3_nchw_stats(x, w)


def conv_kernel_ok(h: int, w: int, cin: int, cout: int) -> bool:
    """The JAX shape gate for the Pallas conv (uaps_tpu/models/unet.py
    Conv3x3, `use_pallas`): where the model routes a conv to the kernel."""
    return (h >= 128 and w >= 128 and h % 8 == 0 and w % 128 == 0
            and cout <= MAX_COUT and cin <= 64)
