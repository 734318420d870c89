"""The port's kernel modules against the JAX Pallas kernels (interpret mode).

On the CPU each port wrapper runs its plain version; these tests hold it,
forward and backward (the port's autograd against `jax.vjp` of the Pallas
entry points), to the Pallas kernel on the same numpy inputs, at the small
shapes of tests/test_pallas.py (2 x Cin x 16 x 128). The CUDA kernels
themselves are held to the plain versions on the card by chip_smoke.py.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from uaps_tpu_torch.kernels import _build
from uaps_tpu_torch.kernels import ce_dice as kce
from uaps_tpu_torch.kernels import conv3x3_nchw as kconv
from uaps_tpu_torch.kernels import pool_nchw as kpool

H, W = 16, 128


def _bf16(a):
    """numpy f32 values rounded to bf16 (exact in both frameworks)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("cin,cout,hw", [
    pytest.param(3, 16, (H, W), id="3-16"),
    pytest.param(16, 32, (H, W), id="16-32"),
    pytest.param(64, 32, (H, W), id="64-32"),
    pytest.param(40, 13, (11, 70), id="40-13-11x70")])
def test_conv_flat_matches_pallas(cin, cout, hw):
    """conv3x3_fast_flat, f32: the ConvBlock convs (in_conv's Cin=3 is the
    unaligned case), and Cin 40 -> Cout 13 on an 11 x 70 image, whose W is
    no multiple of the bf16 tensor-core tile's 32 columns and whose Cout
    pads its n8 tiles (chip_smoke.py holds the kernel to this plain
    version there)."""
    from uaps_tpu.pallas.conv3x3_nchw import conv3x3_fast_flat
    rng = np.random.default_rng(cin * 100 + cout)
    h, wd = hw
    x = rng.standard_normal((2, cin, h * wd)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout))
         / np.sqrt(9 * cin)).astype(np.float32)
    ref = np.asarray(conv3x3_fast_flat(jnp.asarray(x), jnp.asarray(w),
                                       hw, True))
    before = kconv.launches
    got = kconv.conv3x3_fast_flat(torch.from_numpy(x), torch.from_numpy(w),
                                  hw)
    assert got.shape == (2, cout, h * wd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert kconv.launches == before   # CPU tensors never reach the kernel


def test_conv_head_bf16_in_f32_out_matches_pallas():
    """conv3x3_fast_nchw as the logits head: bf16 in, f32 out, Cout=4."""
    from uaps_tpu.pallas.conv3x3_nchw import conv3x3_fast_nchw
    rng = np.random.default_rng(4)
    x = _bf16(rng.standard_normal((2, 16, H, W)))
    w = _bf16(rng.standard_normal((3, 3, 16, 4)) / 12.0)
    ref = np.asarray(conv3x3_fast_nchw(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), True,
        "dwmf", jnp.float32))
    got = kconv.conv3x3_fast_nchw(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(w).to(torch.bfloat16), torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _pool_input(rng, with_inf):
    # quantised values force in-window ties
    x = (np.round(rng.standard_normal((2, 16, 32, W)) * 2) / 2)
    if with_inf:
        # single -inf entries; a window of only -inf (or any +inf) poisons
        # the Pallas kernel's selection matmul (inf * 0 = NaN), a fault of
        # the reference recorded in ROADMAP.md Queue C
        x[0, 0, 0, 0] = -np.inf
        x[1, 5, 7, 33] = -np.inf
        x[1, 15, 31, W - 1] = -np.inf
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype,with_inf", [
    ("float32", False), ("float32", True), ("bfloat16", True)])
def test_pool_matches_pallas(dtype, with_inf):
    from uaps_tpu.pallas.pool_nchw import max_pool_2x2_nchw
    x = _pool_input(np.random.default_rng(7), with_inf)
    ref = np.asarray(max_pool_2x2_nchw(jnp.asarray(x, dtype), True)
                     .astype(jnp.float32))
    before = kpool.launches
    got = kpool.max_pool_2x2_nchw(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert kpool.launches == before


def test_pool_gate_matches_jax():
    from uaps_tpu.pallas.pool_nchw import pool_pallas_ok as jax_ok
    for shape in [(1, 16, 256, 256), (1, 32, 128, 128), (1, 64, 64, 64),
                  (1, 16, 20, 128), (1, 64, 256, 256), (2, 8, 32, 256)]:
        assert kpool.pool_pallas_ok(torch.zeros(shape)) == jax_ok(
            jnp.zeros(shape)), shape


@pytest.mark.parametrize("cin,cout,dtype,hw", [
    pytest.param(*case, (H, W), id="-".join(map(str, case))) for case in [
        (16, 32, "float32"), (64, 32, "float32"), (16, 16, "bfloat16"),
        (3, 16, "bfloat16"), (40, 4, "bfloat16"), (32, 13, "bfloat16")]] + [
    pytest.param(13, 40, "bfloat16", (11, 70), id="13-40-bfloat16-11x70")])
def test_conv_flat_vjp_matches_pallas(cin, cout, dtype, hw):
    """dgrad and wgrad of the flat entry (JAX `_vjp_bwd_flat`): Cout 32,
    the 64-channel dgrad of up3.0 (64 -> 32), and bf16, where the cotangent,
    dx and dW are bf16; in bf16 also Cin 3 and 40 and Cout 4 and 13, where
    the tensor-core wgrad pads its channel tiles, and 13 -> 40 on an 11 x 70
    image, where the tensor-core dgrad pads its K (13) and N (40) and masks
    a W that is no multiple of its 32 columns. f32: rtol 1e-4 / atol 1e-4
    x max |grad| (sums of 2 x 16 x 128 products in another order); bf16:
    rtol 1e-2 (one bf16 ulp, 2^-7, after the f32 sums are rounded)."""
    from uaps_tpu.pallas.conv3x3_nchw import conv3x3_fast_flat
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(cin + cout)
    npx = hw[0] * hw[1]
    x = _bf16(rng.standard_normal((2, cin, npx)))
    w = _bf16(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
    g = _bf16(rng.standard_normal((2, cout, npx)))
    _, vjp = jax.vjp(lambda a, b: conv3x3_fast_flat(a, b, hw, True),
                     jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    jdx, jdw = (np.asarray(t.astype(jnp.float32))
                for t in vjp(jnp.asarray(g, jdt)))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    kconv.conv3x3_fast_flat(xt, wt, hw).backward(
        torch.from_numpy(g).to(tdt))
    assert xt.grad.dtype == wt.grad.dtype == tdt
    assert xt.grad.shape == (2, cin, npx)
    for got, ref in ((xt.grad, jdx), (wt.grad, jdw)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(ref).max())
        else:
            np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2,
                                       atol=1e-2 * np.abs(ref).max())


def test_conv_head_vjp_matches_pallas():
    """The logits head (JAX `_vjp_bwd_nchw`): bf16 in, f32 out, Cout=4; the
    f32 cotangent is cast to bf16 before dgrad and wgrad, dx and dW are
    bf16. rtol 1e-2 (one bf16 ulp)."""
    from uaps_tpu.pallas.conv3x3_nchw import conv3x3_fast_nchw
    rng = np.random.default_rng(41)
    x = _bf16(rng.standard_normal((2, 16, H, W)))
    w = _bf16(rng.standard_normal((3, 3, 16, 4)) / 12.0)
    g = rng.standard_normal((2, 4, H, W)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: conv3x3_fast_nchw(a, b, True, "dwmf",
                                                    jnp.float32),
                     jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(w, jnp.bfloat16))
    jdx, jdw = (np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g)))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    y = kconv.conv3x3_fast_nchw(xt, wt, torch.float32)
    y.backward(torch.from_numpy(g))
    assert y.dtype == torch.float32
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    for got, ref in ((xt.grad, jdx), (wt.grad, jdw)):
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2,
                                   atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_vjp_matches_pallas(dtype):
    """The first-max routed backward (JAX `_pool_bwd`) on finite inputs
    with in-window ties: exact."""
    from uaps_tpu.pallas.pool_nchw import max_pool_2x2_nchw
    rng = np.random.default_rng(8)
    x = _pool_input(rng, with_inf=False)
    g = np.round(rng.standard_normal((2, 16, 16, W // 2)) * 8) / 8
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a: max_pool_2x2_nchw(a, True), jnp.asarray(x, jdt))
    jdx = np.asarray(vjp(jnp.asarray(g, jdt))[0].astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    kpool.max_pool_2x2_nchw(xt).backward(torch.from_numpy(g).to(tdt))
    assert xt.grad.dtype == tdt
    np.testing.assert_array_equal(xt.grad.float().numpy(), jdx)
    assert (xt.grad != 0).sum() <= g.size      # one position per window


def test_pool_bwd_first_max_and_nan():
    """Routing rules of the plain backward written out: ties go to the
    first position in row-major window order, a NaN window routes nothing,
    a single -inf is never the max."""
    x = torch.tensor([[[[1., 1., 0., 2.],
                        [1., 0., 2., 2.],
                        [0., 0., float("nan"), 0.],
                        [3., 3., 0., 0.],
                        [float("-inf"), 0., -1., -1.],
                        [-2., -3., -1., 5.]]]])
    g = torch.tensor([[[[10., 20.], [30., 40.], [50., 60.]]]])
    want = torch.tensor([[[[10., 0., 0., 20.],
                           [0., 0., 0., 0.],
                           [0., 0., 0., 0.],
                           [30., 0., 0., 0.],
                           [0., 50., 0., 0.],
                           [0., 0., 0., 60.]]]])
    assert torch.equal(kpool.max_pool_2x2_nchw_bwd(x, g), want)


def test_ce_dice_matches_pallas():
    """`fused_ce_dice` (value and dlogits, f32) against the Pallas kernel
    (interpret mode off the TPU), on logits passed as the model passes them
    (a permuted view of NCHW storage), with labels outside [0, C) that both
    treat as all-zero; and, on in-range labels, against the port's plain
    pair (ops/losses.py), whose JAX parity the train and eval tests hold.
    rtol 1e-5 (f32 sums of 4096 pixels in another order)."""
    from uaps_tpu.pallas.ce_dice import fused_ce_dice as jfused
    from uaps_tpu_torch.ops import cross_entropy_loss, softmax_dice_loss
    rng = np.random.default_rng(12)
    nchw = (rng.standard_normal((2, 4, H, W)) * 2).astype(np.float32)
    labels = rng.integers(0, 4, (2, H, W)).astype(np.int32)
    odd = labels.copy()
    odd[0, 0, :3] = 7
    lg = np.ascontiguousarray(nchw.transpose(0, 2, 3, 1))
    (ce, dice), vjp = jax.vjp(lambda a: jfused(a, jnp.asarray(odd)),
                              jnp.asarray(lg))
    jd = np.asarray(vjp((jnp.float32(0.5), jnp.float32(0.3)))[0])
    before = (kce.fwd_launches, kce.bwd_launches)
    xt = torch.from_numpy(nchw).requires_grad_()
    pce, pdice = kce.fused_ce_dice(xt.permute(0, 2, 3, 1),
                                   torch.from_numpy(odd))
    (0.5 * pce + 0.3 * pdice).backward()
    np.testing.assert_allclose([float(pce), float(pdice)],
                               [float(ce), float(dice)], rtol=1e-5)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), jd,
                               rtol=1e-5, atol=1e-5 * np.abs(jd).max())
    grads = []
    for fn in (kce.fused_ce_dice,
               lambda a, b: (cross_entropy_loss(a, b),
                             softmax_dice_loss(a, b))):
        t = torch.from_numpy(lg).requires_grad_()
        pair = fn(t, torch.from_numpy(labels))
        (0.5 * pair[0] + 0.3 * pair[1]).backward()
        grads.append(([float(v) for v in pair], t.grad.numpy()))
    np.testing.assert_allclose(grads[0][0], grads[1][0], rtol=1e-5)
    np.testing.assert_allclose(grads[0][1], grads[1][1], rtol=1e-5,
                               atol=1e-5 * np.abs(grads[1][1]).max())
    assert (kce.fwd_launches, kce.bwd_launches) == before


def test_ce_dice_scratch_made_once():
    """The CE+Dice forward's scratch (its blocks' partials and the ticket
    that finds the last block) is made zeroed once a device, then handed
    back as it is: the kernel leaves the ticket at 0, so no call clears
    it."""
    dev = torch.device("cpu")
    kce._SCRATCH.pop(dev, None)
    try:
        buf = kce._scratch(dev, 33)
        assert buf.dtype == torch.int32 and buf.shape == (33,)
        assert not buf.any()
        assert kce._scratch(dev, 33) is buf
    finally:
        kce._SCRATCH.pop(dev, None)


def test_forward_only_and_device_guards():
    """The kernels are differentiable now (the forward-only guard is gone);
    a device with no kernel and malformed shapes raise."""
    x = torch.zeros((1, 4, 16, 128), requires_grad=True)
    w = torch.zeros((3, 3, 4, 8), requires_grad=True)
    kconv.conv3x3_nchw(x, w).sum().backward()
    kpool.max_pool_2x2_nchw(x).sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    with torch.no_grad():
        assert kconv.conv3x3_nchw(x, w).shape == (1, 8, 16, 128)
    meta = torch.zeros((1, 4, 16, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        kconv.conv3x3_nchw(meta, w.detach().to("meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        kpool.max_pool_2x2_nchw(meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        kconv.conv3x3_nchw_wgrad(meta, meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        kce.ce_dice_stats(meta.permute(0, 2, 3, 1), meta[:, 0].long())
    with pytest.raises(ValueError, match=r"\[3,3,Cin,Cout\]"):
        kconv.conv3x3_nchw(torch.zeros((1, 5, 16, 128)), w)
    with pytest.raises(ValueError, match="does not pool"):
        kpool.max_pool_2x2_nchw_bwd(x, torch.zeros((1, 4, 16, 64)))


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    assert _build.sources() == ["block_conv", "ce_dice", "conv3x3_nchw",
                                "conv3x3_nhwc", "conv3x3_wgrad_nchw",
                                "perturb", "pool_nchw", "pseudo_label",
                                "uncertainty"]


def _c_source(name):
    return (Path(kconv.__file__).resolve().parent.parent / "csrc"
            / name).read_text()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgrad_strips_match_c_grid(dtype):
    """`wgrad_strips`, the one helper that sizes the weight gradient's
    scratch buffer, against the C side: the strip height each route takes
    (csrc/conv3x3_tile.cuh wgrad::kStripRows for f32; a positive multiple of
    csrc/conv3x3_mma.cuh wg::kTH for bf16, as `mma_strip_ok` asks), and
    the launches' grid, B * ceil(H / rows) strips of one [3, 3, Cin, Cout]
    f32 partial each, at the main-path shapes (B = 16) and at the padded
    and ragged ones."""
    tile = _c_source("conv3x3_tile.cuh")
    mma = _c_source("conv3x3_mma.cuh")
    f32_rows = int(re.search(r"constexpr int kStripRows = (\d+);",
                             tile).group(1))
    mma_rows = int(re.search(r"namespace wg \{\s*constexpr int kTH = (\d+);",
                             mma).group(1))
    for src in (tile, mma):   # both launchers' grid formula
        assert re.search(r"= \(h \+ (\w+) - 1\) / \1;", src)
    assert "* 9 * cin * cout" in mma and "* 9 * cin * cout" in tile
    shapes = [(16, 3, 16, 256, 256), (16, 16, 16, 256, 256),
              (16, 16, 32, 128, 128), (16, 32, 32, 128, 128),
              (16, 64, 32, 128, 128), (16, 32, 16, 256, 256),
              (16, 16, 4, 256, 256), (2, 3, 16, 37, 70), (2, 40, 4, 37, 70),
              (2, 40, 13, 37, 70), (2, 64, 32, 37, 70), (1, 8, 8, 1, 1)]
    tdt = getattr(torch, dtype)
    for b, cin, cout, h, wd in shapes:
        rows, n_part = kconv.wgrad_strips(tdt, b, cin, cout, h, wd)
        if dtype == "float32":
            assert rows == f32_rows
        else:
            assert rows >= mma_rows and rows % mma_rows == 0
        assert n_part == b * ((h + rows - 1) // rows) * 9 * cin * cout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_tiles_match_c_grid(dtype):
    """`block_conv.fwd_tiles`, the one helper that sizes the forward's
    moment scratch, against the C side: the tile that each route's forward
    launches (csrc/conv3x3_mma.cuh dg::kTH x dg::kTW for bf16 through
    `mma_tiles_per_image`, csrc/conv3x3_tile.cuh kTH x kTW for f32 through
    `tiles_per_image`), one [2, Cout] partial a tile and image (the count
    does not depend on Cin or Cout), at the main-path shapes (B = 16) and
    at ragged ones (37 x 70, 11 x 35, 9 x 131)."""
    from uaps_tpu_torch.kernels import block_conv as kbc
    tile, mma = _c_source("conv3x3_tile.cuh"), _c_source("conv3x3_mma.cuh")
    block = _c_source("block_conv.cu")
    th, tw = (int(re.search(rf"^constexpr int {k} = (\d+);", tile, re.M)
                  .group(1)) for k in ("kTH", "kTW"))
    dg = re.search(r"namespace dg \{(.*?)\}", mma, re.S).group(1)
    mth, mtw = (int(re.search(rf"constexpr int {k} = (\d+);", dg).group(1))
                for k in ("kTH", "kTW"))
    assert "((h + dg::kTH - 1) / dg::kTH) * ((wd + dg::kTW - 1) / dg::kTW)" \
        in mma
    # the moments' reduce in `fwd`: bf16 over the tensor-core tiles, f32
    # over the CUDA-core ones
    assert re.search(r"batch \* uaps::conv::tc::mma_tiles_per_image\(h, wd\),"
                     r"\s*2 \* cout", block)
    assert re.search(r"batch \* tiles_per_image\(h, wd\),\s*2 \* cout",
                     block)
    want_h, want_w = (mth, mtw) if dtype == "bfloat16" else (th, tw)
    shapes = [(16, 256, 256), (16, 128, 128), (2, 37, 70), (2, 11, 35),
              (1, 1, 1), (3, 9, 131)]
    for b, h, wd in shapes:
        assert kbc.fwd_tiles(getattr(torch, dtype), b, h, wd) == (
            b * -(-h // want_h) * -(-wd // want_w)), (b, h, wd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_dfds_rows_match_c_grid(dtype, monkeypatch):
    """The backward's df/ds scratch (`block_conv.kernel_bwd`'s part_d, one
    [2, Cin] partial a block of the dgrad with the BN prologue) holds
    `fwd_tiles` rows, and the C side reduces as many: the tensor-core
    dgrad (csrc/block_conv.cu bnl_bwd_mma_kernel, on the dg::kTH x dg::kTW
    grid of `mma_grid`) for bf16 through `mma_tiles_per_image`, the
    CUDA-core one (`tile_grid`, kTH x kTW) for f32 through
    `tiles_per_image`; the wrapper's arguments are captured with the
    launch stubbed, at a main-path shape, a ragged one and Cin 72 (two
    channel groups of the tensor-core grid)."""
    from uaps_tpu_torch.kernels import block_conv as kbc
    block = _c_source("block_conv.cu")
    mma = _c_source("conv3x3_mma.cuh")
    assert re.search(r"batch \* uaps::conv::tc::mma_tiles_per_image\(h, wd\),"
                     r"\s*2 \* cin", block)
    assert re.search(r"batch \* tiles_per_image\(h, wd\),\s*2 \* cin", block)
    assert "tc::mma_grid<NB>(batch, a.cin, a.h, a.wd)" in block
    assert re.search(r"return dim3\(\(wd \+ dg::kTW - 1\) / dg::kTW, "
                     r"\(h \+ dg::kTH - 1\) / dg::kTH,", mma)
    if dtype == "bfloat16":
        consts = re.search(r"namespace dg \{(.*?)\}", mma, re.S).group(1)
        pat = r"constexpr int {} = (\d+);"
    else:
        consts = _c_source("conv3x3_tile.cuh")
        pat = r"^constexpr int {} = (\d+);"
    th, tw = (int(re.search(pat.format(k), consts, re.M).group(1))
              for k in ("kTH", "kTW"))
    tdt = getattr(torch, dtype)
    made, seen = [], []
    empty = torch.empty

    def record(*a, **k):
        t = empty(*a, **k)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", record)
    monkeypatch.setattr(kbc, "_fns", lambda: (None, None, None))
    monkeypatch.setattr(kbc._build, "call",
                        lambda lib, fn, dev, what, *args: seen.append(args))
    for b, cin, cout, h, wd in [(16, 16, 16, 256, 256), (2, 40, 13, 37, 70),
                                (2, 72, 13, 37, 70)]:
        made.clear()
        seen.clear()
        x = empty((b, cin, h, wd), dtype=tdt)
        g = empty((b, cout, h, wd), dtype=tdt)
        wk = empty((9, cin, cout), dtype=tdt)
        f, s = torch.ones(cin), torch.zeros(cin)
        kbc.kernel_bwd(g, None, None, None, x, wk, f, s, None, 0.0, True,
                       "test")
        (args,) = seen
        part_d = next(t for t in made if t.data_ptr() == args[10])
        rows = kbc.fwd_tiles(tdt, b, h, wd)
        assert part_d.numel() == rows * 2 * cin, (b, cin, h, wd)
        assert rows == b * -(-h // th) * -(-wd // tw)
