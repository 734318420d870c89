"""The conv with its output's moments (`conv3x3_nchw_stats`), the fullh
conv variant, the NHWC conv (`conv3x3_small`) and the StatsBatchNorm
ConvBlocks (`bn_stats=True`, bn_backend="flat") of the port against the JAX
package on the CPU, and the routing of a UAPS step built with
conv_variant="fullh", bn_backend="flat".

The kernel functions are held to the Pallas kernels in interpret mode (their
forwards and `jax.vjp`), in f32 at the shapes of tests/test_pallas.py:
(1, 8, 16, 128) for the stats conv, (2, 8, 16, 128) for fullh, (2, 16, 128,
16) -> 8 NHWC, and NHWC at two shapes where the CUDA kernel's bf16
tensor-core tile pads and masks (NHWC_ODD). Tolerances: outputs rtol 1e-4 / atol 1e-5 and the moments
rtol 1e-5 / atol 1e-4, as tests/test_pallas.py holds the kernels to XLA (the
same f32 products summed in another order); gradients within 1e-5 of the
largest |grad| of their tensor (the same). The bf16 fullh conv with an f32
output: both sides round to bf16 first (JAX's contract), so every value
equals its own bf16 rounding and the two sides agree within one bf16 ulp
(rtol 2^-7, where the f32 sums round to neighbouring bf16 values).

The ConvBlocks and the U-Net run with f64 activations
(`jax.enable_x64(True)`; tests/test_torch_port_train.py says why), the
StatsBatchNorm moments in f32 on both sides (JAX casts y to f32 before the
sums): those sums differ in their order, ~1e-7 relative, so outputs and
running stats are held to rtol = atol = 1e-5 and gradients to 1e-4 of their
tensor's largest |grad| (the BN-fed conv biases, whose exact gradient is 0,
to 1e-4 of the block's largest). On the CPU JAX reaches no kernel, and the
port's shape gates are opened, so that the port routes through its kernel
modules (their plain versions).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from _torch_port_util import ZERO_GRAD_BIASES, Counts, jax_sd
from _torch_port_util import jit, open_gates, seeded_variables
from uaps_tpu.models import unet as junet
from uaps_tpu.pallas import conv3x3 as jnhwc
from uaps_tpu.pallas import conv3x3_nchw as jconv
from uaps_tpu_torch.kernels import conv3x3 as knhwc
from uaps_tpu_torch.kernels import conv3x3_nchw as kconv
from uaps_tpu_torch.models import unet as tunet
from uaps_tpu_torch.utils.weights import load_jax_params, state_dict_from_jax


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close_grad(got, ref, what, tol=1e-5):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * np.abs(ref).max(), f"{what}: {err}"


def _jax_vjp(fn, args, cts):
    """fn's outputs and their VJP at cts, as one compiled program."""
    @jit
    def run(a, c):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(c)
    return run(tuple(jnp.asarray(v) for v in args),
               jax.tree.map(jnp.asarray, cts))


@pytest.fixture
def gates_open(monkeypatch):
    """The kernel shape gates opened (`open_gates`): the port routes a
    block's convs through the kernel modules at test sizes (a net's tests
    narrow the gate to its level-0/1 convs)."""
    open_gates(monkeypatch)
    return monkeypatch


# ------------------------------------------------------------ stats conv
def test_conv_stats_and_vjp_match_jax():
    """conv3x3_nchw_stats (y, s1, s2) and conv3x3_fast_nchw_stats's
    backward with cotangents on all three against JAX's
    conv3x3_fast_nchw_stats (conv3x3_nchw_stats in interpret mode)."""
    rng = np.random.default_rng(0)
    x, w = _rand(rng, (1, 8, 16, 128)), _rand(rng, (3, 3, 8, 8), 0.1)
    cts = (_rand(rng, (1, 8, 16, 128)), _rand(rng, 8), _rand(rng, 8))
    (ry, r1, r2), (rx, rw) = _jax_vjp(
        lambda a, b: jconv.conv3x3_fast_nchw_stats(a, b, True), (x, w), cts)
    y, s1, s2 = kconv.conv3x3_nchw_stats(_t(x), _t(w))
    np.testing.assert_allclose(y.numpy(), ry, rtol=1e-4, atol=1e-5)
    for got, ref in ((s1, r1), (s2, r2)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    xt, wt = _t(x, True), _t(w, True)
    outs = kconv.conv3x3_fast_nchw_stats(xt, wt)
    torch.autograd.backward(outs, [_t(c) for c in cts])
    _close_grad(xt.grad, rx, "dx")
    _close_grad(wt.grad, rw, "dW")


# ----------------------------------------------------------------- fullh
def _fullh_data(dtype=np.float32):
    rng = np.random.default_rng(1)
    return (_rand(rng, (2, 8, 16, 128)).astype(dtype),
            _rand(rng, (3, 3, 8, 8), 0.1).astype(dtype),
            _rand(rng, (2, 8, 16, 128)).astype(dtype))


@pytest.fixture(scope="module")
def fullh_ref():
    """JAX's conv3x3_fast_nchw(variant="fullh") and its VJP in interpret
    mode: y is conv3x3_nchw_fullh(x, w), the VJP's dW
    conv3x3_nchw_wgrad_fullh(x, g) and its dx the fullh conv of g with the
    rotated w."""
    x, w, g = _fullh_data()
    y, (dx, dw) = _jax_vjp(
        lambda a, b: jconv.conv3x3_fast_nchw(a, b, True, "fullh"), (x, w), g)
    return x, w, g, y, dx, dw


def test_fullh_forward_and_wgrad_match_jax(fullh_ref):
    """conv3x3_nchw_fullh, conv3x3_nchw_dgrad_fullh and
    conv3x3_nchw_wgrad_fullh against JAX's fullh kernels (interpret
    mode)."""
    x, w, g, ry, rdx, rdw = fullh_ref
    got = kconv.conv3x3_nchw_fullh(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), ry, rtol=1e-4, atol=1e-5)
    _close_grad(kconv.conv3x3_nchw_dgrad_fullh(_t(g), _t(w)), rdx,
                "fullh dgrad")
    got = kconv.conv3x3_nchw_wgrad_fullh(_t(x), _t(g))
    assert got.dtype == torch.float32 and got.shape == (3, 3, 8, 8)
    _close_grad(got, rdw, "fullh dW")


def test_fullh_route_matches_jax(fullh_ref):
    """conv3x3_nchw(variant="fullh") and its VJP (the fullh dgrad and
    wgrad) against JAX's conv3x3_fast_nchw(variant="fullh"); in bf16 with
    out_dtype f32 both return bf16-rounded values, where the default
    variant keeps the f32 accumulator."""
    x, w, g, ref, rx, rw = fullh_ref
    xt, wt = _t(x, True), _t(w, True)
    y = kconv.conv3x3_nchw(xt, wt, variant="fullh")
    np.testing.assert_allclose(y.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-5)
    y.backward(_t(g))
    _close_grad(xt.grad, rx, "fullh dx")
    _close_grad(wt.grad, rw, "fullh dW")

    xb, wb = (jnp.asarray(v, jnp.bfloat16) for v in (x, w))
    ref = np.asarray(jax.jit(lambda a, b: jconv.conv3x3_nchw(
        a, b, True, "fullh", jnp.float32))(xb, wb))
    tb = [torch.from_numpy(np.asarray(v.astype(jnp.float32))).bfloat16()
          for v in (xb, wb)]
    got = kconv.conv3x3_nchw(*tb, torch.float32, variant="fullh")
    taps = kconv.conv3x3_nchw(*tb, torch.float32)
    assert ref.dtype == np.float32 and got.dtype == torch.float32
    assert torch.equal(got, got.bfloat16().float())
    np.testing.assert_array_equal(
        ref, np.asarray(jnp.asarray(ref).astype(jnp.bfloat16)
                        .astype(jnp.float32)))
    assert not torch.equal(taps, taps.bfloat16().float())
    np.testing.assert_allclose(got.numpy(), ref, rtol=2 ** -7, atol=1e-6)


def test_unknown_variant_raises_as_in_jax():
    x = np.zeros((1, 4, 8, 128), np.float32)
    w = np.zeros((3, 3, 4, 4), np.float32)
    with pytest.raises(ValueError, match="unknown conv variant"):
        jconv.conv3x3_nchw(jnp.asarray(x), jnp.asarray(w), True, "bogus")
    with pytest.raises(ValueError, match="unknown conv variant"):
        kconv.conv3x3_nchw(_t(x), _t(w), variant="bogus")


# ------------------------------------------------------------------ NHWC
def _nhwc_data(shape=(2, 16, 128, 16, 8)):
    """x [B, H, W, Cin], w [3, 3, Cin, Cout] and a cotangent; the default
    is tests/test_pallas.py TestConv3x3Kernels._data."""
    b, h, wd, cin, cout = shape
    rng = np.random.default_rng(2)
    return (_rand(rng, (b, h, wd, cin)), _rand(rng, (3, 3, cin, cout), 0.1),
            _rand(rng, (b, h, wd, cout)))


# where the CUDA kernels' bf16 tensor-core tile pads and masks: a ragged
# 37 x 70 image (8 x 32 pixel tiles; JAX's _pick_slab takes all 37 rows),
# Cin 3 (the generic staging) and Cout 13 (channels padded to 16, scalar
# stores); Cin 40 (16-byte staging with a last K chunk of 8 channels) and
# Cout 72 (two groups of 64 output channels), whose dgrad writes Cin 40
NHWC_ODD = {"3->13 @37x70": (2, 37, 70, 3, 13),
            "40->72 @37x70": (2, 37, 70, 40, 72)}


@pytest.mark.parametrize(
    "part,odd", [("forward", None), ("wgrad", None), ("small_vjp", None)]
    + [("small_vjp", odd) for odd in NHWC_ODD],
    ids=["forward", "wgrad", "small_vjp"]
    + [f"small_vjp {odd}" for odd in NHWC_ODD])
def test_nhwc_conv_matches_jax(part, odd):
    """conv3x3_forward, conv3x3_wgrad and conv3x3_small's VJP (whose
    forward is conv3x3_forward, its dgrad conv3x3_dgrad and its dW
    conv3x3_wgrad) against uaps_tpu/pallas/conv3x3.py in interpret mode."""
    shape = NHWC_ODD[odd] if odd else (2, 16, 128, 16, 8)
    x, w, g = _nhwc_data(shape)
    if part == "forward":
        ref = jax.jit(lambda a, b: jnhwc.conv3x3_forward(a, b, True))(x, w)
        got = knhwc.conv3x3_forward(_t(x), _t(w))
        assert got.is_contiguous() and got.shape == (*shape[:3], shape[4])
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            knhwc.reference_conv3x3(_t(x), _t(w)).numpy(), ref, rtol=1e-4,
            atol=1e-5)
    elif part == "wgrad":
        ref = jax.jit(lambda a, b: jnhwc.conv3x3_wgrad(a, b, True))(x, g)
        got = knhwc.conv3x3_wgrad(_t(x), _t(g))
        assert got.dtype == torch.float32
        _close_grad(got, ref, "nhwc dW")
    else:
        ref, (rx, rw) = _jax_vjp(
            lambda a, b: jnhwc.conv3x3_small(a, b, True), (x, w), g)
        xt, wt = _t(x, True), _t(w, True)
        y = knhwc.conv3x3_small(xt, wt)
        np.testing.assert_allclose(y.detach().numpy(), ref, rtol=1e-4,
                                   atol=1e-5)
        y.backward(_t(g))
        _close_grad(xt.grad, rx, "nhwc dx")
        _close_grad(wt.grad, rw, "nhwc dW")


# ------------------------------------------------------ StatsBatchNorm
B, CIN, COUT, H, W = 2, 4, 8, 16, 32


def _block_vars(seed):
    """JAX ConvBlock variables from numpy: seeded conv kernels and biases,
    BN scale/bias and running stats away from their defaults."""
    rng = np.random.default_rng(seed)

    def conv(ci):
        return {"kernel": _rand(rng, (3, 3, ci, COUT), 1 / np.sqrt(9 * ci)),
                "bias": _rand(rng, COUT, 0.05)}

    def bn():
        return {"scale": rng.uniform(0.8, 1.2, COUT).astype(np.float32),
                "bias": _rand(rng, COUT, 0.05)}

    def stats():
        return {"mean": _rand(rng, COUT, 0.1),
                "var": rng.uniform(0.5, 1.5, COUT).astype(np.float32)}

    return {"params": {"Conv_0": conv(CIN), "BatchNorm_0": bn(),
                       "Conv_1": conv(COUT), "BatchNorm_1": bn()},
            "batch_stats": {"BatchNorm_0": stats(), "BatchNorm_1": stats()}}


def _block_sd(params, stats=None):
    """A ConvBlock's state dict through state_dict_from_jax (as the
    encoder's in_conv)."""
    sd = state_dict_from_jax({"encoder": {"in_conv": params}},
                             {"encoder": {"in_conv": stats or {}}})
    pre = "encoder.in_conv."
    return {k[len(pre):]: v for k, v in sd.items()}


@pytest.mark.parametrize("kind", ["bn_stats", "flat"])
def test_stats_convblock_matches_jax(gates_open, kind):
    """ConvBlock(bn_stats=True) and ConvBlock(bn_backend="flat") against
    JAX's, f64 activations: the train-mode output, the running stats it
    leaves and the gradients of the parameters and the input; then the
    eval output. The bn_stats block runs the stats conv module."""
    counts = Counts(gates_open, [(tunet, "conv3x3_fast_nchw_stats")])
    knobs = ({"bn_stats": True} if kind == "bn_stats"
             else {"bn_backend": "flat"})
    v = _block_vars(7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, CIN, H, W))
    ct = rng.standard_normal((B, COUT, H, W))
    with jax.enable_x64(True):
        jb = junet.ConvBlock(COUT, 0.0, jnp.float64, "nchw", **knobs)

        def loss(p, xx):
            y, mut = jb.apply({"params": p, "batch_stats": v["batch_stats"]},
                              xx, train=True, mutable=["batch_stats"])
            return (y * ct).sum(), (y, mut["batch_stats"])

        (_, (ry, rstats)), (rgp, rgx) = jit(jax.value_and_grad(
            loss, (0, 1), has_aux=True))(v["params"], jnp.asarray(x))
        rev = np.asarray(jb.apply(v, jnp.asarray(x), train=False))
    pb = tunet.ConvBlock(CIN, COUT, 0.0, torch.float64, True, **knobs)
    assert isinstance(pb.conv_conv[5], tunet.StatsBatchNorm)
    pb.load_state_dict(_block_sd(v["params"], v["batch_stats"]), strict=True)
    with torch.no_grad():
        ev = pb.eval()(_t(x))     # before train mode moves the BN stats
    xt = _t(x, True)
    y = pb.train()(xt)
    y.backward(_t(ct))
    # two convs a forward, in eval and in train mode
    assert counts.n.get("conv3x3_fast_nchw_stats", 0) == (
        4 if kind == "bn_stats" else 0)
    np.testing.assert_allclose(y.detach().numpy(), ry, rtol=1e-5, atol=1e-5)
    sd = pb.state_dict()
    for k, want in _block_sd(v["params"], rstats).items():
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    grads = {k: p.grad.numpy() for k, p in pb.named_parameters()}
    jgrads = _block_sd(jax.tree.map(np.asarray, rgp))
    scale = max(np.abs(g.numpy()).max() for g in jgrads.values())
    for k, want in jgrads.items():
        if k.endswith(ZERO_GRAD_BIASES):
            assert np.abs(grads[k]).max() <= 1e-4 * scale, k
        else:
            _close_grad(grads[k], want.numpy(), k, 1e-4)
    _close_grad(xt.grad, rgx, "dx", 1e-4)
    np.testing.assert_allclose(ev.numpy(), rev, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- the U-Net
# tests/test_torch_port_train.py's narrow U-Net and image size, whose
# variable tree (the same for every knob here) is traced once per process
FEATURES = (8, 16, 32, 64, 128)
UNET_HW = (16, 128)


def test_unet_fullh_flat_matches_jax(gates_open):
    """UNet(conv_variant="fullh", bn_backend="flat", nchw_levels=2): the
    train-mode logits, the BN running stats and the parameter gradients
    against JAX's, f64 activations (the f32 logits head on both sides);
    the port's level-0/1 convs take the fullh entries and every level-0/1
    BN is a StatsBatchNorm."""
    open_gates(gates_open, UNET_HW[1])
    counts = Counts(gates_open, [
        (kconv, "conv3x3_nchw_fullh"), (kconv, "conv3x3_nchw_dgrad_fullh"),
        (kconv, "conv3x3_nchw_wgrad_fullh"), (kconv, "_forward")])
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, *UNET_HW, 3))
    ct = rng.standard_normal((2, *UNET_HW, 4))
    knobs = dict(nchw_levels=2, conv_variant="fullh", bn_backend="flat",
                 head_variant="dwmf")
    v = seeded_variables(junet.UNet(
        num_classes=4, features=FEATURES, dropout=(0.0,) * 5, nchw_levels=2,
        conv_variant="dwmf", head_variant="dwmf", dtype=jnp.float32),
        UNET_HW, 10)
    with jax.enable_x64(True):
        jm = junet.UNet(num_classes=4, features=FEATURES,
                        dropout=(0.0,) * 5, dtype=jnp.float64, **knobs)

        def loss(p):
            lg, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
            return (lg * ct).sum(), (lg, mut["batch_stats"])

        (_, (rlg, rstats)), rg = jit(jax.value_and_grad(
            loss, has_aux=True))(v["params"])
    pm = load_jax_params(
        tunet.UNet(4, 3, torch.float64, features=FEATURES,
                   dropout=(0.0,) * 5, **knobs),
        v["params"], v["batch_stats"]).train()
    lg = pm(_t(x))
    (lg * _t(ct)).sum().backward()
    # levels 0-1: in_conv, down1, up3, up4, two convs each; the image
    # needs no gradient; the head (dwmf) takes the default entry
    assert counts.n == {"conv3x3_nchw_fullh": 8,
                        "conv3x3_nchw_dgrad_fullh": 7,
                        "conv3x3_nchw_wgrad_fullh": 8, "_forward": 1}
    stats_bns = [m for m in pm.modules()
                 if isinstance(m, tunet.StatsBatchNorm)]
    assert len(stats_bns) == 8
    scale = np.abs(np.asarray(rlg)).max()
    np.testing.assert_allclose(lg.detach().numpy(), rlg, rtol=1e-5,
                               atol=1e-5 * scale)
    sd = pm.state_dict()
    for k, want in jax_sd(v["params"], rstats).items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    jg = jax_sd(jax.tree.map(np.asarray, rg))
    big = max(np.abs(g).max() for g in jg.values())
    for k, p in pm.named_parameters():
        if k.endswith(ZERO_GRAD_BIASES):
            assert np.abs(p.grad.numpy()).max() <= 1e-4 * big, k
        else:
            _close_grad(p.grad.numpy(), jg[k], k, 1e-4)


def test_uaps_step_fullh_flat_routes_through_the_kernel_modules(gates_open):
    """build_model with conv_variant="fullh", bn_backend="flat" builds unet
    and unet_uaps; one UAPS step of unet_uaps on the CPU (full width, 2 + 2
    images of 32 x 32, the kernel gates opened) has finite metrics and goes
    through the fullh entries and StatsBatchNorm as the chip's step does:
    40 fullh forwards, 38 dgrads and 40 wgrads (levels 0-1 of the encoder
    twice and of 4 decoders twice), the 8 heads on the default entry, 40
    StatsBatchNorms."""
    from uaps_tpu_torch.data import SyntheticDefects
    from uaps_tpu_torch.methods import build_model, get_method
    from uaps_tpu_torch.train import to_device
    from uaps_tpu_torch.utils.cli import parse_args
    cfg, _ = parse_args(["--preset", "neu", "--method", "uaps", "--dtype",
                         "bfloat16", "--dataset", "synthetic"])
    cfg.model = dataclasses.replace(cfg.model, conv_variant="fullh",
                                    bn_backend="flat")
    cfg.data = dataclasses.replace(cfg.data, image_size=(32, 32),
                                   batch_size=2)
    for name in ("unet", "unet_uaps"):
        m = build_model(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, name=name)), "cpu")
        assert sum(isinstance(b, tunet.StatsBatchNorm)
                   for b in m.modules()) == (8 if name == "unet" else 20)
    open_gates(gates_open, 32)
    counts = Counts(gates_open, [
        (kconv, "conv3x3_nchw_fullh"), (kconv, "conv3x3_nchw_dgrad_fullh"),
        (kconv, "conv3x3_nchw_wgrad_fullh"), (kconv, "_forward"),
        (kconv, "conv3x3_nchw_dgrad"), (kconv, "conv3x3_nchw_wgrad"),
        (tunet.StatsBatchNorm, "forward")])
    method = get_method("uaps")
    state, model = method.init_state(cfg, "cpu")
    b = to_device(next(SyntheticDefects(cfg.data, seed=3).train_iter()),
                  "cpu")
    state, met = method.make_train_step(cfg, model)(state, b)
    assert np.isfinite([float(v) for v in met.values()]).all()
    assert counts.n == {"conv3x3_nchw_fullh": 40,
                        "conv3x3_nchw_dgrad_fullh": 38,
                        "conv3x3_nchw_wgrad_fullh": 40, "_forward": 8,
                        "conv3x3_nchw_dgrad": 8, "conv3x3_nchw_wgrad": 8,
                        "forward": 40}
