"""The fused ConvBlock backends (conv_backend="chain" and "fused") of the
port against the JAX package on the CPU: the position-hash dropout masks,
the chain and bnl conv functions and their VJPs against JAX's reference
twins (`chain_ref_plain`, `chain_ref_bnl`, `conv3x3_bnl_reference`; JAX's own
tests hold the Pallas kernels to those twins), the chain and fused ConvBlock
against JAX's `ConvBlock(conv_backend=...)`, one UAPS step of a chain model
against `uaps_tpu.methods.uaps`, the weight hand-off, and the routing of a
UAPS step through the kernel modules.

Tolerances (f32 unless stated): the masks bit for bit; forward y atol 1e-4
and moments rtol 1e-5 / atol 1e-4 (the same products summed in another
order over 1024 pixels); gradients within 1e-4 of the largest (the
recipe of JAX's TestChainConvKernels); ConvBlock outputs and running stats
rtol = atol = 1e-5. The UAPS step runs with f64 activations, as the other
step tests do (tests/test_torch_port_train.py says why), but a chain block
takes its moments, the BN prologue and its backward in f32 on both sides
(block_conv.py `_moments`, `x.astype(jnp.float32)`), so the metrics are held
to rtol 1e-5, the parameters after one step as tests/_torch_port_util.py
`check_params` holds them at atol 2e-6, and the BN running stats at rtol
1e-4 / atol 1e-5. The f32 moments differ between the two sides by their
summation order, ~1e-7 relative, which moves every downstream gradient by
~1e-7 of the largest; Adam's first step, lr * g / (|g| + 1e-8), turns that
into up to 5e-5 on elements whose gradient is near 1e-8 (measured), so
`check_params` counts elements below 1e-5 (not 1e-6) of the largest
gradient as noise here. The chain blocks' conv biases must not move on either
side: JAX's gradient is an exact zero, the port's is None, and Adam leaves
both parameters as they were.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from _torch_port_util import (Counts, check_params, jax_sd, jit,
                              neu_config, open_gates, running,
                              seeded_variables)
from uaps_tpu.methods import base as jbase
from uaps_tpu.methods import uaps as juaps
from uaps_tpu.models.unet import MultiDecoderUNet as JaxMultiDecoderUNet
from uaps_tpu.pallas import block_conv as jbc
from uaps_tpu_torch.kernels import block_conv as kbc
from uaps_tpu_torch.kernels import ce_dice as kce
from uaps_tpu_torch.kernels import conv3x3_nchw as kconv
from uaps_tpu_torch.kernels import conv_bnl as kbnl
from uaps_tpu_torch.kernels import perturb as kpt
from uaps_tpu_torch.kernels import pool_nchw as kpool
from uaps_tpu_torch.kernels import uncertainty as kun
from uaps_tpu_torch.methods import base, get_method
from uaps_tpu_torch.models import unet as tunet
from uaps_tpu_torch.utils.weights import load_jax_params

B, CIN, COUT, H, W = 2, 8, 16, 16, 32
SEED = 1234
HW = (16, 128)
FEATURES = (4, 8, 16, 32, 64)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _data(cin=CIN, cout=COUT, h=H, w=W):
    """TestChainConvKernels' recipe (default H = 16, W = 32): x, w, f, s and
    the cotangents of (y, s1, s2)."""
    rng = np.random.RandomState(0)
    x = rng.randn(B, cin, h, w).astype(np.float32)
    wt = (0.1 * rng.randn(3, 3, cin, cout)).astype(np.float32)
    f = (0.5 + rng.rand(cin)).astype(np.float32)
    s = (0.1 * rng.randn(cin)).astype(np.float32)
    cts = [rng.randn(B, cout, h, w).astype(np.float32),
           rng.randn(cout).astype(np.float32),
           rng.randn(cout).astype(np.float32)]
    return x, wt, f, s, cts


def _close_grads(got, ref, what):
    for name, a, b in zip("xfsw" if len(got) == 4 else "xw", got, ref):
        d = np.abs(a - np.asarray(b)).max() / (np.abs(np.asarray(b)).max()
                                               + 1e-9)
        assert d < 1e-4, f"{what} d{name}: {d}"


@pytest.fixture
def gates_open(monkeypatch):
    """The kernel shape gates opened (`open_gates`), so that the port
    routes a block, or a net's level-0/1 blocks, through the kernel modules
    at test sizes."""
    open_gates(monkeypatch)
    return monkeypatch


_jax_keep = jax.jit(jbc.hash_keep_ref, static_argnums=(1, 2))


def _jax_vjp(fn, args, cts):
    """fn's outputs and their VJP at cts, as one compiled program."""
    @jax.jit
    def run(a, c):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(c)
    return run(tuple(jnp.asarray(v) for v in args),
               jax.tree.map(jnp.asarray, cts))


# ------------------------------------------------------------------- masks
@pytest.mark.parametrize("rate", [0.05, 0.1, 0.3])
def test_hash_keep_matches_jax(rate):
    """The port's keep mask equals `hash_keep_ref` bit for bit."""
    shape = (2, 16, 32, 128)
    for seed in (0, 1234, 2 ** 31 - 1):
        ref = np.asarray(_jax_keep(jnp.int32(seed), shape, rate))
        got = kbc.hash_keep(torch.tensor(seed), shape, rate).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"seed {seed}")
        assert abs(got.mean() - (1 - rate)) < 0.01


# -------------------------------------------------------------- functions
@pytest.mark.parametrize("shape", [(CIN, COUT, H, W), (40, 13, 11, 35)])
def test_chain_conv_plain_matches_jax(shape):
    """chain_conv_plain (the autograd function; its plain versions on the
    CPU) and chain_plain_ref (torch autodiff) against chain_ref_plain and
    its jax.vjp, moment cotangents included; also at Cin 40 -> Cout 13 on a
    ragged 11 x 35 image, where the bf16 tensor-core dgrad and wgrad pad
    their channel tiles and mask their pixel tiles (chip_smoke.py holds
    the kernels to these plain versions there)."""
    x, w, _, _, cts = _data(*shape)
    (ry, r1, r2), rgrads = _jax_vjp(jbc.chain_ref_plain, (x, w),
                                    tuple(cts))
    for fn in (kbc.chain_conv_plain, kbc.chain_plain_ref):
        xt, wt = _t(x, True), _t(w, True)
        y, s1, s2 = fn(xt, wt)
        np.testing.assert_allclose(y.detach().numpy(), ry, atol=1e-4)
        for got, ref in ((s1, r1), (s2, r2)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                                       atol=1e-4)
        torch.autograd.backward([y, s1, s2], [_t(c) for c in cts])
        _close_grads([xt.grad.numpy(), wt.grad.numpy()], rgrads,
                     fn.__name__)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_chain_conv_bnl_matches_jax(rate):
    """chain_conv_bnl and chain_bnl_ref against chain_ref_bnl and its
    jax.vjp (dx, df, ds, dW), the moment cotangents folded first; with a
    cotangent for y alone, the fold adds nothing."""
    x, w, f, s, cts = _data()
    seed = jnp.int32(SEED)
    (ry, r1, r2), rgrads = _jax_vjp(
        lambda *a: jbc.chain_ref_bnl(*a, seed, rate), (x, f, s, w),
        tuple(cts))
    for fn in (kbc.chain_conv_bnl, kbc.chain_bnl_ref):
        ins = [_t(v, True) for v in (x, f, s, w)]
        y, s1, s2 = fn(*ins, torch.tensor(SEED), rate)
        np.testing.assert_allclose(y.detach().numpy(), ry, atol=1e-4)
        np.testing.assert_allclose(s1.detach().numpy(), r1, rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(s2.detach().numpy(), r2, rtol=1e-5,
                                   atol=1e-4)
        torch.autograd.backward([y, s1, s2], [_t(c) for c in cts])
        _close_grads([t.grad.numpy() for t in ins], rgrads, fn.__name__)
    # g alone: the moments' cotangents are absent (None in the backward)
    _, ygrads = _jax_vjp(lambda *a: jbc.chain_ref_bnl(*a, seed, rate)[0],
                         (x, f, s, w), cts[0])
    ins = [_t(v, True) for v in (x, f, s, w)]
    y, _, _ = kbc.chain_conv_bnl(*ins, torch.tensor(SEED), rate)
    y.backward(_t(cts[0]))
    _close_grads([t.grad.numpy() for t in ins], ygrads, "y alone")


def test_conv3x3_bnl_matches_jax():
    """conv3x3_bnl and conv3x3_bnl_ref against conv3x3_bnl_reference and
    its jax.vjp (dy, df, ds, dW)."""
    from uaps_tpu.pallas.conv_bnl import conv3x3_bnl_reference
    x, w, f, s, cts = _data()
    ref, rgrads = _jax_vjp(conv3x3_bnl_reference, (x, f, s, w), cts[0])
    for fn in (kbnl.conv3x3_bnl, kbnl.conv3x3_bnl_ref):
        ins = [_t(v, True) for v in (x, f, s, w)]
        y = fn(*ins)
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-4)
        y.backward(_t(cts[0]))
        _close_grads([t.grad.numpy() for t in ins], rgrads, fn.__name__)


def test_kernel_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card raises, as a malformed call does."""
    x = torch.zeros((1, 4, 8, 8), device="meta")
    w = torch.zeros((3, 3, 4, 4), device="meta")
    v = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kbc.chain_conv_plain(x, w)
    with pytest.raises(ValueError, match="no kernel"):
        kbnl.conv3x3_bnl(x, v, v, w)
    with pytest.raises(ValueError, match="3,3,Cin,Cout"):
        kbc.chain_conv_plain(torch.zeros((1, 4, 8, 8)),
                             torch.zeros((3, 3, 5, 4)))


# -------------------------------------------------------------- ConvBlock
def _block_vars(cin, cout, seed):
    """JAX ConvBlock variables from numpy: seeded conv kernels and biases,
    BN scale/bias and running stats away from their defaults."""
    rng = np.random.default_rng(seed)

    def conv(ci):
        return {"kernel": (rng.standard_normal((3, 3, ci, cout))
                           / np.sqrt(9 * ci)).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(cout)).astype(np.float32)}

    def bn():
        return {"scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(cout)).astype(np.float32)}

    def stats():
        return {"mean": (0.1 * rng.standard_normal(cout)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}

    return {"params": {"Conv_0": conv(cin), "BatchNorm_0": bn(),
                       "Conv_1": conv(cout), "BatchNorm_1": bn()},
            "batch_stats": {"BatchNorm_0": stats(), "BatchNorm_1": stats()}}


def _block_state_dict(v):
    names = {"Conv_0": "0", "BatchNorm_0": "1", "Conv_1": "4",
             "BatchNorm_1": "5"}
    sd = {}
    for k, p in v["params"].items():
        pre = f"conv_conv.{names[k]}"
        if "kernel" in p:
            sd[f"{pre}.weight"] = _t(p["kernel"].transpose(3, 2, 0, 1).copy())
            sd[f"{pre}.bias"] = _t(p["bias"])
        else:
            sd[f"{pre}.weight"], sd[f"{pre}.bias"] = (_t(p["scale"]),
                                                      _t(p["bias"]))
    for k, st in v["batch_stats"].items():
        pre = f"conv_conv.{names[k]}"
        sd[f"{pre}.running_mean"] = _t(st["mean"])
        sd[f"{pre}.running_var"] = _t(st["var"])
        sd[f"{pre}.num_batches_tracked"] = torch.tensor(0)
    return sd


@pytest.mark.parametrize("backend,rate", [("chain", 0.3), ("fused", 0.0)])
def test_convblock_matches_jax(gates_open, backend, rate):
    """The port's chain / fused ConvBlock against JAX's
    ConvBlock(conv_backend=...): the train-mode output and the running
    stats it leaves, then the eval-mode output. The chain block's dropout
    seed is fixed on the JAX side (its `_kernel_seed`) and handed to the
    port, so both draw the same position-hash mask."""
    from uaps_tpu.models.unet import ConvBlock as JaxConvBlock
    from uaps_tpu.ops import perturbations as jpert
    gates_open.setattr(jpert, "_kernel_seed", lambda key: jnp.int32(SEED))
    v = _block_vars(CIN, COUT, 5)
    x = np.random.default_rng(6).standard_normal(
        (B, CIN, H, W)).astype(np.float32)
    jb = JaxConvBlock(COUT, rate, jnp.float32, "nchw", conv_backend=backend)
    ry, mut = jb.apply(v, jnp.asarray(x), train=True,
                       mutable=["batch_stats"],
                       rngs={"dropout": jax.random.key(0)})
    rev = jb.apply(v, jnp.asarray(x), train=False)

    pb = tunet.ConvBlock(CIN, COUT, rate, torch.float32, True,
                         conv_backend=backend)
    assert isinstance(pb.conv_conv[1], tunet.BNFactorShift)
    pb.load_state_dict(_block_state_dict(v), strict=True)
    with torch.no_grad():
        ev = pb.eval()(_t(x))     # before train mode moves the BN stats
        y = pb.train()(_t(x), torch.tensor(SEED))
    np.testing.assert_allclose(y.numpy(), ry, rtol=1e-5, atol=1e-5)
    for k, stats in mut["batch_stats"].items():
        i = "1" if k == "BatchNorm_0" else "5"
        bn = pb.conv_conv[int(i)]
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(ev.numpy(), rev, rtol=1e-5, atol=1e-5)
    if rate:   # the seed reached the mask
        with torch.no_grad():
            other = pb.train()(_t(x), torch.tensor(SEED + 1))
        assert np.abs(other.numpy() - ry).max() > 1e-2


# ------------------------------------------------------------------ a step
def _jax_chain_model(dtype):
    return JaxMultiDecoderUNet(
        num_classes=4, perturbations=("none",), features=FEATURES,
        dropout=(0.0,) * 5, nchw_levels=2, conv_variant="dwmf",
        head_variant="dwmf", dtype=dtype, conv_backend="chain")


def _port_chain_model(variables, dtype):
    m = tunet.MultiDecoderUNet(4, ("none",), 3, dtype, nchw_levels=2,
                               conv_backend="chain", head_variant="dwmf",
                               features=FEATURES, dropout=(0.0,) * 5)
    return load_jax_params(m, variables["params"], variables["batch_stats"])


@pytest.fixture(scope="module")
def chain_step():
    """One UAPS step past the ramp (w1 = w2 = 0.1) of the D = 2 chain model
    on each side, f64 activations, from the same seeded weights, batch and
    mix_w (the deterministic recipe of ROADMAP.md)."""
    from uaps_tpu_torch.utils.config import preset as port_preset
    cfgs = []
    for cfg in (neu_config("uaps", "float32"),
                port_preset("neu", method="uaps")):
        cfg.model = dataclasses.replace(cfg.model, compute_dtype="float32",
                                        n_aux=1, conv_backend="chain")
        cfg.data = dataclasses.replace(cfg.data, image_size=HW, batch_size=B)
        cfgs.append(cfg)
    cfg, pcfg = cfgs
    v0 = seeded_variables(_jax_chain_model(jnp.float32), HW, 31)
    rng = np.random.default_rng(9)
    batch = {"image": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "uimage": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "label": rng.integers(0, 4, (B, *HW)).astype(np.int32),
             "mix_w": np.asarray([0.7, 0.3], np.float32)}
    start = int(cfg.method.ramp_iters * cfg.method.consistency_rampup)
    with jax.enable_x64(True):
        tx = jbase.make_optimizer(cfg.optim)
        step = jit(juaps.make_train_step(
            cfg, _jax_chain_model(jnp.float64), tx))
        state = jbase.TrainState(
            step=jnp.asarray(start, jnp.int32), params=v0["params"],
            batch_stats=v0["batch_stats"], opt_state=tx.init(v0["params"]),
            key=jax.random.key(0))
        new, jm = step(state, batch)
        jgrad = jax_sd(new.opt_state.inner_state[0].mu)
        jgrad = {k: g / (1 - cfg.optim.b1) for k, g in jgrad.items()}
        jout = ({k: float(v) for k, v in jm.items()},
                jax_sd(new.params, new.batch_stats))
    with pytest.MonkeyPatch.context() as mp:
        open_gates(mp, HW[1])
        model = _port_chain_model(v0, torch.float64)
        pstate = base.init_model_state(pcfg, model)
        pstate.step = start
        _, pm = get_method("uaps").make_train_step(pcfg, model)(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        no_grad = {k for k, p in model.named_parameters() if p.grad is None}
        pout = ({k: float(v) for k, v in pm.items()},
                {k: v.detach().clone().numpy()
                 for k, v in model.state_dict().items()})
    return {"cfg": cfg, "v0": jax_sd(v0["params"]), "v0_tree": v0,
            "jax": jout,
            "port": pout, "jgrad": jgrad, "no_grad": no_grad}


def test_chain_uaps_step_matches_jax(chain_step):
    """Every metric, the params and the BN running stats after one chain
    UAPS step past the ramp (Adam, lr 1e-3); the chain blocks' conv biases
    have no gradient in the port, an exact zero in JAX, and stay put on
    both sides."""
    (jm, jsd), (pm, psd) = chain_step["jax"], chain_step["port"]
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, err_msg=k)
    assert jm["consistency_w1"] == pytest.approx(0.1)
    jparams = {k: v for k, v in jsd.items() if "running" not in k}
    check_params(jparams, psd, chain_step["jgrad"], 1,
                 chain_step["cfg"].optim.base_lr, 2e-6, noise=1e-5)
    for k, sj in running(jsd).items():
        np.testing.assert_allclose(psd[k], sj, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    # level 0 and 1 blocks of the encoder and of both decoders
    chain_biases = {k for k in chain_step["v0"]
                    if k.endswith(("conv_conv.0.bias", "conv_conv.4.bias"))
                    and ("in_conv" in k or "down1." in k or "up3." in k
                         or "up4." in k)}
    assert len(chain_biases) == 12
    assert chain_step["no_grad"] == chain_biases
    for k in chain_biases:
        assert np.all(chain_step["jgrad"][k] == 0), k
        np.testing.assert_array_equal(jsd[k], chain_step["v0"][k])
        np.testing.assert_array_equal(psd[k], chain_step["v0"][k])


def test_chain_state_dict_from_jax_loads_strict(chain_step):
    """A JAX chain model's variable tree is the default model's, and
    state_dict_from_jax of it loads into the port's chain and fused models
    with strict=True."""
    from uaps_tpu.models.unet import MultiDecoderUNet
    chain = chain_step["v0_tree"]
    default = jax.eval_shape(lambda: MultiDecoderUNet(
        num_classes=4, perturbations=("none",), features=FEATURES,
        dropout=(0.0,) * 5, nchw_levels=2).init(
            {"params": jax.random.key(0)}, jnp.zeros((1, *HW, 3))))
    assert jax.tree.structure(chain) == jax.tree.structure(default)
    assert ([a.shape for a in jax.tree.leaves(chain)]
            == [s.shape for s in jax.tree.leaves(default)])
    _port_chain_model(chain, torch.float32)
    fused = tunet.MultiDecoderUNet(4, ("none",), 3, torch.float32,
                                   nchw_levels=2, conv_backend="fused",
                                   features=FEATURES, dropout=(0.0,) * 5)
    load_jax_params(fused, chain["params"], chain["batch_stats"])


# ---------------------------------------------------------------- routing
class _BwdCounts:
    """Counts block_conv._backward calls as plain or bnl backwards."""

    def __init__(self, mp, counts):
        fn = kbc._backward

        def counted(g, ds1, ds2, y, x, f, *a):
            key = "chain_bnl_bwd" if f is not None else "chain_plain_bwd"
            counts.n[key] = counts.n.get(key, 0) + 1
            return fn(g, ds1, ds2, y, x, f, *a)
        mp.setattr(kbc, "_backward", counted)


ROUTES = {
    "chain": {"chain_conv_plain": 20, "chain_conv_bnl": 20,
              "chain_plain_bwd": 20, "chain_bnl_bwd": 20,
              "conv3x3_nchw": 8, "conv3x3_nchw_dgrad": 8,
              "conv3x3_nchw_wgrad": 8, "max_pool_2x2_nchw": 4,
              "max_pool_2x2_nchw_bwd": 4, "ce_dice_stats": 8,
              "ce_dice_bwd": 8, "_dropout": 32, "_noise": 20,
              "_fdrop_fwd": 10, "_fdrop_bwd": 10, "uncertainty_fwd": 1,
              "uncertainty_bwd": 1},
    "fused": {"conv3x3_bnl": 16, "conv3x3_bnl_bwd": 16,
              "conv3x3_nchw": 32, "conv3x3_nchw_dgrad": 30,
              "conv3x3_nchw_wgrad": 32, "max_pool_2x2_nchw": 4,
              "max_pool_2x2_nchw_bwd": 4, "ce_dice_stats": 8,
              "ce_dice_bwd": 8, "_dropout": 40, "_noise": 20,
              "_fdrop_fwd": 10, "_fdrop_bwd": 10, "uncertainty_fwd": 1,
              "uncertainty_bwd": 1},
}


@pytest.mark.parametrize("backend", ["chain", "fused"])
def test_uaps_step_routes_through_fused_blocks(gates_open, backend):
    """One CPU UAPS step of the neu unet_uaps (4 decoders, every
    perturbation and the encoder dropout on) with conv_backend=backend
    calls each kernel module as often as a GPU step launches it
    (chip_smoke.py CHAIN_STEP_LAUNCHES / FUSED_STEP_LAUNCHES)."""
    from uaps_tpu_torch.utils.config import preset as port_preset
    targets = [(tunet, "chain_conv_plain"), (tunet, "chain_conv_bnl"),
               (tunet, "conv3x3_nchw"), (tunet, "max_pool_2x2_nchw"),
               (kconv, "conv3x3_nchw_dgrad"), (kconv, "conv3x3_nchw_wgrad"),
               (kpool, "max_pool_2x2_nchw_bwd"), (kce, "ce_dice_stats"),
               (kce, "ce_dice_bwd"), (kpt, "_dropout"), (kpt, "_noise"),
               (kpt, "_fdrop_fwd"), (kpt, "_fdrop_bwd"),
               (kun, "uncertainty_fwd"), (kun, "uncertainty_bwd"),
               (tunet, "conv3x3_bnl")]
    open_gates(gates_open, HW[1])
    counts = Counts(gates_open, targets)
    _BwdCounts(gates_open, counts)
    bnl_bwd = kbnl._backward

    def bnl_counted(*a):
        counts.n["conv3x3_bnl_bwd"] = counts.n.get("conv3x3_bnl_bwd", 0) + 1
        return bnl_bwd(*a)
    gates_open.setattr(kbnl, "_backward", bnl_counted)
    cfg = port_preset("neu", method="uaps")
    cfg.model = dataclasses.replace(cfg.model, conv_backend=backend)
    cfg.data = dataclasses.replace(cfg.data, image_size=HW, batch_size=B)
    method = get_method("uaps")
    state, model = method.init_state(cfg, "cpu")
    rng = np.random.default_rng(9)
    batch = {"image": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "uimage": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "label": rng.integers(0, 4, (B, *HW)).astype(np.int32)}
    state, m = method.make_train_step(cfg, model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite([float(v) for v in m.values()]).all()
    assert counts.n == ROUTES[backend]
