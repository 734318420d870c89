"""The port's UAPS slice against the JAX package on the CPU: the fused
uncertainty module against the Pallas kernel (interpret mode), the
perturbation applies against `uaps_tpu.ops.perturbations` given JAX's own
draws, the port's generator contracts, `fused_dropout` and
`fused_feature_noise` at every element of ragged counts and an offset view
(the noise against the CUDA kernel's vector draw), the KL / MSE losses and
the ramps, the perturbed multi-decoder forward, 1 and 3 UAPS steps, one
step of the unfused route (fused_uncertainty=False, through the
pseudo-label module) with the MTiles loss terms and fused_batch,
`InferenceEngine.uncertainty`, the routing of one step through the kernel
modules, and the Trainer.

The deterministic recipe (ROADMAP.md): perturbations "none" and dropout 0
on both sides, the same seeded f32 weights (tests/_torch_port_util.py), the
same numpy batches and a fixed `batch["mix_w"]`, 2 + 2 images of 16 x 128
at narrow widths. The step is compared with f64 activations, as the
baseline step is (tests/test_torch_port_train.py says why), with one
auxiliary decoder (D = 2): the JAX step's compile time grows with the
decoder count (~14 s at D = 2, ~20 s at D = 4 on an 8-core CPU), and the
per-decoder code is the same loop for any D; the forward test, the routing
test and chip_smoke.py run D = 4. On the port side the kernel shape gates
are opened, so the step runs through the kernel modules (their plain
versions on the CPU), as it does on the GPU; JAX on the CPU takes its plain
ops, so the two routes are held to each other too.

Tolerances: the uncertainty module against the Pallas kernel var rtol 1e-5,
pseudo exact, dlogits rtol 1e-5 / atol 1e-6 (f32, the same formula summed
in another order); applies exact (f32: the same IEEE operations); the
forward as the baseline's (logits rtol 1e-3 / atol 1e-4, BN stats rtol 1e-4
/ atol 1e-5); metrics rtol 1e-5 after one step, 1e-4 after three; params
and BN stats as tests/test_torch_port_train.py holds them, but for params
after 3 steps past the ramp at atol 5e-5: there the pseudo-label and
uncertainty terms weigh 0.1, and where an element's gradient changes sign
from step to step (measured: gradients of 1e-3 of the largest that flip)
Adam's m / sqrt(v) magnifies the packages' gradient differences of steps 2
and 3, which follow the ~1e-6 parameter differences of step 1 (the largest
difference measured, 2.9e-5 = 0.03 lr, on 2 of 2304 elements of one conv).
"""
import dataclasses
import functools

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
from uaps_tpu_torch import dispatch
from uaps_tpu_torch.kernels import ce_dice as kce
from uaps_tpu_torch.kernels import conv3x3_nchw as kconv
from uaps_tpu_torch.kernels import perturb as kpt
from uaps_tpu_torch.kernels import pool_nchw as kpool
from uaps_tpu_torch.kernels import pseudo_label as kpl
from uaps_tpu_torch.kernels import uncertainty as kun
from uaps_tpu_torch.methods import base, build_model, get_method
from uaps_tpu_torch.methods import uaps as puaps
from uaps_tpu_torch.models import unet as tunet
from uaps_tpu_torch.ops import perturbations as pops
from uaps_tpu_torch.utils.weights import load_jax_params

HW = (16, 128)
B = 2
FEATURES = (4, 8, 16, 32, 64)
STEPS = 3
MIX_W = {2: [0.7, 0.3], 4: [0.4, 0.3, 0.2, 0.1]}


def _jax_model(n_aux, dtype):
    return JaxMultiDecoderUNet(
        num_classes=4, perturbations=("none",) * n_aux, features=FEATURES,
        dropout=(0.0,) * 5, nchw_levels=2, conv_variant="dwmf",
        head_variant="dwmf", dtype=dtype)


def _port_model(n_aux, variables, dtype):
    m = tunet.MultiDecoderUNet(4, ("none",) * n_aux, 3, dtype, nchw_levels=2,
                               head_variant="dwmf", features=FEATURES,
                               dropout=(0.0,) * 5)
    return load_jax_params(m, variables["params"], variables["batch_stats"])


def _cfgs(n_aux):
    """The same UAPS config from each package's preset."""
    from uaps_tpu_torch.utils.config import preset as port_preset
    out = []
    for cfg in (neu_config("uaps", "float32"),
                port_preset("neu", method="uaps")):
        cfg.model = dataclasses.replace(cfg.model, compute_dtype="float32",
                                        n_aux=n_aux)
        cfg.data = dataclasses.replace(cfg.data, image_size=HW,
                                       batch_size=B)
        out.append(cfg)
    return out


def _batches(n_dec):
    rng = np.random.default_rng(9)
    return [{"image": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "uimage": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "label": rng.integers(0, 4, (B, *HW)).astype(np.int32),
             "mix_w": np.asarray(MIX_W[n_dec], np.float32)}
            for _ in range(STEPS)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture
def gates_open(monkeypatch):
    """The kernel shape gates opened (`open_gates`), so that the port
    routes its level-0/1 convs and pools through the kernel modules at test
    sizes."""
    open_gates(monkeypatch, HW[1])
    return monkeypatch


# ----------------------------------------------------------- uncertainty
def test_fused_uncertainty_matches_pallas():
    """var, pseudo and dlogits of the port's module (its plain versions on
    the CPU; logits as NHWC views of NCHW storage, as the model hands them
    over) against the Pallas kernel in interpret mode and its oracle."""
    from uaps_tpu.pallas.uncertainty import (_reference_impl,
                                             fused_uncertainty)
    rng = np.random.default_rng(3)
    lg = (rng.standard_normal((4, 2, 8, 128, 4)) * 3).astype(np.float32)
    w = np.asarray([0.4, 0.3, 0.2, 0.1], np.float32)
    g = rng.standard_normal((4, 2, 8, 128)).astype(np.float32)

    def pallas(x):   # (var, pseudo as aux)
        return fused_uncertainty(x, jnp.asarray(w), force_pallas=True)

    @jit
    def jax_side(x, gv):
        var, vjp, ps = jax.vjp(pallas, x, has_aux=True)
        return var, ps, vjp(gv)[0], _reference_impl(x, jnp.asarray(w))

    jvar, jps, jdx, (rvar, rps) = jax_side(jnp.asarray(lg), jnp.asarray(g))

    nchw = [torch.from_numpy(np.ascontiguousarray(lg[d].transpose(0, 3, 1, 2)))
            .requires_grad_() for d in range(4)]
    views = [t.permute(0, 2, 3, 1) for t in nchw]
    before = (kun.fwd_launches, kun.bwd_launches)
    pvar, pps = kun.fused_uncertainty(views, torch.from_numpy(w))
    pvar.backward(torch.from_numpy(g))
    assert pps.dtype == torch.int32 and pps.is_contiguous()
    assert not pps.requires_grad
    for ref in (jvar, rvar):
        np.testing.assert_allclose(pvar.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pps.numpy(), np.asarray(jps))
    np.testing.assert_array_equal(pps.numpy(), np.asarray(rps))
    pdx = np.stack([t.grad.numpy().transpose(0, 2, 3, 1) for t in nchw])
    np.testing.assert_allclose(pdx, np.asarray(jdx), rtol=1e-5, atol=1e-6)
    assert (kun.fwd_launches, kun.bwd_launches) == before


# ----------------------------------------------------------- perturbations
@pytest.mark.parametrize("kind", ["feature_noise", "dropout",
                                  "feature_dropout"])
def test_perturbation_apply_matches_jax(kind):
    """The port's apply given JAX's own draw equals the JAX perturbation
    exactly (f32, NCHW features, channel axis 1)."""
    from uaps_tpu.ops import perturbations as jpert
    x = np.random.default_rng(4).standard_normal(
        (2, 8, 16, 128)).astype(np.float32)
    key = jax.random.key(11)
    xt = torch.from_numpy(x)
    if kind == "feature_noise":
        ref = jpert.feature_noise(key, jnp.asarray(x))
        noise = jax.random.uniform(key, x.shape[1:], minval=-0.3,
                                   maxval=0.3)
        got = pops.feature_noise_apply(xt, torch.from_numpy(
            np.asarray(noise)))
    elif kind == "dropout":
        ref = jpert.dropout(key, jnp.asarray(x), 0.5)
        keep = jax.random.bernoulli(key, 0.5, x.shape)
        got = pops.dropout_apply(xt, torch.from_numpy(np.asarray(keep)),
                                 0.5)
    else:
        ref = jpert.feature_dropout(key, jnp.asarray(x), channel_axis=1)
        scale = jax.random.uniform(key, (), minval=0.7, maxval=0.9)
        got = pops.feature_dropout_apply(xt, torch.tensor(float(scale)))
        assert 0 < float((got == 0).float().mean()) < 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _grouped_mean_spec(x, group=8):
    """The attention's order in numpy f32: s_k = the in-order sum of
    channels group * k, ..., then ((s_0 + s_1) + s_2) + ..., times
    f32(1 / C)."""
    c = x.shape[1]
    att = None
    for k0 in range(0, c, group):
        s = np.zeros(x[:, 0].shape, np.float32)
        for k in range(k0, min(k0 + group, c)):
            s = s + x[:, k]
        att = s if att is None else att + s
    return att * np.float32(1 / c)


def _fdrop_input(c, seed=21):
    """[2, C, 4, 8] f32 of magnitudes 1e-4 .. 1e4, where the order of an
    f32 channel sum changes its bits."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, c, 4, 8)) * 10.0 ** rng.uniform(-4, 4,
                                                                 (2, c, 4, 8))
    return x.astype(np.float32)


@pytest.mark.parametrize("c", [3, 8, 13, 64, 256])
def test_channel_mean_grouped_order(c):
    """kpt.channel_mean, the order that the CUDA attention pass sums in
    (csrc/perturb.cu fdrop_att_kernel), equals its numpy spec bit for bit;
    for C <= 8 that is the sum in channel order, above it the order
    matters on these inputs (the sum in channel order differs)."""
    x = _fdrop_input(c)
    got = kpt.channel_mean(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _grouped_mean_spec(x))
    in_order = _grouped_mean_spec(x, group=c)
    if c <= kpt.FDROP_GROUP:
        np.testing.assert_array_equal(got, in_order)
    else:
        assert (got != in_order).any()


@pytest.mark.parametrize("c", [64, 256])
def test_feature_dropout_apply_matches_jax_wide(c):
    """At C > 8 (the grouped order) the port's apply given JAX's own scale
    equals `uaps_tpu.ops.perturbations.feature_dropout` (f32, NCHW,
    channel axis 1) at every pixel whose attention is not within 1e-6 of
    the threshold, relative: there the two packages' channel sums, taken
    in other orders (~1e-7 relative apart), may round the compare apart."""
    from uaps_tpu.ops import perturbations as jpert
    x = np.random.default_rng(c).standard_normal(
        (2, c, 16, 32)).astype(np.float32)
    key = jax.random.key(12)
    ref = np.asarray(jpert.feature_dropout(key, jnp.asarray(x),
                                           channel_axis=1))
    scale = jax.random.uniform(key, (), minval=0.7, maxval=0.9)
    got = pops.feature_dropout_apply(torch.from_numpy(x),
                                     torch.tensor(float(scale))).numpy()
    att = kpt.channel_mean(torch.from_numpy(x)).numpy()
    thr = att.reshape(2, -1).max(1) * np.float32(scale)
    near = (np.abs(att - thr[:, None, None])
            <= 1e-6 * np.abs(thr)[:, None, None])
    far = np.broadcast_to(~near[:, None], x.shape)
    np.testing.assert_array_equal(got[far], ref[far])
    assert near.mean() < 0.01
    assert 0 < float((got[:, 0] == 0).mean()) < 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feature_dropout_backward_from_saved_attention(dtype):
    """Autograd through fused_feature_dropout on the CPU (C = 13: two
    channel groups) saves the attention, the maxima and the seed, not x,
    and gives feature_dropout_bwd_plain(x, g, seed), the mask regenerated
    from x, exactly; the forward is feature_dropout_plain exactly."""
    x = torch.from_numpy(_fdrop_input(13, seed=22)).to(dtype)
    g = torch.from_numpy(np.random.default_rng(23).standard_normal(
        x.shape).astype(np.float32)).to(dtype)
    sd = torch.tensor(2 ** 31 - 5)
    xr = x.clone().requires_grad_()
    y = kpt.fused_feature_dropout(xr, sd)
    assert [tuple(t.shape) for t in y.grad_fn.saved_tensors] == [
        (2, 4, 8), (2,), ()]
    y.backward(g)
    assert torch.equal(y.detach(), kpt.feature_dropout_plain(x, sd))
    assert torch.equal(xr.grad, kpt.feature_dropout_bwd_plain(x, g, sd))
    assert xr.grad.dtype == dtype
    assert 0 < float((xr.grad[:, 0] == 0).float().mean()) < 1


def test_fdrop_group_matches_c_source():
    """The attention's group width: csrc/perturb.cu kGroup equals
    kernels/perturb.py FDROP_GROUP."""
    import re
    from pathlib import Path
    src = (Path(kpt.__file__).resolve().parent.parent / "csrc"
           / "perturb.cu").read_text()
    (width,) = re.findall(r"^constexpr int kGroup = (\d+);", src, re.M)
    assert int(width) == kpt.FDROP_GROUP == 8


def _bits_spec(seed, i):
    """The generator's definition in Python integers."""
    def mix32(v):
        v ^= v >> 16
        v = (v * 0x7FEB352D) & 0xFFFFFFFF
        v ^= v >> 15
        v = (v * 0x846CA68B) & 0xFFFFFFFF
        return v ^ (v >> 16)
    s = seed & 0xFFFFFFFF
    return mix32((mix32(i ^ mix32(s ^ 0x9E3779B9)) + s) & 0xFFFFFFFF)


def test_generator_contracts():
    """The port's counter-based generator: its definition; dropout's zero
    share, scale, per-example masks and determinism; noise shared across
    the batch in [-r, r); feature dropout's threshold in [0.7, 0.9] x max;
    each backward regenerating its forward's mask; and the plain ops of
    conv_backend="xla" drawing what the kernel modules draw."""
    idx = [0, 1, 2, 12345, 2 ** 31 + 7, 2 ** 32 - 1]
    for seed in (0, 5, 2 ** 31 - 2):
        got = kpt.random_bits(torch.tensor(seed), torch.tensor(idx))
        assert got.tolist() == [_bits_spec(seed, i) for i in idx]
    sd = torch.tensor(7)
    ones = torch.ones((4, 8, 16, 128))
    out = kpt.fused_dropout(ones, sd, 0.5)
    assert abs(float((out == 0).float().mean()) - 0.5) < 0.01
    assert bool((out[out != 0] == 2.0).all())
    assert not torch.equal(out[0], out[1])
    assert torch.equal(out, kpt.fused_dropout(ones, torch.tensor(7), 0.5))
    assert not torch.equal(out, kpt.fused_dropout(ones, torch.tensor(8),
                                                  0.5))
    u = kpt.fused_feature_noise(ones, sd) - 1.0
    nz = kpt.noise_draw(sd, ones.shape[1:])
    assert float(nz.min()) >= -0.3 and float(nz.max()) < 0.3
    assert abs(float(u.mean())) < 0.01
    assert all(torch.equal(u[0], u[b]) for b in range(1, 4))

    x = torch.from_numpy(np.abs(np.random.default_rng(5).standard_normal(
        (3, 8, 16, 128))).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 8, 16, 128)).astype(np.float32))
    att = kpt.channel_mean(x)
    torch.testing.assert_close(att, x.mean(1), rtol=1e-6, atol=0)
    y = kpt.fused_feature_dropout(x, sd)
    scale = float(kpt.fdrop_scale(sd))
    assert 0.7 <= scale <= 0.9
    for b in range(3):
        kept = y[b, 0] != 0
        mx = float(att[b].max())
        assert float(att[b][kept].max()) < scale * mx <= float(
            att[b][~kept].min())
        assert torch.equal(y[b][:, kept], x[b][:, kept])

    for kind, fn in [("dropout", lambda v: kpt.fused_dropout(v, sd, 0.3)),
                     ("feature_noise",
                      lambda v: kpt.fused_feature_noise(v, sd)),
                     ("feature_dropout",
                      lambda v: kpt.fused_feature_dropout(v, sd))]:
        xr = x.clone().requires_grad_()
        y = fn(xr)
        y.backward(g)
        assert torch.equal(y == 0, xr.grad == 0), kind
        if kind != "dropout":   # the perturbation dropout's rate is 0.5
            plain = pops.perturb_features([sd], [x], kind, "xla")[0]
            assert torch.equal(plain, y.detach()), kind
    assert torch.equal(pops.dropout(sd, x), kpt.fused_dropout(x, sd))
    assert pops.perturb_features([sd], [x], "none") == [x]
    with pytest.raises(ValueError, match="perturbation kind"):
        pops.perturb_features([sd], [x], "bogus")


@pytest.mark.parametrize("case", ["n=8k", "n=8k+1", "n=8k+7", "offset"])
def test_fused_dropout_every_element(case):
    """fused_dropout against the generator's definition at every element,
    at counts that leave the CUDA kernel's 16-byte vectors (8 bf16, 4 f32
    elements) a scalar tail of 0, 1 and 7 elements, and on a view one
    element past its storage's start (a misaligned pointer on the card):
    element i is kept when _bits_spec(seed, i) < round(0.7 * 2^32), as
    f32(x * f32(1 / 0.7)), else 0; the backward zeroes the same elements of
    the cotangent and scales the rest alike."""
    rate, seed = 0.3, 2 ** 31 - 3
    n = {"n=8k": 8 * 37, "n=8k+1": 8 * 37 + 1, "n=8k+7": 8 * 37 + 7,
         "offset": 8 * 37}[case]
    rng = np.random.default_rng(12)
    base = rng.standard_normal(n + 1).astype(np.float32)
    gbase = rng.standard_normal(n + 1).astype(np.float32)
    lo = 1 if case == "offset" else 0
    xb = torch.from_numpy(base).requires_grad_()
    x = xb[lo:lo + n]
    g = torch.from_numpy(gbase)[lo:lo + n]
    assert x.storage_offset() == lo and g.storage_offset() == lo
    y = kpt.fused_dropout(x, torch.tensor(seed), rate)
    y.backward(g)
    threshold = round((1 - rate) * 2 ** 32)
    keep = np.array([_bits_spec(seed, i) < threshold for i in range(n)])
    scale = np.float32(1 / (1 - rate))
    np.testing.assert_array_equal(
        y.detach().numpy(), np.where(keep, base[lo:lo + n] * scale, 0))
    np.testing.assert_array_equal(
        xb.grad[lo:lo + n].numpy(), np.where(keep, gbase[lo:lo + n] * scale,
                                             0))
    assert 0 < keep.mean() < 1


def _bits_vec_spec(seed, i0, n):
    """The noise and dropout kernels' vector draw (csrc/perturb.cu
    bits_vec): bits(i0 + j) for j < n, i0 a multiple of n, with mix32's
    first xorshift of (i0 ^ key) shared by the vector."""
    def tail(v):
        v = (v * 0x7FEB352D) & 0xFFFFFFFF
        v ^= v >> 15
        v = (v * 0x846CA68B) & 0xFFFFFFFF
        return v ^ (v >> 16)

    def mix32(v):
        return tail(v ^ (v >> 16))
    s = seed & 0xFFFFFFFF
    t = i0 ^ mix32(s ^ 0x9E3779B9)
    h = t ^ (t >> 16)
    return [mix32((tail(h ^ j) + s) & 0xFFFFFFFF) for j in range(n)]


@pytest.mark.parametrize("case", ["n=8k", "n=8k+1", "n=8k+7", "offset"])
def test_fused_feature_noise_every_element(case):
    """fused_feature_noise against the CUDA kernel's draw at every element
    of 3 examples, at in-example counts that leave 0, 1 and 7 elements past
    the last 8-element vector, and on a view one element past its
    storage's start: element (b, j) is f32(x * f32(1 + f32(f32(u * 0.6) -
    0.3))), u = (bits >> 8) * 2^-24, where bits comes from the vector draw
    (_bits_vec_spec, 4 and 8 elements: the f32 and bf16 vectors) for j in
    a whole vector, else from the generator's definition; the same noise
    for every example, and the backward scales the cotangent alike."""
    seed, batch = 2 ** 31 - 5, 3
    n = {"n=8k": 8 * 37, "n=8k+1": 8 * 37 + 1, "n=8k+7": 8 * 37 + 7,
         "offset": 8 * 37}[case]
    for vec in (4, 8):
        bits = [_bits_spec(seed, j) for j in range(n)]
        for i0 in range(0, n - n % vec, vec):
            bits[i0:i0 + vec] = _bits_vec_spec(seed, i0, vec)
        assert bits == [_bits_spec(seed, j) for j in range(n)]
    u = (np.array(bits, np.int64) >> 8).astype(np.float32) * np.float32(
        2.0 ** -24)
    m = np.float32(1) + ((u * np.float32(0.6)) - np.float32(0.3))
    rng = np.random.default_rng(13)
    base = rng.standard_normal(batch * n + 1).astype(np.float32)
    gbase = rng.standard_normal(batch * n + 1).astype(np.float32)
    lo = 1 if case == "offset" else 0
    xb = torch.from_numpy(base).requires_grad_()
    x = xb[lo:lo + batch * n].view(batch, n)
    g = torch.from_numpy(gbase)[lo:lo + batch * n].view(batch, n)
    assert x.storage_offset() == lo
    y = kpt.fused_feature_noise(x, torch.tensor(seed))
    y.backward(g)
    np.testing.assert_array_equal(
        y.detach().numpy(), base[lo:lo + batch * n].reshape(batch, n) * m)
    np.testing.assert_array_equal(
        xb.grad[lo:lo + batch * n].numpy().reshape(batch, n),
        gbase[lo:lo + batch * n].reshape(batch, n) * m)


def test_losses_and_ramps_match_jax():
    """kl_divergence_map (values and the gradients of both arguments),
    symmetric_mse_loss, the three ramps and ramp_weight."""
    from uaps_tpu.methods.base import ramp_weight as jramp
    from uaps_tpu.ops import kl_divergence_map as jkl
    from uaps_tpu.ops import symmetric_mse_loss as jmse
    from uaps_tpu.ops import ramps as jramps
    from uaps_tpu_torch.ops import (cosine_rampdown, kl_divergence_map,
                                    linear_rampup, sigmoid_rampup,
                                    symmetric_mse_loss)
    rng = np.random.default_rng(8)
    lg = (rng.standard_normal((2, 8, 16, 4)) * 2).astype(np.float32)
    p = rng.dirichlet(np.ones(4), (2, 8, 16)).astype(np.float32)
    g = rng.standard_normal((2, 8, 16)).astype(np.float32)
    @jit
    def kl_vjp(a, b, gv):
        ref, vjp = jax.vjp(jkl, a, b)
        return ref, vjp(gv)

    ref, (jgl, jgp) = kl_vjp(jnp.asarray(lg), jnp.asarray(p),
                             jnp.asarray(g))
    tl = torch.from_numpy(lg).requires_grad_()
    tp = torch.from_numpy(p).requires_grad_()
    got = kl_divergence_map(tl, tp)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(symmetric_mse_loss(torch.from_numpy(lg), torch.from_numpy(p))),
        float(jmse(jnp.asarray(lg), jnp.asarray(p))), rtol=1e-6)
    for t in (0, 1, 37.5, 200, 250):
        for name, fn, T in (("sigmoid_rampup", sigmoid_rampup, 200.0),
                            ("linear_rampup", linear_rampup, 200.0),
                            ("cosine_rampdown", cosine_rampdown, 300.0),
                            ("sigmoid_rampup", sigmoid_rampup, 0)):
            np.testing.assert_allclose(
                float(fn(t, T)), float(getattr(jramps, name)(t, T)),
                rtol=1e-6, err_msg=f"{name}({t}, {T})")
    for step in (0, 79, 80, 8000, 16000, 20000):
        np.testing.assert_allclose(
            float(base.ramp_weight(0.1, step, 80, 200.0)),
            float(jramp(0.1, jnp.asarray(step), 80, 200.0)), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _variables(n_aux):
    """Seeded variables of the 4-decoder model; fewer aux decoders take the
    same tree without the last ones."""
    v = seeded_variables(_jax_model(3, jnp.float32), HW, 23)
    drop = {f"aux_decoder{i + 1}" for i in range(n_aux, 3)}
    return {col: {k: t for k, t in tree.items() if k not in drop}
            for col, tree in v.items()}


# --------------------------------------------------------------- forward
@pytest.fixture(scope="module")
def forwards():
    """JAX's 4-decoder forward, train mode (logits, new BN stats) and eval
    mode, at seeded weights, perturbations "none"."""
    jm = _jax_model(3, jnp.float32)
    v0 = _variables(3)
    x = np.random.default_rng(24).standard_normal(
        (B, *HW, 3)).astype(np.float32)

    rngs = {"perturb": jax.random.key(0)}

    @jit
    def both(v, xx):
        train, mut = jm.apply(v, xx, train=True, mutable=["batch_stats"],
                              rngs=rngs)
        return (train, mut["batch_stats"],
                jm.apply(v, xx, train=False, rngs=rngs))

    train, stats, ev = both(v0, jnp.asarray(x))
    return {"v0": v0, "x": x, "train": [np.asarray(o) for o in train],
            "stats": running(jax_sd(v0["params"], stats)),
            "eval": [np.asarray(o) for o in ev]}


def test_multi_decoder_forward_matches_jax(forwards):
    """The perturbed forward with perturbations "none": all 4 logits in
    train mode (and the BN running stats it leaves) and in eval mode."""
    model = _port_model(3, forwards["v0"], torch.float32)
    x = torch.from_numpy(forwards["x"])
    with torch.no_grad():
        ev = model.eval()(x)      # before train mode moves the BN stats
        train = model.train()(x)
        stats = running({k: v.numpy() for k, v in model.state_dict().items()})
    assert len(train) == len(ev) == 4
    for got, ref in zip(list(train) + list(ev),
                        forwards["train"] + forwards["eval"]):
        assert got.shape == ref.shape == (B, *HW, 4)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-4)
    assert set(stats) == set(forwards["stats"])
    for k, ref in forwards["stats"].items():
        np.testing.assert_allclose(stats[k], ref, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_engine_uncertainty_matches_jax(forwards):
    """InferenceEngine.uncertainty: the main decoder's KL map against the
    decoders' mean softmax, as uaps_tpu/serve.py computes it (its eval
    forward, perturbations "none")."""
    from uaps_tpu.ops import kl_divergence_map as jkl
    from uaps_tpu_torch.serve import InferenceEngine
    outs = [jnp.asarray(o) for o in forwards["eval"]]
    preds = sum(jax.nn.softmax(o, -1) for o in outs) / len(outs)
    ref = np.asarray(jkl(outs[0], preds))
    # the engine's model from the preset, then the narrow "none" model
    cfg = neu_config("uaps", "float32")
    engine = InferenceEngine(cfg, state_dict=build_model(cfg, "cpu")
                             .state_dict(), batch_size=B, device="cpu")
    engine.model = _port_model(3, forwards["v0"], torch.float32).eval()
    got = engine.uncertainty(forwards["x"][:1])   # one image, padded
    assert got.shape == (1, *HW) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref[:1], rtol=1e-3, atol=1e-5)


# ------------------------------------------------------------------ steps
@pytest.fixture(scope="module")
def uaps_runs():
    """JAX and port UAPS steps with f64 activations (D = 2), STEPS steps
    from step 0 and from the end of the ramp."""
    n_aux = 1
    cfg, pcfg = _cfgs(n_aux)
    v0 = _variables(n_aux)
    batches = _batches(1 + n_aux)
    ramp_end = int(cfg.method.ramp_iters * cfg.method.consistency_rampup)
    out = {"cfg": cfg, "jax": {}, "port": {}}
    with jax.enable_x64(True):
        jm = _jax_model(n_aux, jnp.float64)
        tx = jbase.make_optimizer(cfg.optim)
        step = jit(juaps.make_train_step(cfg, jm, tx))

        def same_types(new, old):
            # keep every float leaf at its starting dtype (x64 mode lifts
            # them to f64), so one compile serves every step
            return jax.tree.map(
                lambda n, o: n.astype(o.dtype)
                if jnp.issubdtype(o.dtype, jnp.floating) else n, new, old)

        for start in (0, ramp_end):
            state = jbase.TrainState(
                step=jnp.asarray(start, jnp.int32), params=v0["params"],
                batch_stats=v0["batch_stats"],
                opt_state=tx.init(v0["params"]), key=jax.random.key(0))
            runs, mus = [], []
            for b in batches:
                new, m = step(state, b)
                mus.append(jax_sd(new.opt_state.inner_state[0].mu))
                state = same_types(new, state)
                runs.append(({k: float(v) for k, v in m.items()},
                             jax_sd(state.params, state.batch_stats)))
            out["jax"][start] = runs
            # each step's gradient from Adam's first moment:
            # mu_t = b1 mu_(t-1) + (1 - b1) g_t
            b1 = cfg.optim.b1
            out.setdefault("jax_grads", {})[start] = [
                {k: (mu[k] - (b1 * prev[k] if prev else 0)) / (1 - b1)
                 for k in mu}
                for mu, prev in zip(mus, [None] + mus[:-1])]

    with pytest.MonkeyPatch.context() as mp:
        open_gates(mp, HW[1])
        for start in (0, ramp_end):
            model = _port_model(n_aux, v0, torch.float64)
            state = base.init_model_state(pcfg, model)
            state.step = start
            pstep = get_method("uaps").make_train_step(pcfg, model)
            runs = []
            for b in batches:
                state, m = pstep(state, _torch_batch(b))
                runs.append(({k: float(v) for k, v in m.items()},
                             {k: v.detach().clone().numpy()
                              for k, v in model.state_dict().items()}))
            out["port"][start] = runs
            assert state.step == start + STEPS
            # the K-step function of a dispatch (uaps_tpu_torch/dispatch.py:
            # the function a CUDA graph captures), on the first K batches
            for k in (2, STEPS):
                model = _port_model(n_aux, v0, torch.float64)
                state = base.init_model_state(pcfg, model)
                state.step = start
                stacked = {name: torch.from_numpy(np.stack(
                    [b[name] for b in batches[:k]])) for name in batches[0]}
                state, m = dispatch.run_steps(
                    get_method("uaps").make_train_step(pcfg, model), state,
                    lambda i: {name: v[i] for name, v in stacked.items()}, k)
                out.setdefault("port_k", {})[start, k] = (
                    {name: v.numpy() for name, v in m.items()},
                    {name: v.detach().clone().numpy()
                     for name, v in model.state_dict().items()},
                    state.step, int(state.counter))
    return out


@pytest.mark.parametrize("start", ["step 0", "past the ramp"])
@pytest.mark.parametrize("n_steps", [1, STEPS])
def test_uaps_steps_match_jax(uaps_runs, start, n_steps):
    """Every metric of every step, then the params and BN stats after
    `n_steps` UAPS steps (Adam, lr 1e-3), from step 0 (w1 = w2 = 0.1 e^-5)
    and from the end of the ramp (w1 = w2 = 0.1, where the pseudo-label and
    uncertainty gradients weigh in)."""
    cfg = uaps_runs["cfg"]
    s0 = (0 if start == "step 0" else
          int(cfg.method.ramp_iters * cfg.method.consistency_rampup))
    lr = cfg.optim.base_lr
    rtol = 1e-5 if n_steps == 1 else 1e-4
    jruns, pruns = uaps_runs["jax"][s0], uaps_runs["port"][s0]
    for i in range(n_steps):
        jm, pm = jruns[i][0], pruns[i][0]
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=rtol,
                                       err_msg=f"step {i + 1} {k}")
    if s0:
        assert jruns[0][0]["consistency_w1"] == pytest.approx(0.1)
    _, jsd = jruns[n_steps - 1]
    _, psd = pruns[n_steps - 1]
    jparams = {k: v for k, v in jsd.items() if "running" not in k}
    # past the ramp, 3 steps: atol 5e-5 (measured 2.9e-5 on 2 of the 2304
    # elements of one conv; see the module docstring)
    atol = 2e-6 if n_steps == 1 else 2e-5 if s0 == 0 else 5e-5
    check_params(jparams, psd, uaps_runs["jax_grads"][s0][0], n_steps, lr,
                 atol)
    for k, sj in running(jsd).items():
        np.testing.assert_allclose(
            psd[k], sj, rtol=1e-4,
            atol=1e-5 if n_steps == 1 or k.endswith("var") else 2 * lr,
            err_msg=k)


@pytest.mark.parametrize("start", ["step 0", "past the ramp"])
@pytest.mark.parametrize("k", [2, STEPS])
def test_k_step_function_matches_jax(uaps_runs, start, k):
    """dispatch.run_steps, K UAPS steps in one call with [K] metrics (what
    a CUDA graph of a dispatch captures): every step's metrics against
    JAX's sequential steps, then the params and BN stats after K steps, at
    test_uaps_steps_match_jax's tolerances for more than one step; equal
    bit for bit to the port's sequential steps; the host step count and
    the device counter advanced by K."""
    cfg = uaps_runs["cfg"]
    s0 = (0 if start == "step 0" else
          int(cfg.method.ramp_iters * cfg.method.consistency_rampup))
    lr = cfg.optim.base_lr
    metrics, psd, step, counter = uaps_runs["port_k"][s0, k]
    jruns, pruns = uaps_runs["jax"][s0], uaps_runs["port"][s0]
    assert step == counter == s0 + k
    assert set(metrics) == set(jruns[0][0])
    for name, v in metrics.items():
        assert v.shape == (k,), name
        for i in range(k):
            np.testing.assert_allclose(v[i], jruns[i][0][name], rtol=1e-4,
                                       err_msg=f"step {i + 1} {name}")
            assert v[i] == np.float32(pruns[i][0][name]), (name, i)
    _, jsd = jruns[k - 1]
    jparams = {n: v for n, v in jsd.items() if "running" not in n}
    check_params(jparams, psd, uaps_runs["jax_grads"][s0][0], k, lr,
                 2e-5 if s0 == 0 else 5e-5)
    for n, sj in running(jsd).items():
        np.testing.assert_allclose(
            psd[n], sj, rtol=1e-4,
            atol=1e-5 if n.endswith("var") else 2 * lr, err_msg=n)
    for n, v in pruns[k - 1][1].items():
        np.testing.assert_array_equal(psd[n], v, err_msg=n)


def test_device_ramp_weight_matches_jax():
    """base.ramp_weight on the state's device counter (a 0-d int64 tensor)
    against JAX's ramp_weight on its int32 step, either side of ramp_iters
    boundaries and past the ramp: a 0-d f32 tensor on the counter's
    device; TrainState.tick advances the counter and the host count."""
    from uaps_tpu.methods.base import ramp_weight as jramp
    state = base.TrainState(0, None, None,
                            torch.zeros((), dtype=torch.int64))
    for step in (0, 1, 79, 80, 81, 159, 160, 8000, 15999, 16000, 20000):
        state.step = step
        got = base.ramp_weight(0.1, state.counter, 80, 200.0)
        assert got.shape == () and got.dtype == torch.float32
        assert got.device == state.counter.device
        np.testing.assert_allclose(
            float(got), float(jramp(0.1, jnp.asarray(step, jnp.int32), 80,
                                    200.0)), rtol=1e-6, err_msg=str(step))
    state.step = 79
    state.tick()
    assert state.step == int(state.counter) == 80
    state.advance(3)
    assert (state.step, int(state.counter)) == (83, 80)
    assert float(base.ramp_weight(0.1, state.counter, 80, 0)) == \
        pytest.approx(0.1)


@pytest.fixture(scope="module")
def unfused_run():
    """One UAPS step past the ramp (D = 2, f64) of the route that takes the
    fused pseudo-label module on the kernel path (fused_uncertainty=False)
    with the MTiles loss shape (decoder_consistency_weight=0.1,
    unramped_uncertainty) and fused_batch, in each package: one JAX
    compile. JAX on the CPU takes its plain ops for every route, so its
    step is the reference of the port's kernel-module route."""
    n_aux = 1
    cfg, pcfg = _cfgs(n_aux)
    knobs = dict(fused_uncertainty=False, decoder_consistency_weight=0.1,
                 unramped_uncertainty=True, fused_batch=True)
    cfg.method = dataclasses.replace(cfg.method, **knobs)
    pcfg.method = dataclasses.replace(pcfg.method, **knobs)
    v0 = _variables(n_aux)
    batch = _batches(1 + n_aux)[0]
    ramp_end = int(cfg.method.ramp_iters * cfg.method.consistency_rampup)
    with jax.enable_x64(True):
        jm = _jax_model(n_aux, jnp.float64)
        tx = jbase.make_optimizer(cfg.optim)
        state = jbase.TrainState(
            step=jnp.asarray(ramp_end, jnp.int32), params=v0["params"],
            batch_stats=v0["batch_stats"], opt_state=tx.init(v0["params"]),
            key=jax.random.key(0))
        new, m = jit(juaps.make_train_step(cfg, jm, tx))(state, batch)
        jax_out = ({k: float(v) for k, v in m.items()},
                   jax_sd(new.params, new.batch_stats),
                   {k: g / (1 - cfg.optim.b1) for k, g in jax_sd(
                       new.opt_state.inner_state[0].mu).items()})
    with pytest.MonkeyPatch.context() as mp:
        open_gates(mp, HW[1])
        calls = Counts(mp, [(kpl, "pseudo_label_plain"),
                            (kun, "uncertainty_fwd")])
        model = _port_model(n_aux, v0, torch.float64)
        state = base.init_model_state(pcfg, model)
        state.step = ramp_end
        _, pm = get_method("uaps").make_train_step(pcfg, model)(
            state, _torch_batch(batch))
    return {"cfg": cfg, "jax": jax_out, "calls": dict(calls.n),
            "port": ({k: float(v) for k, v in pm.items()},
                     {k: v.detach().clone().numpy()
                      for k, v in model.state_dict().items()})}


def test_unfused_mtiles_step_matches_jax(unfused_run):
    """Every metric, the params and the BN stats after one step of the
    unfused route with the decoder-consistency term, the unramped
    uncertainty term and one fused labelled + unlabelled forward, at
    test_uaps_steps_match_jax's one-step tolerances (metrics rtol 1e-5,
    params atol 2e-6, BN stats rtol 1e-4 / atol 1e-5)."""
    cfg = unfused_run["cfg"]
    (jm, jsd, jgrad), (pm, psd) = unfused_run["jax"], unfused_run["port"]
    assert unfused_run["calls"] == {"pseudo_label_plain": 1}
    assert jm["consistency_w1"] == pytest.approx(0.1)
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, err_msg=k)
    jparams = {k: v for k, v in jsd.items() if "running" not in k}
    check_params(jparams, psd, jgrad, 1, cfg.optim.base_lr, 2e-6)
    for k, sj in running(jsd).items():
        np.testing.assert_allclose(psd[k], sj, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_uaps_step_routes_through_kernel_modules(gates_open):
    """One CPU UAPS step of the neu unet_uaps (4 decoders, every
    perturbation and the encoder dropout on) calls each kernel module as
    often as a GPU step launches it (chip_smoke.py UAPS_STEP_LAUNCHES): the
    fused route calls the uncertainty module and never the pseudo-label
    module; with fused_uncertainty=False the pseudo-label module runs once
    and the uncertainty module never; conv_backend="xla" calls none."""
    targets = [(tunet, "conv3x3_nchw"), (tunet, "max_pool_2x2_nchw"),
               (kconv, "conv3x3_nchw_dgrad"), (kconv, "conv3x3_nchw_wgrad"),
               (kpool, "max_pool_2x2_nchw_bwd"), (kce, "ce_dice_stats"),
               (kce, "ce_dice_bwd"), (kpt, "_dropout"), (kpt, "_noise"),
               (kpt, "_fdrop_fwd"), (kpt, "_fdrop_bwd"),
               (kun, "uncertainty_fwd"), (kun, "uncertainty_bwd"),
               (puaps, "fused_pseudo_label")]
    counts = Counts(gates_open, targets)
    for backend, fused in (("auto", True), ("auto", False), ("xla", True)):
        _, cfg = _cfgs(3)
        cfg.model = dataclasses.replace(cfg.model, conv_backend=backend)
        cfg.method = dataclasses.replace(cfg.method,
                                         fused_uncertainty=fused)
        method = get_method("uaps")
        state, model = method.init_state(cfg, "cpu")
        batch = _torch_batch({k: v for k, v in _batches(4)[0].items()
                              if k != "mix_w"})
        counts.n.clear()
        state, m = method.make_train_step(cfg, model)(state, batch)
        assert np.isfinite([float(v) for v in m.values()]).all()
        if backend == "xla":
            assert counts.n == {}
            continue
        assert counts.n == {
            "conv3x3_nchw": 48, "conv3x3_nchw_dgrad": 46,
            "conv3x3_nchw_wgrad": 48, "max_pool_2x2_nchw": 4,
            "max_pool_2x2_nchw_bwd": 4, "ce_dice_stats": 8,
            "ce_dice_bwd": 8, "_dropout": 40, "_noise": 20,
            "_fdrop_fwd": 10, "_fdrop_bwd": 10,
            **({"uncertainty_fwd": 1, "uncertainty_bwd": 1} if fused
               else {"fused_pseudo_label": 1})}


def test_trainer_one_uaps_epoch_on_cpu(tmp_path):
    """`python -m uaps_tpu_torch.train --method uaps --device cpu`: one
    epoch of two UAPS steps on the synthetic data, with every UAPS metric
    in the JSONL line."""
    import json
    from uaps_tpu_torch import train
    argv = ["--preset", "synthetic", "--method", "uaps", "--device", "cpu",
            "--epochs", "1", "--iter_per_epoch", "2", "--batch_size", "2",
            "--out_dir", str(tmp_path)]
    best = train.main(argv)
    (line,) = (tmp_path / "metrics.jsonl").read_text().splitlines()
    rec = json.loads(line)
    keys = ("loss", "sup_loss", "ps_loss", "uncertainty_loss",
            "consistency_w1", "val_loss")
    assert np.isfinite([rec[k] for k in keys]).all()
    assert best == rec["val_mdice"]
    assert (tmp_path / "best_model.pth").exists()
