"""The port's deep-supervision nets (`unet_f`, `unet_g`, `unet_h`) and its
`cps` step against the JAX package on the CPU; and the conv route at JAX's
NHWC levels.

The recipe of tests/test_torch_port_methods.py: dropout 0 on both sides,
seeded f32 weights (tests/_torch_port_util.py), the same numpy batches,
2 + 2 images of 16 x 128 at narrow widths. The forwards run in f32; the
cps step in f64 activations (`jax.enable_x64(True)`, one `jax.jit`) from
two weight sets, one a net, 2 steps from step 0 and 2 from the end of the
ramp (w = 0.1), compared by `_torch_port_util.check_method_steps` for both
nets: every metric at rtol 1e-5, each net's params at atol 2e-6 (elements
at the gradient's rounding noise within 2 lr 1.05), BN running stats at
rtol 1e-4 / atol 1e-5, Adam's moments at rtol 1e-4 / atol 1e-5 of each
moment's largest element; step 2 from JAX's state after step 1.

unet_g and unet_h draw their perturbation from JAX's "perturb" rng and
from the port's counter-based generator, whose bits differ, so the test
hands JAX's own draws to the port's applies (as
tests/test_torch_port_uaps.py holds the applies to JAX's perturbations):
with them the port's forward equals JAX's.

The routing test traces JAX's model with its Pallas entry points replaced
by counting XLA stand-ins and the TPU platform reported to its gates
(`jax.eval_shape`: nothing compiles), and counts the port's calls of the
conv kernel module at the same shapes with the real shape gate.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from _torch_port_util import (Counts, check_method_steps, jax_method_runs,
                              jit, neu_config, open_gates, port_method_runs,
                              seeded_variables)
from uaps_tpu.methods import cps as jcps
from uaps_tpu.models import unet as junet
from uaps_tpu_torch import dispatch
from uaps_tpu_torch.methods import base, get_method
from uaps_tpu_torch.models import net_factory
from uaps_tpu_torch.models import unet as tunet
from uaps_tpu_torch.utils.weights import load_jax_params

HW = (16, 128)
B = 2
FEATURES = (4, 8, 16, 32, 64)
STEPS = 2
DS_KINDS = {"unet_f": "none", "unet_g": "feature_dropout",
            "unet_h": "feature_noise"}
HEADS = ("dp0", "dp1", "dp2", "dp3")


def _jax_ds(kind, dtype):
    return junet.DeepSupervisionUNet(num_classes=4, perturbation=kind,
                                     features=FEATURES, dropout=(0.0,) * 5,
                                     dtype=dtype)


def _port_ds(kind, v, dtype):
    m = tunet.DeepSupervisionUNet(4, kind, 3, dtype, features=FEATURES,
                                  dropout=(0.0,) * 5)
    return load_jax_params(m, v["params"], v["batch_stats"])


def _nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _images(seed):
    return np.random.default_rng(seed).standard_normal(
        (B, *HW, 3)).astype(np.float32)


# ------------------------------------------------------------ the forward
@pytest.fixture(scope="module")
def unet_f_forward():
    """JAX's unet_f (f32) on seeded weights: the train-mode dict and BN
    stats, and the eval-mode dict, from one jit."""
    v = seeded_variables(_jax_ds("none", jnp.float32), HW, 51)
    x = _images(52)
    jm = _jax_ds("none", jnp.float32)

    @jax.jit
    def both(variables, xx):
        train, mut = jm.apply(variables, xx, train=True,
                              mutable=["batch_stats"])
        return train, mut["batch_stats"], jm.apply(variables, xx,
                                                   train=False)

    train, stats, ev = jax.device_get(both(v, jnp.asarray(x)))
    return v, x, train, stats, ev


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_unet_f_forward_matches_jax(unet_f_forward, mode):
    """The port's unet_f from the same weights: dp0 (its forward's output)
    and the full dict (the bottleneck, f1..f4, dp0..dp3, the coarse heads
    resized with nearest) at rtol 1e-4 / atol 1e-5; in train mode also the
    BN running stats the forward leaves."""
    from uaps_tpu_torch.utils.weights import state_dict_from_jax
    v, x, train, stats, ev = unet_f_forward
    ref = train if mode == "train" else ev
    model = _port_ds("none", v, torch.float32)
    model.train(mode == "train")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        dp0 = model(xt).numpy()
        # the full dict from the same starting stats
        model.load_state_dict(state_dict_from_jax(v["params"],
                                                  v["batch_stats"]))
        full = {k: t.numpy() for k, t in model(xt, full=True).items()}
    np.testing.assert_allclose(dp0, ref["dp0"], rtol=1e-4, atol=1e-5)
    assert set(full) == set(ref)
    for k, r in ref.items():
        assert full[k].shape == r.shape, k
        np.testing.assert_allclose(full[k], r, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    if mode == "train":
        got = model.state_dict()
        want = state_dict_from_jax(v["params"], stats)
        for k, t in want.items():
            if "running" in k:
                np.testing.assert_allclose(got[k].numpy(), t.numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["unet_g", "unet_h"])
def test_perturbed_ds_forward_matches_jax(name, monkeypatch):
    """unet_g (feature dropout) and unet_h (feature noise), eval mode, f32:
    the port perturbs the 5 encoder features with its net's kind; given
    JAX's draws (one a skip, from JAX's split of its "perturb" key) its
    applies give JAX's full dict at rtol 1e-4 / atol 1e-5, and the
    features it perturbs equal JAX's."""
    from uaps_tpu.ops import perturbations as jpert
    from uaps_tpu_torch.ops import perturbations as pops
    kind = DS_KINDS[name]
    jm = _jax_ds(kind, jnp.float32)
    v = seeded_variables(jm, HW, 53)
    x = _images(54)
    seen = {}

    def recorded(key, feats, kind_, channel_axes=None, backend="auto"):
        keys = jax.random.split(key, len(feats))
        if kind_ == "feature_noise":
            seen["draws"] = [jax.random.uniform(
                k, f.shape[1:], dtype=f.dtype, minval=-0.3, maxval=0.3)
                for k, f in zip(keys, feats)]
        else:
            seen["draws"] = [jax.random.uniform(
                k, (), dtype=f.dtype, minval=0.7, maxval=0.9)
                for k, f in zip(keys, feats)]
        seen["feats"] = list(feats)
        return jpert.perturb_features(key, feats, kind_, channel_axes,
                                      backend)

    monkeypatch.setattr(junet, "perturb_features", recorded)

    @jit
    def fwd(variables, xx):
        out = jm.apply(variables, xx, train=False,
                       rngs={"perturb": jax.random.key(5)})
        return out, seen["draws"], seen["feats"]

    ref, draws, jfeats = jax.device_get(fwd(v, jnp.asarray(x)))
    got_feats = []

    def with_jax_draws(seeds, feats, kind_, backend="auto"):
        assert kind_ == kind and len(seeds) == len(feats) == 5
        got_feats.extend(feats)
        if kind_ == "feature_noise":
            return [pops.feature_noise_apply(
                f, torch.from_numpy(np.asarray(d).transpose(2, 0, 1)))
                for f, d in zip(feats, draws)]
        return [pops.feature_dropout_apply(f, torch.tensor(float(d)))
                for f, d in zip(feats, draws)]

    monkeypatch.setattr(tunet, "perturb_features", with_jax_draws)
    model = _port_ds(kind, v, torch.float32).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.Generator().manual_seed(0),
                    full=True)
    for f, jf in zip(got_feats, jfeats):
        np.testing.assert_allclose(_nchw_to_nhwc(f), jf, rtol=1e-4,
                                   atol=1e-5)
    for k in HEADS:
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(DS_KINDS))
def test_ds_nets_build_and_take_jax_weights(name):
    """net_factory builds unet_f, unet_g and unet_h at the neu widths with
    the perturbation of the JAX factory's net, and `state_dict_from_jax`
    equals JAX's `export_state_dict` on the net's tree (the reference's
    names: `decoder.*` and `out_conv_dp1..3`), which the port's net loads
    with strict=True."""
    from uaps_tpu.models import net_factory as jax_factory
    from uaps_tpu.utils.torch_import import export_state_dict
    from uaps_tpu_torch.utils.weights import state_dict_from_jax
    jm = jax_factory(name, class_num=4)
    assert jm.perturbation == DS_KINDS[name]
    v = seeded_variables(jm, (32, 32), 55)
    got = state_dict_from_jax(v["params"], v["batch_stats"])
    want = export_state_dict(v["params"], v["batch_stats"])
    assert set(got) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(a),
                                      err_msg=k)
    assert {f"decoder.out_conv_dp{i}.weight" for i in (1, 2, 3)} <= set(got)
    model = net_factory(name, 3, 4, generator=torch.Generator()
                        .manual_seed(0))
    assert isinstance(model, tunet.DeepSupervisionUNet)
    assert model.perturbation == DS_KINDS[name]
    model.load_state_dict(got, strict=True)


# ---------------------------------------------------------------- the step
def _cfgs():
    """cps's config from each package's preset, f32, at HW and B."""
    from uaps_tpu_torch.utils.config import preset as port_preset
    out = []
    for cfg in (neu_config("cps", "float32"),
                port_preset("neu", method="cps")):
        assert cfg.model.name == "unet_f"
        cfg.model = dataclasses.replace(cfg.model, compute_dtype="float32")
        cfg.data = dataclasses.replace(cfg.data, image_size=HW,
                                       batch_size=B)
        out.append(cfg)
    return out


def _batches():
    rng = np.random.default_rng(61)
    return [{"image": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "uimage": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "label": rng.integers(0, 4, (B, *HW)).astype(np.int32)}
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def cps_runs():
    """(cfg, JAX runs, JAX step-1 gradients of net 1, port runs) from step
    0 and from the end of the ramp; net 1 and net 2 from different seeded
    weights."""
    cfg, pcfg = _cfgs()
    v1, v2 = (seeded_variables(_jax_ds("none", jnp.float32), HW, s)
              for s in (41, 42))
    batches = _batches()
    starts = (0, int(150 * cfg.method.consistency_rampup))
    with jax.enable_x64(True):
        jruns, jgrads = jax_method_runs(jcps, cfg,
                                        _jax_ds("none", jnp.float64), v1,
                                        batches, starts, second=v2)
    pruns = port_method_runs(
        get_method("cps"), pcfg, lambda: _port_ds("none", v1,
                                                  torch.float64),
        batches, starts, jruns,
        make_second=lambda: _port_ds("none", v2, torch.float64))
    return cfg, jruns, jgrads, pruns


@pytest.mark.parametrize("start", ["step 0", "past the ramp"])
@pytest.mark.parametrize("n_steps", [1, STEPS])
def test_cps_steps_match_jax(cps_runs, start, n_steps):
    """Every metric (JAX's names) and both nets' state after each of the
    first n_steps steps: params, BN stats, Adam's moments, from step 0
    (w = 0.1 e^-5) and from the end of the ramp (w = 0.1). The dp1..3
    heads, which the step never reads, keep their weights and zero
    moments in both packages."""
    cfg, jruns, jgrads, pruns = cps_runs
    s0 = 0 if start == "step 0" else int(150 * cfg.method
                                         .consistency_rampup)
    if s0:
        assert jruns[s0][0]["metrics"]["consistency_w1"] == \
            pytest.approx(0.1)
    for run in (jruns[s0], pruns[s0]):
        for net in (run[0], run[0]["second"]):
            assert not net["mu"]["decoder.out_conv_dp1.weight"].any()
    check_method_steps(jruns[s0][:n_steps], pruns[s0][:n_steps], jgrads[s0],
                       cfg.optim.base_lr)


def test_cps_state_and_k_steps(unet_f_forward):
    """cps.init_state: two unet_f nets from different weights, net 2 in
    `state.second` with its own Adam and lr tensor, which get_lr / set_lr
    reach apart from net 1's; dispatch.run_steps with K = 2 (what a CUDA
    graph of a dispatch captures) equals two sequential steps bit for bit:
    the [K] metrics and both nets' state dicts; the counter advanced by
    K."""
    cfg = _cfgs()[1]
    state, model = get_method("cps").init_state(cfg, "cpu")
    net2 = state.second.model
    assert isinstance(model, tunet.DeepSupervisionUNet)
    assert isinstance(net2, tunet.DeepSupervisionUNet)
    w = "encoder.in_conv.conv_conv.0.weight"
    assert not torch.equal(model.state_dict()[w], net2.state_dict()[w])
    base.set_lr(state.second, 3e-4)
    assert base.get_lr(state.second) == pytest.approx(3e-4)
    assert base.get_lr(state) == pytest.approx(cfg.optim.base_lr)
    v1 = unet_f_forward[0]
    v2 = seeded_variables(_jax_ds("none", jnp.float32), HW, 57)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches()]
    out = []
    for k in (None, 2):
        model, net2 = (_port_ds("none", v, torch.float32) for v in (v1, v2))
        state = base.init_model_state(cfg, model)
        state.second = base.SecondNet(net2, base.make_optimizer(
            net2.parameters(), cfg.optim, "cpu"))
        step = get_method("cps").make_train_step(cfg, model)
        if k is None:
            ms = []
            for b in batches:
                state, m = step(state, b)
                ms.append(m)
            metrics = {n: torch.stack([m[n] for m in ms]) for n in ms[0]}
        else:
            state, metrics = dispatch.run_steps(step, state,
                                                lambda i: batches[i], k)
        assert state.step == int(state.counter) == 2
        out.append((metrics, model.state_dict(), net2.state_dict()))
    (m1, a1, b1), (m2, a2, b2) = out
    assert set(m1) == set(m2) == {
        "loss", "sup_loss", "labeled_cps_loss", "unlabeled_cps_loss",
        "consistency_w1", "train_miou", "train_mdice"}
    for n in m1:
        assert m2[n].shape == (2,) and torch.equal(m1[n], m2[n]), n
    for x, y in ((a1, a2), (b1, b2)):
        for n, t in x.items():
            assert torch.equal(t, y[n]), n


def test_cps_step_routes_through_kernel_modules(monkeypatch):
    """One CPU cps step of two unet_f nets at the neu widths (encoder
    dropout on, the kernel gates opened at levels 0 and 1: `open_gates`)
    calls each kernel module as often as a step on the card launches it
    (chip_smoke.py CPS_STEP_LAUNCHES): 9 convs a forward (in_conv, down1,
    up3, up4 at JAX's NHWC levels, and the f32 dp0 head), 8 dgrads, 9
    wgrads, 5 dropouts and as many backwards, for 4 forwards; 6 CE+Dice
    pairs; no pool kernel; with conv_backend="xla" none."""
    from uaps_tpu_torch.kernels import ce_dice as kce
    from uaps_tpu_torch.kernels import conv3x3_nchw as kconv
    from uaps_tpu_torch.kernels import perturb as kpt
    from uaps_tpu_torch.kernels import pool_nchw as kpool
    open_gates(monkeypatch, HW[1])
    counts = Counts(monkeypatch, [
        (tunet, "conv3x3_nchw"), (kconv, "conv3x3_nchw_dgrad"),
        (kconv, "conv3x3_nchw_wgrad"), (tunet, "max_pool_2x2_nchw"),
        (kpool, "max_pool_2x2_nchw_bwd"), (kce, "ce_dice_stats"),
        (kce, "ce_dice_bwd"), (kpt, "_dropout")])
    batch = {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    for backend in ("auto", "xla"):
        cfg = _cfgs()[1]
        cfg.model = dataclasses.replace(cfg.model, conv_backend=backend)
        state, model = get_method("cps").init_state(cfg, "cpu")
        counts.n.clear()
        _, m = get_method("cps").make_train_step(cfg, model)(state, batch)
        assert np.isfinite([float(v) for v in m.values()]).all()
        assert counts.n == ({} if backend == "xla" else {
            "conv3x3_nchw": 36, "conv3x3_nchw_dgrad": 32,
            "conv3x3_nchw_wgrad": 36, "ce_dice_stats": 6, "ce_dice_bwd": 6,
            "_dropout": 40})


def test_cps_heads_deterministic(cps_runs, monkeypatch):
    """The f32 dp0 heads on the conv kernel module (ROADMAP Queue C #5):
    each net's step-1 head gradient (from Adam's first moment) against
    JAX's at the moments' tolerance of check_method_steps, from step 0 and
    past the ramp; and two CPU steps of both nets from one state (the
    gates opened as on the card: every head's weight gradient goes
    through `conv3x3_nchw_wgrad`, 4 a step) bit-equal: the gradients, the
    metrics and both nets' state."""
    from uaps_tpu_torch.kernels import conv3x3_nchw as kconv
    cfg, jruns, jgrads, pruns = cps_runs
    head = "decoder.out_conv.weight"
    for s0, runs in pruns.items():
        for net, jgrad in ((runs[0], jgrads[s0][head]),
                           (runs[0]["second"],
                            jruns[s0][0]["second"]["grad"][head])):
            got = net["mu"][head] / (1 - cfg.optim.b1)
            np.testing.assert_allclose(got, jgrad, rtol=1e-4,
                                       atol=1e-5 * np.abs(jgrad).max())
    open_gates(monkeypatch, HW[1])
    heads = []
    wgrad = kconv.conv3x3_nchw_wgrad

    def counted(x, g):
        heads.append(g.shape[1] == 4)
        return wgrad(x, g)

    monkeypatch.setattr(kconv, "conv3x3_nchw_wgrad", counted)
    pcfg = _cfgs()[1]
    method = get_method("cps")
    state, model = method.init_state(pcfg, "cpu")
    sd0 = [copy_sd(m) for m in (model, state.second.model)]
    batch = {k: torch.from_numpy(v) for k, v in _batches()[0].items()}
    out = []
    for _ in range(2):
        state, model = method.init_state(pcfg, "cpu")
        nets = (model, state.second.model)
        for net, sd in zip(nets, sd0):
            net.load_state_dict(sd)
        heads.clear()
        _, m = method.make_train_step(pcfg, model)(state, batch)
        assert sum(heads) == 4
        out.append((m, [{n: p.grad.clone() for n, p in net.named_parameters()
                         if p.grad is not None} for net in nets],
                    [copy_sd(net) for net in nets]))
    (m1, g1, s1), (m2, g2, s2) = out
    for n in m1:
        assert torch.equal(m1[n], m2[n]), n
    for a, b in list(zip(g1, g2)) + list(zip(s1, s2)):
        assert a.keys() == b.keys()
        for n, t in a.items():
            assert torch.equal(t, b[n]), n


def copy_sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def test_cps_eval_and_predict_read_dp0(unet_f_forward):
    """make_eval_step and InferenceEngine.predict on unet_f read dp0 (JAX
    base.py:231, serve.py:72): the eval metrics equal JAX's metric ops on
    JAX's eval dp0; the engine built for cps (unet_f at the neu widths)
    returns the softmax of its net's dp0 and its argmax."""
    from uaps_tpu.ops import cross_entropy_loss, mean_dice, \
        segmentation_metrics
    from uaps_tpu_torch.serve import InferenceEngine
    v, x, _, _, ev = unet_f_forward
    cfg = _cfgs()[1]
    cfg.model = dataclasses.replace(cfg.model, compute_dtype="float32")
    labels = np.random.default_rng(56).integers(0, 4, (B, *HW)).astype(
        np.int32)
    logits = jnp.asarray(ev["dp0"])
    jl = jnp.asarray(labels)
    ce = float(cross_entropy_loss(logits, jl))
    jm = segmentation_metrics(logits, jl, 4)
    want = {"val_loss": 0.5 * (ce + 1.0 - float(mean_dice(logits, jl, 4))),
            "val_ce": ce, "val_miou": float(jm["miou"]),
            "val_mdice": float(jm["mdice"])}
    model = _port_ds("none", v, torch.float32)
    got = base.make_eval_step(cfg, model)(
        {"image": torch.from_numpy(x), "label": torch.from_numpy(labels)})
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), w, rtol=1e-4, err_msg=k)
    net = net_factory("unet_f", 3, 4, generator=torch.Generator()
                      .manual_seed(1))
    eng = InferenceEngine(cfg, state_dict=net.state_dict(), device="cpu")
    masks, probs = eng.predict(x)
    with torch.no_grad():
        dp0 = net.eval()(torch.from_numpy(x), full=True)["dp0"]
    want = torch.softmax(dp0, -1).numpy()
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(masks, want.argmax(-1))


def test_cps_trainer_second_scheduler(tmp_path):
    """The Trainer for cps validates both nets (`val_*` and `val2_*`, the
    host path and the device pools alike) and steps net 2's lr with its
    own plateau scheduler, apart from net 1's (the CLI run of cps is
    tests/test_torch_port_methods.py::test_cli_trains_method[cps])."""
    from uaps_tpu_torch import train
    from uaps_tpu_torch.data import SyntheticDefects
    from uaps_tpu_torch.utils.config import preset
    cfg = preset("synthetic", method="cps")
    cfg.data = dataclasses.replace(cfg.data, image_size=(32, 32),
                                   batch_size=2)
    cfg.run = dataclasses.replace(cfg.run, out_dir=str(tmp_path))
    data = SyntheticDefects(cfg.data, seed=0, labeled_pool=4,
                            unlabeled_pool=4, val_pool=4)
    t = train.Trainer(cfg, device="cpu", data=data)
    host = t.validate()
    cfg.run = dataclasses.replace(cfg.run, device_pools=True)
    pooled = train.Trainer(cfg, device="cpu", data=data).validate()
    assert set(host) == set(pooled) and {"val_mdice", "val2_mdice",
                                         "val2_loss"} <= set(host)
    for k, v in host.items():
        assert pooled[k] == pytest.approx(v, rel=1e-6), k
    assert host["val_mdice"] != host["val2_mdice"]
    for _ in range(cfg.optim.plateau_patience + 2):
        t.scheduler2.step(t.state.second, 0.5)
    assert base.get_lr(t.state.second) < base.get_lr(t.state)


# --------------------------------------------- the conv at JAX's NHWC levels
class _TPUJax(types.SimpleNamespace):
    """The jax module, but `devices()` reports a TPU: what the JAX model's
    gates read (models/unet.py `jax.devices()[0].platform`)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def devices(*a, **kw):
        return [types.SimpleNamespace(platform="tpu")]


def _jax_routes(jm, hw, train, monkeypatch):
    """The JAX model's calls of its Pallas conv and pool entries in one
    forward at `hw` with the TPU's gates, traced by jax.eval_shape with
    XLA stand-ins: {"conv": NHWC conv3x3_fast + NCHW conv3x3_fast_nchw,
    "pool": max_pool_2x2_nchw}."""
    from uaps_tpu.pallas import conv3x3_nchw as jconv
    from uaps_tpu.pallas import pool_nchw as jpool
    n = {"conv": 0, "pool": 0}

    def conv(dn):
        def stand_in(x, w, interpret=False, variant="taps", out_dtype=None):
            n["conv"] += 1
            dt = out_dtype or x.dtype
            return jax.lax.conv_general_dilated(
                x.astype(dt), w.astype(dt), (1, 1), "SAME",
                dimension_numbers=dn)
        return stand_in

    def pool(x):
        n["pool"] += 1
        return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 1, 2, 2),
                                     (1, 1, 2, 2), "VALID")

    with monkeypatch.context() as mp:
        mp.setattr(junet, "jax", _TPUJax())
        mp.setattr(jconv, "conv3x3_fast", conv(("NHWC", "HWIO", "NHWC")))
        mp.setattr(jconv, "conv3x3_fast_nchw",
                   conv(("NCHW", "HWIO", "NCHW")))
        mp.setattr(jpool, "max_pool_2x2_nchw", pool)
        x = jnp.zeros((1, *hw, 3))
        rngs = {"params": jax.random.key(0), "dropout": jax.random.key(1),
                "perturb": jax.random.key(2)}

        def fwd():
            v = jm.init(rngs, x, train=False)
            n["conv"] = n["pool"] = 0
            return jm.apply(v, x, train=train, rngs=rngs,
                            mutable=["batch_stats"] if train else False)

        jax.eval_shape(fwd)
    return n


ROUTE_CASES = [("unet", 0), ("unet", 1), ("unet_uaps", 0), ("unet_uaps", 1),
               ("unet_f", None)]


@pytest.mark.parametrize("name,levels", ROUTE_CASES)
def test_conv_route_at_nhwc_levels_matches_jax(name, levels, monkeypatch):
    """At 256 x 256 (narrow widths, conv_backend "auto"), the port's calls
    of the conv kernel module (`conv3x3_nchw`) in one forward equal the
    convs JAX's gate admits, at its NCHW levels (conv3x3_fast_nchw) and its
    NHWC levels (conv3x3_fast) alike: every ConvBlock conv at 256 and 128
    px, and the logits head where level 0 is NCHW; unet_f's f32 dp0 head,
    a flax conv in JAX, takes the kernel in the port (its deterministic
    weight gradient, ROADMAP Queue C #5): one call more. The pool kernel and
    the block recipes still follow nchw_levels: the port's CUDA-pool calls
    equal JAX's Pallas-pool calls (none for unet_f), and with
    conv_backend="chain" the chain recipe sits at the levels below
    nchw_levels only."""
    hw = (256, 256)
    kw = dict(features=FEATURES, dropout=(0.0,) * 5)
    if name == "unet_f":
        jm = junet.DeepSupervisionUNet(num_classes=4, **kw)
        pm = tunet.DeepSupervisionUNet(4, "none", **kw)
    elif name == "unet":
        jm = junet.UNet(num_classes=4, nchw_levels=levels, **kw)
        pm = tunet.UNet(4, nchw_levels=levels, **kw)
    else:
        jm = junet.MultiDecoderUNet(num_classes=4, nchw_levels=levels,
                                    perturbations=("none",) * 3, **kw)
        pm = tunet.MultiDecoderUNet(4, ("none",) * 3, nchw_levels=levels,
                                    **kw)
    want = _jax_routes(jm, hw, False, monkeypatch)
    from uaps_tpu_torch.kernels import pool_nchw as kpool
    counts = Counts(monkeypatch, [(tunet, "conv3x3_nchw"),
                                  (tunet, "max_pool_2x2_nchw")])
    with torch.no_grad():
        pm.eval()(torch.zeros((1, *hw, 3)))
    got = {"conv": counts.n.get("conv3x3_nchw", 0),
           "pool": counts.n.get("max_pool_2x2_nchw", 0)}
    n_dec = {"unet": 1, "unet_uaps": 4, "unet_f": 1}[name]
    heads = n_dec if levels else 0
    assert want == {"conv": 4 + 4 * n_dec + heads,
                    "pool": min(levels or 0, 2)}, want
    assert got == {**want, "conv": want["conv"] + (name == "unet_f")}
    assert kpool.pool_pallas_ok(torch.zeros((1, 16, *hw)))
    if levels is not None:
        chain = tunet.UNet(4, nchw_levels=levels, conv_backend="chain", **kw)
        recipes = [chain.encoder.in_conv.block] + [
            getattr(chain.encoder, f"down{i}").maxpool_conv[1].block
            for i in range(1, 5)]
        assert recipes == ["chain" if i < levels else "default"
                           for i in range(5)]
