"""The port's ResNet trunks and BaseNet (uaps_tpu_torch/models/resnet.py)
against the JAX package's (uaps_tpu/models/resnet.py) on the CPU.

BaseNet(resnet18) at 32 x 32, batch 2, with seeded weights carried across
by the port's weight bridge (utils/weights.py). The f64 comparisons cast
the parameters and BN statistics to f64 on both sides: in eval mode an f32
running variance goes through an f32 rsqrt, whose last bit differs between
XLA and torch, and moves the trunk's features by ~1e-7 relative. With them
in f64 the trunk agrees to ~1e-14, and is held to 1e-9. FCNHead's last 1x1
conv is f32 in both packages (flax `nn.Conv(dtype=f32)`), so BaseNet's
logits and its TTA sum are f32 whatever the trunk's dtype: they are held
to f32 rounding, atol 1e-6 for the logits and 1e-5 for the sum of the 10
softmaxes (values up to 10, one f32 ulp there is 9.5e-7).

The resnet50 forward (Bottleneck, dilation) is compared in f32 at atol
1e-4; the baseline step on basenet_resnet18 in f64 (train-mode BN takes
f64 batch statistics); InferenceEngine(tta=True) against JAX's engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from _torch_port_util import (check_params, jax_sd, jit, running,
                              seeded_variables)
from uaps_tpu.methods import base as jbase
from uaps_tpu.methods import baseline as jbaseline
from uaps_tpu.models.resnet import BaseNet as JaxBaseNet
from uaps_tpu.utils.config import preset
from uaps_tpu_torch.methods import base, baseline
from uaps_tpu_torch.models import MODEL_REGISTRY, net_factory
from uaps_tpu_torch.models import resnet
from uaps_tpu_torch.serve import InferenceEngine
from uaps_tpu_torch.utils.config import preset as port_preset
from uaps_tpu_torch.utils.weights import load_jax_params

HW = (32, 32)
STEP_HW = (64, 64)
B = 2


def _variables(backbone, seed=3):
    return seeded_variables(JaxBaseNet(backbone=backbone, num_classes=4),
                            HW, seed)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _port(backbone, variables, dtype):
    m = resnet.BaseNet(backbone, 4, 3, dtype)
    load_jax_params(m, variables["params"], variables["batch_stats"])
    return m.double() if dtype == torch.float64 else m


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal((B, *HW, 3))


@pytest.fixture(scope="module")
def f64_runs():
    """JAX's and the port's BaseNet(resnet18) in f64: the trunk's features,
    the logits and the TTA sum, in eval mode."""
    v = _variables("resnet18")
    x = _images()
    with jax.enable_x64(True):
        jm = JaxBaseNet(backbone="resnet18", num_classes=4,
                        dtype=jnp.float64)
        feats, logits, tta = jit(lambda v, x: jm.apply(
            v, x, method=lambda m, xx: (m.net(xx, train=False), m(xx),
                                        m(xx, tta=True))))(_f64(v), x)
        jax_out = ([np.asarray(f) for f in feats], np.asarray(logits),
                   np.asarray(tta))
    pm = _port("resnet18", v, torch.float64).eval()
    with torch.no_grad():
        xt = torch.from_numpy(x)
        port_out = ([f.numpy() for f in pm.net(xt)], pm(xt).numpy(),
                    pm(xt, tta=True).numpy())
    return jax_out, port_out


def test_resnet18_trunk_matches_jax_f64(f64_runs):
    """c1..c4 of resnet18 (BasicBlock, the stem, the max-pool), NHWC."""
    (jf, _, _), (pf, _, _) = f64_runs
    assert [f.shape for f in pf] == [(B, 8, 8, 64), (B, 4, 4, 128),
                                     (B, 2, 2, 256), (B, 1, 1, 512)]
    for j, p in zip(jf, pf):
        assert np.abs(p - j).max() <= 1e-9


def test_basenet_forward_and_tta_match_jax(f64_runs):
    """BaseNet's f32 logits, and the TTA sum of 10 softmaxes (5 scales x
    the W-flip), which sums to 10 over the classes."""
    (_, jl, jt), (_, pl, pt) = f64_runs
    assert pl.shape == (B, *HW, 4) and pl.dtype == np.float32
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt, jt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt.sum(-1), 10.0, rtol=0, atol=1e-5)


def test_resnet50_forward_matches_jax_f32():
    """BaseNet(resnet50): Bottleneck blocks, stages 3 and 4 dilated (output
    stride 8: c4 is 4 x 4 at 32 px), f32 logits at atol 1e-4."""
    v = _variables("resnet50", seed=4)
    x = _images(1).astype(np.float32)
    jm = JaxBaseNet(backbone="resnet50", num_classes=4)
    want = np.asarray(jit(lambda v, x: jm.apply(v, x))(v, x))
    pm = _port("resnet50", v, torch.float32).eval()
    with torch.no_grad():
        c4 = pm.net(torch.from_numpy(x))[-1]
        got = pm(torch.from_numpy(x)).numpy()
    assert c4.shape == (B, 4, 4, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("backbone,count", [("resnet18", 11_176_512),
                                            ("resnet50", 23_508_032)])
def test_trunk_parameter_counts(backbone, count):
    """torchvision's trunk sizes (its resnet18 / resnet50 without fc), and
    every basenet_* name builds through the factory."""
    m = resnet.BaseNet(backbone, 4, 3, torch.float32)
    assert sum(p.numel() for p in m.net.parameters()) == count
    assert f"basenet_{backbone}" in MODEL_REGISTRY


def test_factory_init_and_knobs():
    """net_factory builds every BaseNet from a generator (the same seed, the
    same weights), ignoring the U-Net knobs as JAX's `make` does; the
    trunk's convs are JAX's `_kaiming` (std sqrt(2 / fan_out)), the head's
    1x1 lecun_normal with a zero bias, BN at 1 / 0."""
    for bk in resnet.BACKBONES:
        assert f"basenet_{bk}" in MODEL_REGISTRY
    a, b = (net_factory("basenet_resnet18", 3, 4, nchw_levels=2,
                        conv_backend="chain", head_variant="dwmf",
                        generator=torch.Generator().manual_seed(0))
            for _ in range(2))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
    w = a.net.layer4[0].conv2.weight          # 3x3, 512 -> 512
    std = np.sqrt(2.0 / (512 * 9))
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    head = a.head[3]
    assert abs(float(head.weight.std()) * np.sqrt(128) - 1) < 0.1
    assert not head.bias.any() and head.weight.dtype == torch.float32
    assert torch.equal(a.net.bn1.weight, torch.ones(64))


def test_pth_roundtrip(tmp_path):
    """save_pth / load_pth carry a BaseNet under torchvision's names
    (strict), the same keys the JAX bridge writes."""
    from uaps_tpu_torch.utils.weights import (load_pth, save_pth,
                                              state_dict_from_jax)
    v = _variables("resnet18")
    m = _port("resnet18", v, torch.float32)
    save_pth(m, tmp_path / "b.pth")
    n = load_pth(resnet.BaseNet("resnet18", 4, 3, torch.float32),
                 tmp_path / "b.pth")
    for (k, p), q in zip(m.state_dict().items(), n.state_dict().values()):
        assert torch.equal(p, q), k
    keys = set(state_dict_from_jax(v["params"], v["batch_stats"]))
    assert keys == set(m.state_dict())
    assert {"net.layer2.0.downsample.0.weight", "head.3.bias",
            "net.layer1.1.bn2.running_var"} <= keys


# ------------------------------------------------------------ one step
def _cfgs():
    out = []
    for p in (preset, port_preset):
        cfg = p("neu", method="baseline")
        cfg.model = dataclasses.replace(cfg.model, name="basenet_resnet18",
                                        compute_dtype="float32")
        cfg.data = dataclasses.replace(cfg.data, image_size=STEP_HW,
                                       batch_size=B)
        out.append(cfg)
    return out


def test_baseline_step_matches_jax_f64():
    """One `baseline` step on basenet_resnet18 at 64 x 64 (c4 2 x 2: at 32
    px its BN sees 2 values a channel, whose normalised output no longer
    depends on its input, and the gradient above it is rounding noise) from
    the same weights and batch, f64 parameters, BN statistics and
    activations on both sides (train-mode BN normalises with f64 batch
    statistics): the losses and metrics (of f32 logits: rtol 1e-6), every
    BN running statistic (atol 1e-8) and every parameter after Adam
    (`check_params`, as tests/test_torch_port_train.py holds the U-Net's
    step with its f32 head: atol 2e-6, the elements whose JAX gradient is
    below 1e-5 of the largest held to 2 lr: the first Adam update
    lr * g / (|g| + eps) moves by up to lr * eps * dg / (|g| + eps)^2, and
    the f32 head's rounding moves g by ~1e-8 of the largest, which at the
    18 layers' small gradients shifts an update by more than 2e-6)."""
    cfg, pcfg = _cfgs()
    v = seeded_variables(JaxBaseNet(backbone="resnet18", num_classes=4),
                         STEP_HW, 5)
    rng = np.random.default_rng(6)
    batch = {"image": rng.standard_normal((B, *STEP_HW, 3)),
             "label": rng.integers(0, 4, (B, *STEP_HW)).astype(np.int32)}
    with jax.enable_x64(True):
        jm = JaxBaseNet(backbone="resnet18", num_classes=4,
                        dtype=jnp.float64)
        v64 = _f64(v)
        tx = jbase.make_optimizer(cfg.optim)
        state = jbase.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=v64["params"],
                                 batch_stats=v64["batch_stats"],
                                 opt_state=tx.init(v64["params"]),
                                 key=jax.random.key(0))
        state, jmet = jit(jbaseline.make_train_step(cfg, jm, tx))(state,
                                                                  batch)
        want = jax_sd(state.params, state.batch_stats)
        jgrad = {k: g / (1 - cfg.optim.b1) for k, g in jax_sd(
            state.opt_state.inner_state[0].mu).items()}
        jmet = {k: float(m) for k, m in jmet.items()}
    model = _port("resnet18", v, torch.float64)
    pstate = base.init_model_state(pcfg, model)
    _, pmet = baseline.make_train_step(pcfg, model)(
        pstate, {k: torch.from_numpy(a) for k, a in batch.items()})
    got = {k: t.detach().numpy() for k, t in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert set(pmet) == set(jmet)
    for k, m in jmet.items():
        np.testing.assert_allclose(float(pmet[k]), m, rtol=1e-6, err_msg=k)
    assert set(got) == set(want)
    for k, w in running(want).items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-8, err_msg=k)
    check_params({k: w for k, w in want.items() if "running" not in k}, got,
                 jgrad, 1, cfg.optim.base_lr, atol=2e-6, noise=1e-5)


def test_engine_tta_matches_jax():
    """InferenceEngine(tta=True) on basenet_resnet18: the TTA sum divided
    by its sum over the classes, as JAX's engine computes it
    (serve.py:77-79), on 3 uint8 images at batch 2 (the second micro-batch
    padded). JAX's side is that formula on JAX's BaseNet, on the batch
    the port's engine normalised (building JAX's engine costs ~20 CPU-s
    more: its model init and its own jit)."""
    from uaps_tpu_torch.utils.weights import state_dict_from_jax
    _, pcfg = _cfgs()
    pcfg.data = dataclasses.replace(pcfg.data, image_size=HW)
    v = _variables("resnet18", seed=7)
    imgs = np.random.default_rng(8).integers(0, 256, (3, *HW, 3),
                                             dtype=np.uint8)
    peng = InferenceEngine(pcfg, state_dict=state_dict_from_jax(
        v["params"], v["batch_stats"]), device="cpu", tta=True)
    masks, probs = peng.predict(imgs)
    jm = JaxBaseNet(backbone="resnet18", num_classes=4)

    def predict(v, x):
        scores = jm.apply(v, x, train=False, tta=True)
        return scores / jnp.sum(scores, axis=-1, keepdims=True)

    x = peng._normalize(imgs)
    jprobs = np.asarray(jit(predict)(v, np.concatenate([x, x[-1:]]))[:3])
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert (masks == jprobs.argmax(-1)).mean() > 0.999
