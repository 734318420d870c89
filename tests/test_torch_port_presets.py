"""The port's fused pseudo-label module and the dagm, mtiles and kosdd2
presets against the JAX package on the CPU.

The pseudo-label module (its plain version on the CPU) is held to
`uaps_tpu.pallas.pseudo_label.fused_pseudo_label` in interpret mode
(`force_pallas=True`) and to its oracle `_reference_impl`, on the logits the
port's model hands over (NHWC views of NCHW storage) and the stacked
[D, B, H, W, C] array JAX takes, at tests/test_pallas.py's shape
(D = 4, B = 2, 16 x 128). Tolerances: f32 labels exactly equal (both sides
compute the same f32 softmax mix; a random draw puts no two classes' mixes
within rounding of each other); bf16 logits equal on >= 99.9% of pixels, as
tests/test_pallas.py asks of the Pallas kernel, since a bf16 input may make
two mixes tie to within the order of the f32 sums.

The presets: one UAPS step of each of dagm (1 input channel, 7 classes),
mtiles (6 classes, lr 2e-3, unramped uncertainty) and kosdd2 (2 classes,
the 1:2 aspect) as the CLI builds them, at full width and a reduced image
size, with finite losses, and the dagm main-decoder forward against JAX's
at narrow widths (f32 logits within rtol = atol = 1e-5: the same f32 convs
summed in another order).
"""
import dataclasses

import jax  # noqa: F401  (jax before torch)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from _torch_port_util import (jax_main_only, open_gates, port_logits,
                              seeded_variables)
from uaps_tpu.models.unet import MultiDecoderUNet as JaxMultiDecoderUNet
from uaps_tpu.pallas.pseudo_label import _reference_impl
from uaps_tpu.pallas.pseudo_label import fused_pseudo_label as jax_pseudo
from uaps_tpu_torch.kernels import pseudo_label as kpl
from uaps_tpu_torch.models import unet as tunet
from uaps_tpu_torch.utils.weights import load_jax_params

D, B, H, W = 4, 2, 16, 128
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _logits(c, seed):
    """D decoders' NCHW logits [D, B, C, H, W] f32 and Dirichlet weights."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((D, B, c, H, W)) * 3).astype(np.float32)
    return x, rng.dirichlet(np.ones(D)).astype(np.float32)


def _both(x, w, dtype):
    """(the port module's labels on NHWC views of the NCHW tensors, the
    Pallas kernel's, the oracle's), as numpy."""
    tdt, jdt = DTYPES[dtype]
    views = [torch.from_numpy(xd).to(tdt).permute(0, 2, 3, 1) for xd in x]
    got = kpl.fused_pseudo_label(views, torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert tuple(got.shape) == views[0].shape[:3]
    jx = jnp.asarray(np.transpose(x, (0, 1, 3, 4, 2))).astype(jdt)
    jw = jnp.asarray(w)
    return (got.numpy(), np.asarray(jax_pseudo(jx, jw, force_pallas=True)),
            np.asarray(_reference_impl(jx, jw)))


@pytest.mark.parametrize("c,dtype", [(4, "float32"), (4, "bfloat16"),
                                     (2, "float32"), (7, "float32")])
def test_pseudo_label_matches_pallas(c, dtype):
    got, kern, oracle = _both(*_logits(c, 40 + c), dtype)
    assert got.shape == (B, H, W)
    if dtype == "float32":
        np.testing.assert_array_equal(got, kern)
        np.testing.assert_array_equal(got, oracle)
    else:
        assert (got == kern).mean() >= 0.999
        assert (got == oracle).mean() >= 0.999
    assert len(np.unique(got)) == c   # every class wins somewhere


def test_pseudo_label_ties_go_to_the_lowest_class():
    """Exact ties of the mix: equal logits everywhere (class 0), classes 1
    and 3 tied above the rest in every decoder (1), classes 2 and 3 (2);
    the Pallas kernel's strict `>` from -1 gives the same."""
    x = np.zeros((2, 1, 4, 1, 3), np.float32)   # [D, B, C, H, W]
    x[:, 0, :, 0, 1] = [0.0, 2.0, 1.0, 2.0]
    x[:, 0, :, 0, 2] = [0.0, 0.0, 5.0, 5.0]
    w = np.asarray([0.75, 0.25], np.float32)
    views = [torch.from_numpy(xd).permute(0, 2, 3, 1) for xd in x]
    got = kpl.fused_pseudo_label(views, torch.from_numpy(w)).numpy()
    jx = jnp.asarray(np.transpose(x, (0, 1, 3, 4, 2)))
    kern = np.asarray(jax_pseudo(jx, jnp.asarray(w), force_pallas=True))
    np.testing.assert_array_equal(got, [[[0, 1, 2]]])
    np.testing.assert_array_equal(kern, got)


def test_pseudo_label_builds_no_graph():
    """The label is a constant: inputs that require grad give a tensor
    outside autograd."""
    x, w = _logits(4, 50)
    views = [torch.from_numpy(xd).permute(0, 2, 3, 1).requires_grad_()
             for xd in x]
    out = kpl.fused_pseudo_label(views, torch.from_numpy(w)
                                 .requires_grad_())
    assert not out.requires_grad and out.grad_fn is None


def test_pseudo_label_refuses_what_it_cannot_take():
    """Shapes that disagree and a w of the wrong length raise ValueError,
    as does a device with neither a kernel nor a plain version."""
    lg = [torch.zeros(1, 2, 8, 4)] * 2
    with pytest.raises(ValueError):
        kpl.fused_pseudo_label([lg[0], torch.zeros(1, 2, 8, 3)],
                               torch.ones(2))
    with pytest.raises(ValueError):
        kpl.fused_pseudo_label(lg, torch.ones(3))
    with pytest.raises(ValueError):
        kpl.fused_pseudo_label([t.to("meta") for t in lg],
                               torch.ones(2, device="meta"))


# ---------------------------------------------------------------- presets
PRESET_CASES = {
    # name: (reduced (H, W), in_channels, classes, batch, lr)
    "dagm": ((32, 32), 1, 7, 16, 1e-3),
    "mtiles": ((32, 32), 3, 6, 16, 2e-3),
    "kosdd2": ((32, 64), 3, 2, 12, 2e-3),
}


@pytest.mark.parametrize("name", sorted(PRESET_CASES))
def test_preset_uaps_step_on_cpu(name, monkeypatch):
    """`python -m uaps_tpu_torch.train --preset NAME --dataset synthetic
    --dtype bfloat16`'s config at full width, 2 + 2 images of a reduced
    size with the preset's channels, classes and aspect, the kernel gates
    opened (the kernel modules' plain versions run): one UAPS step and one
    eval step with finite metrics."""
    from uaps_tpu_torch.data import SyntheticDefects
    from uaps_tpu_torch.methods import base, get_method
    from uaps_tpu_torch.train import to_device
    from uaps_tpu_torch.utils.cli import parse_args
    hw, chans, classes, batch, lr = PRESET_CASES[name]
    cfg, _ = parse_args(["--preset", name, "--dataset", "synthetic",
                         "--dtype", "bfloat16"])
    assert (cfg.data.in_channels, cfg.data.num_classes, cfg.data.batch_size,
            cfg.optim.base_lr, cfg.model.name, cfg.method.name) == (
                chans, classes, batch, lr, "unet_uaps", "uaps")
    assert cfg.method.unramped_uncertainty == (name == "mtiles")
    full = cfg.data.image_size
    assert full[1] * hw[0] == full[0] * hw[1]   # the preset's aspect
    cfg.data = dataclasses.replace(cfg.data, image_size=hw, batch_size=2)
    open_gates(monkeypatch, hw[1])
    method = get_method("uaps")
    state, model = method.init_state(cfg, "cpu")
    data = SyntheticDefects(cfg.data, seed=3)
    b = to_device(next(data.train_iter()), "cpu")
    assert b["image"].shape == (2, *hw, chans)
    state, m = method.make_train_step(cfg, model)(state, b)
    ev = base.make_eval_step(cfg, model)(
        to_device(next(data.val_iter(1)), "cpu"))
    assert state.step == 1
    assert np.isfinite([float(v) for v in {**m, **ev}.values()]).all()


def test_dagm_main_only_matches_jax():
    """The dagm model's eval forward (1 input channel, 7 classes) at narrow
    widths: the JAX model and the port's, built directly, on the same
    seeded weights (load_jax_params, strict); then the port's engine on
    uint8 grayscale images normalises with dagm's 1-element mean and std."""
    from uaps_tpu_torch.methods import build_model
    from uaps_tpu_torch.serve import InferenceEngine
    from uaps_tpu_torch.utils.config import preset
    features, hw = (4, 8, 16, 32, 64), (16, 128)
    jm = JaxMultiDecoderUNet(
        num_classes=7, perturbations=("none",) * 3, features=features,
        dropout=(0.0,) * 5, nchw_levels=2, conv_variant="dwmf",
        head_variant="dwmf", dtype=jnp.float32)
    v = seeded_variables(jm, hw, 41, channels=1)
    tm = load_jax_params(
        tunet.MultiDecoderUNet(7, ("none",) * 3, 1, torch.float32,
                               nchw_levels=2, head_variant="dwmf",
                               features=features, dropout=(0.0,) * 5),
        v["params"], v["batch_stats"]).eval()
    x = np.random.default_rng(42).standard_normal(
        (2, *hw, 1)).astype(np.float32)
    ref, got = jax_main_only(jm, v, x), port_logits(tm, x)
    assert got.shape == ref.shape == (2, *hw, 7)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    cfg = preset("dagm")
    cfg.data = dataclasses.replace(cfg.data, image_size=(32, 32),
                                   batch_size=2)
    engine = InferenceEngine(cfg, state_dict=build_model(cfg, "cpu")
                             .state_dict(), device="cpu")
    imgs = np.random.default_rng(43).integers(0, 256, (3, 32, 32, 1),
                                              dtype=np.uint8)
    masks, probs = engine.predict(imgs)
    norm = ((imgs.astype(np.float32) / 255.0 - np.float32(0.5314))
            / np.float32(0.1357))
    assert probs.shape == (3, 32, 32, 7)
    np.testing.assert_array_equal(
        masks, port_logits(engine.model, norm).argmax(-1))
