"""The port's `cct`, `dct` and `ucc` steps and its CutMix ops against the
JAX package on the CPU.

The deterministic recipe of tests/test_torch_port_uaps.py: perturbations
"none" and dropout 0 on both sides, the same seeded f32 weights
(tests/_torch_port_util.py), the same numpy batches, 2 + 2 images of 16 x
128 at narrow widths, f64 activations (`jax.enable_x64(True)`: in f32 a
LeakyReLU input or pool window near its kink flips between the packages),
one `jax.jit` a method. The random parts of a step come in through JAX's
batch hooks, the same numbers to both packages: `rot_k` (dct) and the four
mixed streams (ucc); `cct` draws nothing once its perturbations are "none".
`cct` runs with one auxiliary decoder (D = 2), as the UAPS test does: the
JAX step's compile time grows with D, and the code is the same loop for
any D. `dct` rotates by 90 degrees, so it runs on square 128 x 128 images
(JAX's lax.switch over the rotations needs them, and W = 128 keeps the
CE+Dice kernel module's gate open). Each method takes 2 steps from step 0
and 2 from the end of its ramp (w1 = 0.1), compared at the tolerances of
`_torch_port_util.check_method_steps`: the port's state after step 1
(params, BN stats, Adam's moments) against JAX's, then its step 2 from
JAX's state after step 1 (`port_method_runs` says why).

The CutMix ops draw from a torch generator, whose bits are not JAX's, so
they are held to their semantics, as tests/test_methods_all.py
(`TestCutmix`) holds JAX's: p = 0 is the identity, p = 1 pastes the
rolled sample, the label mix follows the image mix, the rectangle's area
is H W / 2 within rounding, and weak and strong share one mask.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from _torch_port_util import (check_method_steps, jax_runs_in_threads,
                              neu_config, port_method_runs, seeded_variables)
from uaps_tpu.methods import cct as jcct
from uaps_tpu.methods import dct as jdct
from uaps_tpu.methods import ucc as jucc
from uaps_tpu.models.unet import MultiDecoderUNet as JaxMultiDecoderUNet
from uaps_tpu.models.unet import UNet as JaxUNet
from uaps_tpu_torch.methods import get_method
from uaps_tpu_torch.models import unet as tunet
from uaps_tpu_torch.ops import cutmix
from uaps_tpu_torch.utils.weights import load_jax_params

HW = (16, 128)
SQUARE = (128, 128)   # dct's images
B = 2
FEATURES = (4, 8, 16, 32, 64)
STEPS = 2
# the JAX module and the model: (decoders, or None for the plain U-Net)
METHODS = {"cct": (jcct, 2), "dct": (jdct, None), "ucc": (jucc, 2)}


def _hw(method):
    return SQUARE if method == "dct" else HW


def _cfgs(method):
    """The same config from each package's preset, f32, at _hw and B."""
    from uaps_tpu_torch.utils.config import preset as port_preset
    out = []
    for cfg in (neu_config(method, "float32"),
                port_preset("neu", method=method)):
        cfg.model = dataclasses.replace(cfg.model, compute_dtype="float32")
        cfg.data = dataclasses.replace(cfg.data, image_size=_hw(method),
                                       batch_size=B)
        out.append(cfg)
    return out


def _jax_model(n_dec, dtype):
    kw = dict(num_classes=4, features=FEATURES, dropout=(0.0,) * 5,
              nchw_levels=2, conv_variant="dwmf", head_variant="dwmf",
              dtype=dtype)
    if n_dec is None:
        return JaxUNet(**kw)
    return JaxMultiDecoderUNet(perturbations=("none",) * (n_dec - 1), **kw)


def _port_model(n_dec, v0):
    kw = dict(nchw_levels=2, head_variant="dwmf", features=FEATURES,
              dropout=(0.0,) * 5)
    m = (tunet.UNet(4, 3, torch.float64, **kw) if n_dec is None else
         tunet.MultiDecoderUNet(4, ("none",) * (n_dec - 1), 3,
                                torch.float64, **kw))
    return load_jax_params(m, v0["params"], v0["batch_stats"])


def _batches(method):
    rng = np.random.default_rng(31)
    hw = _hw(method)

    def img():
        return rng.standard_normal((B, *hw, 3)).astype(np.float32)

    def lab():
        return rng.integers(0, 4, (B, *hw)).astype(np.int32)

    out = []
    for i in range(STEPS):
        if method == "ucc":
            out.append({"mix_img_l": img(), "mix_lab_l": lab(),
                        "mix_wk": img(), "mix_st": img()})
            continue
        b = {"image": img(), "uimage": img(), "label": lab()}
        if method == "dct":
            b["rot_k"] = np.asarray((1, 3)[i], np.int32)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def method_runs():
    """{method: (cfg, JAX runs, JAX step-1 gradients, port runs)}, from
    step 0 and from the end of the ramp."""
    cases, jobs, out = {}, {}, {}
    for name, (jmethod, n_dec) in METHODS.items():
        cfg, pcfg = _cfgs(name)
        v0 = seeded_variables(_jax_model(n_dec, jnp.float32), _hw(name),
                              41)
        batches = _batches(name)
        starts = (0, int(150 * cfg.method.consistency_rampup))
        cases[name] = (cfg, pcfg, v0, batches, starts)
        jobs[name] = ((jmethod, cfg, _jax_model(n_dec, jnp.float64), v0,
                       batches, starts), {})
    for name, (jruns, jgrads) in jax_runs_in_threads(jobs):
        cfg, pcfg, v0, batches, starts = cases[name]
        n_dec = METHODS[name][1]
        pruns = port_method_runs(get_method(name), pcfg,
                                 lambda: _port_model(n_dec, v0), batches,
                                 starts, jruns)
        out[name] = (cfg, jruns, jgrads, pruns)
    return out


@pytest.mark.parametrize("start", ["step 0", "past the ramp"])
@pytest.mark.parametrize("n_steps", [1, STEPS])
@pytest.mark.parametrize("method", list(METHODS))
def test_method_steps_match_jax(method_runs, method, start, n_steps):
    """Every metric and the state after each of the first n_steps steps,
    from step 0 (w1 = 0.1 e^-5) and from the end of the ramp (w1 = 0.1,
    where the consistency term weighs in)."""
    cfg, jruns, jgrads, pruns = method_runs[method]
    s0 = 0 if start == "step 0" else int(150 * cfg.method
                                         .consistency_rampup)
    if s0:
        assert jruns[s0][0]["metrics"]["consistency_w1"] == \
            pytest.approx(0.1)
    check_method_steps(jruns[s0][:n_steps], pruns[s0][:n_steps], jgrads[s0],
                       cfg.optim.base_lr)


def test_rotations_match_jax():
    """torch.rot90(x, k, dims=(1, 2)) and dct.rot_k (k a 0-d tensor) turn
    NHWC x as jnp.rot90(x, k, axes=(1, 2)) does, for k = 0..3."""
    from uaps_tpu_torch.methods.dct import rot_k
    x = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    for k in range(4):
        ref = np.asarray(jnp.rot90(jnp.asarray(x), k, axes=(1, 2)))
        np.testing.assert_array_equal(
            torch.rot90(torch.from_numpy(x), k, dims=(1, 2)).numpy(), ref)
        np.testing.assert_array_equal(
            rot_k(torch.from_numpy(x), torch.tensor(k)).numpy(), ref)


def test_dct_needs_square_images():
    """dct on the 256 x 512 kosdd2 preset raises, naming the reason."""
    from uaps_tpu_torch.methods import build_model
    from uaps_tpu_torch.utils.cli import parse_args
    cfg, _ = parse_args(["--preset", "kosdd2", "--method", "dct"])
    cfg.model = dataclasses.replace(cfg.model, name="unet")
    with pytest.raises(ValueError, match="square"):
        get_method("dct").make_train_step(cfg, build_model(cfg, "cpu"))


def test_registry():
    """All eight of JAX's methods are ported, cps too; an unknown name
    raises."""
    from uaps_tpu.methods import METHODS as JAX_METHODS
    from uaps_tpu_torch.methods import METHODS
    assert set(METHODS) == set(JAX_METHODS)
    for name in ("baseline", "uaps", "cct", "mt", "uamt", "cps", "dct",
                 "ucc"):
        mod = get_method(name)
        assert callable(mod.init_state) and callable(mod.make_train_step)
    with pytest.raises(ValueError, match="unknown method"):
        get_method("fixmatch")


# ------------------------------------------------------------------ CutMix
def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_cutout_mask_rectangles():
    """Each mask is 1 outside one rectangle of zeros, width in [W/2 + 1,
    W - 1], height round(H W / 2 / width), inside the image: the zero area
    is H W / 2 within half a width's rounding."""
    for (h, w) in ((16, 128), (64, 64), (256, 512)):
        masks = cutmix.cutout_mask(_gen(h + w), 64, h, w).numpy()
        assert masks.shape == (64, h, w) and masks.dtype == np.float32
        assert set(np.unique(masks)) <= {0.0, 1.0}
        for m in masks:
            rows = np.where((m == 0).any(1))[0]
            cols = np.where((m == 0).any(0))[0]
            assert (np.diff(rows) == 1).all() and (np.diff(cols) == 1).all()
            rw, rh = len(cols), len(rows)
            assert w // 2 + 1 <= rw <= w - 1
            assert rh == np.round(h * w / 2 / rw)
            assert (m == 0).sum() == rw * rh
            assert abs(rw * rh - h * w / 2) <= rw / 2


def test_mix_data_p0_identity_and_p1_pastes_the_next_sample():
    """p = 0 returns the batch; p = 1 pastes into sample i a rectangle of
    sample (i + 1) % B, and the labels are pasted where the image is."""
    b, h, w = 4, 16, 32
    imgs = torch.arange(b, dtype=torch.float32)[:, None, None, None] \
        .expand(b, h, w, 3).contiguous()
    labs = torch.arange(b, dtype=torch.int32)[:, None, None] \
        .expand(b, h, w).contiguous()
    mi, ml = cutmix.generate_mix_data(_gen(1), imgs, labs, p=0.0)
    assert torch.equal(mi, imgs) and torch.equal(ml, labs)
    mi, ml = cutmix.generate_mix_data(_gen(2), imgs, labs, p=1.0)
    assert mi.shape == imgs.shape and ml.dtype == torch.int32
    for i in range(b):
        pasted = ml[i] == (i + 1) % b
        assert torch.equal(pasted, mi[i, ..., 0] == (i + 1) % b)
        assert bool(((ml[i] == i) | pasted).all())
        assert abs(int(pasted.sum()) - h * w / 2) <= w / 2
        assert bool((mi[i][pasted] == (i + 1) % b).all())


def test_crossmix_shares_mask_and_gate():
    """Weak and strong get the labelled content in the same pixels; p = 0
    leaves both; over many samples the gate opens with probability p."""
    lab = torch.zeros((8, 16, 16, 3))
    wk, st = torch.ones((8, 16, 16, 3)), torch.full((8, 16, 16, 3), 2.0)
    nwk, nst = cutmix.generate_crossmix_data(_gen(3), lab, wk, st, p=1.0)
    assert torch.equal(nwk == 0, nst == 0)
    assert bool((nwk == 0).flatten(1).any(1).all())
    nwk, nst = cutmix.generate_crossmix_data(_gen(4), lab, wk, st, p=0.0)
    assert torch.equal(nwk, wk) and torch.equal(nst, st)
    n = 4000
    lab, wk = torch.zeros((n, 8, 8, 1)), torch.ones((n, 8, 8, 1))
    nwk, nst = cutmix.generate_crossmix_data(_gen(5), lab, wk, wk, p=0.3)
    share = float((nwk == 0).flatten(1).any(1).float().mean())
    assert abs(share - 0.3) < 0.03, share
    assert torch.equal(nwk, nst)


def test_ucc_step_mixes_on_its_own():
    """Without the hooks the ucc step mixes its batch from the state's
    generator: finite metrics, and the same metrics from the same
    generator seed."""
    from uaps_tpu_torch.methods import base
    cfg = _cfgs("ucc")[1]
    v0 = seeded_variables(_jax_model(2, jnp.float32), HW, 41)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.standard_normal((B, *HW, 3))
                                 .astype(np.float32))
             for k in ("image", "uimage", "uimage_strong")}
    batch["label"] = torch.from_numpy(rng.integers(0, 4, (B, *HW))
                                      .astype(np.int32))
    got = []
    for _ in range(2):
        model = _port_model(2, v0)
        state = base.init_model_state(cfg, model)
        _, m = get_method("ucc").make_train_step(cfg, model)(state, batch)
        got.append({k: float(v) for k, v in m.items()})
    assert got[0] == got[1]
    assert all(np.isfinite(v) for v in got[0].values())


# ----------------------------------------------------------------- Trainer
@pytest.mark.parametrize("method", ["cct", "mt", "uamt", "dct", "ucc",
                                    "cps"])
def test_cli_trains_method(tmp_path, method):
    """`python -m uaps_tpu_torch.train --method M` on the CPU (the
    synthetic preset, batch 2, 2 steps as one 2-step dispatch, ucc on the
    weak / strong host stream): the method's model, finite metrics under
    JAX's names, and the step count; for cps net 2's validation metrics
    and its checkpoint beside net 1's."""
    import json
    from uaps_tpu_torch import train
    argv = ["--preset", "synthetic", "--method", method, "--device", "cpu",
            "--epochs", "1", "--iter_per_epoch", "2", "--batch_size", "2",
            "--steps_per_dispatch", "2", "--out_dir", str(tmp_path)]
    train.main(argv)
    (line,) = (tmp_path / "metrics.jsonl").read_text().splitlines()
    rec = json.loads(line)
    want = {"cct": "consistency_loss", "mt": "consistency_loss",
            "uamt": "mean_uncertainty", "dct": "consistency_loss",
            "ucc": "ps_loss", "cps": "unlabeled_cps_loss"}[method]
    assert np.isfinite([rec[k] for k in ("loss", want, "train_mdice",
                                         "val_loss")]).all(), rec
    if method == "cps":   # both nets validated, both kept
        assert np.isfinite([rec["val2_loss"], rec["val2_mdice"]]).all()
        assert (tmp_path / "best_model2.pth").exists()


def test_pool_sampler_strong_views():
    """With `strong` (ucc), a sampled batch carries uimage + 0.1 N(0, 1)
    drawn from the sampler's own generator (seeded, so a second sampler
    repeats it; the next step draws anew); without it the batch keeps its
    three arrays; the Trainer samples strong views for ucc alone."""
    from uaps_tpu_torch import train
    from uaps_tpu_torch.data import SyntheticDefects
    from uaps_tpu_torch.data.device_pool import PoolSampler
    from uaps_tpu_torch.utils.config import DataConfig, preset
    data = SyntheticDefects(DataConfig(image_size=(32, 32), batch_size=4),
                            seed=0, labeled_pool=8, unlabeled_pool=8)
    a, b = (PoolSampler(data, 64, 5, "cpu", strong=True) for _ in range(2))
    for s in (a, b):
        s.start_epoch(1)
    x, y = a.sample(), b.sample()
    assert set(x) == {"image", "label", "uimage", "uimage_strong"}
    noise = x["uimage_strong"] - x["uimage"]
    assert torch.equal(x["uimage_strong"], y["uimage_strong"])
    assert abs(float(noise.std()) - 0.1) < 0.005
    assert abs(float(noise.mean())) < 0.005
    z = a.sample()
    assert not torch.equal(z["uimage_strong"] - z["uimage"], noise)
    assert set(PoolSampler(data, 4, 5, "cpu").sample()) == {
        "image", "label", "uimage"}
    for method in ("ucc", "mt"):
        cfg = preset("synthetic", method=method)
        cfg.data = dataclasses.replace(cfg.data, image_size=(32, 32),
                                       batch_size=2)
        cfg.run = dataclasses.replace(cfg.run, device_pools=True)
        t = train.Trainer(cfg, device="cpu", data=data)
        assert (t.pools.generator is not None) == (method == "ucc")
