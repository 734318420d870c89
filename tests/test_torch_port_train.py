"""The port's training slice against the JAX package on the CPU: the
train-mode U-Net (logits, BN batch statistics, gradients), one and three
`baseline` steps, and the eval step.

The deterministic recipe: `UNet(dropout=(0.0,)*5)` on both sides, the same
seeded f32 weights (tests/_torch_port_util.py) and the same numpy batches,
2 x 16 x 128 images, half the neu widths. On the CPU neither package
reaches a kernel, so the JAX side runs XLA everywhere; on the port side the
shape gates of the kernel conv and pool are opened for the test, so that
every level-0/1 conv, both pools and the head run through the port's
autograd functions (their plain versions on the CPU) as they do at 256 px
on the GPU, and the loss goes through the fused CE+Dice module (its gate
holds at W = 128).

The forward is compared in f32. Gradients, steps and the eval step are
compared with the activations in f64 (`dtype=float64` models, f32
parameters, the f32 logits head of both packages): two f32 forwards differ
by ~1e-6 and at this size some LeakyReLU input or max-pool window always
lies within that of its kink or tie (measured: the smallest |input| over a
forward is 1e-8 to 2e-6 for every one of 80 seeds tried), so one pixel takes
the other branch and moves every upstream gradient by up to 1.5%; in f64
the forwards agree to ~1e-15.

Tolerances, and why:
  * f32 logits rtol 1e-3 / atol 1e-4, as tests/test_torch_import.py holds
    the reference torch model (f32 sums in another order); BN running stats
    after one forward rtol 1e-4 / atol 1e-5;
  * gradients: per tensor, atol 1e-4 x the tensor's largest |grad| and rtol
    1e-3 (the f32 head and f32 parameter casts). The biases of the convs
    that feed a train-mode BN have an exact gradient of 0 (BN subtracts the
    batch mean), so both packages give rounding noise there; those are
    checked to be below 1e-4 of the model's largest gradient instead;
  * Adam parameters: Adam's first update is lr * g / (|g| + eps), about
    lr * sign(g), so where |g| is at the level of the two packages'
    rounding noise (the BN-fed conv biases above, and any element whose
    JAX gradient at step 1 is below 1e-6 of the model's largest) the sign,
    and so the update, is noise. Those elements are held only to
    |p - p_jax| <= 2 * steps * lr * 1.05 (an Adam update here is about lr,
    ~0.2% over it once the moments hold more than one step); every other
    element to atol 2e-6 after one step and 2e-5 after three;
  * BN running means after three steps: atol 2 * lr, because the BN-fed
    conv bias each BN sees differs by up to 2 * lr per step (see above)
    and enters its running mean with weight 0.1 a step;
  * losses and metrics rtol 1e-5 (one step), 1e-4 (three steps and eval).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from _torch_port_util import (ZERO_GRAD_BIASES, Counts, check_params,
                              neu_config, seeded_variables)
from _torch_port_util import jax_sd as _sd
from _torch_port_util import running as _running
from uaps_tpu.methods import base as jbase
from uaps_tpu.methods import baseline as jbaseline
from uaps_tpu.models.unet import UNet as JaxUNet
from uaps_tpu_torch.kernels import ce_dice as kce
from uaps_tpu_torch.kernels import conv3x3_nchw as kconv
from uaps_tpu_torch.kernels import pool_nchw as kpool
from uaps_tpu_torch.methods import base, baseline
from uaps_tpu_torch.models import unet as tunet
from uaps_tpu_torch.utils.weights import load_jax_params

HW = (16, 128)
B = 2
FEATURES = (8, 16, 32, 64, 128)   # half the neu widths: a narrow model
STEPS = 3


def _cfgs():
    """The same config from each package's preset."""
    from uaps_tpu_torch.utils.config import preset as port_preset
    out = []
    for cfg in (neu_config("baseline", "float32"),
                port_preset("neu", method="baseline")):
        cfg.model = dataclasses.replace(cfg.model, compute_dtype="float32")
        cfg.data = dataclasses.replace(cfg.data, image_size=HW,
                                       batch_size=B)
        out.append(cfg)
    return out


def _batches():
    rng = np.random.default_rng(5)
    return [{"image": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "label": rng.integers(0, 4, (B, *HW)).astype(np.int32)}
            for _ in range(STEPS)]


def _jax_model(dtype):
    return JaxUNet(num_classes=4, features=FEATURES, dropout=(0.0,) * 5,
                   nchw_levels=2, conv_variant="dwmf", head_variant="dwmf",
                   dtype=dtype)


def _port_model(variables, dtype):
    m = tunet.UNet(4, 3, dtype, nchw_levels=2, head_variant="dwmf",
                   features=FEATURES, dropout=(0.0,) * 5)
    return load_jax_params(m, variables["params"], variables["batch_stats"])


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# the kernel-module functions whose calls the routing test counts
KERNEL_CALLS = [(tunet, "conv3x3_nchw"), (tunet, "max_pool_2x2_nchw"),
                (kconv, "conv3x3_nchw_dgrad"), (kconv, "conv3x3_nchw_wgrad"),
                (kpool, "max_pool_2x2_nchw_bwd"), (kce, "ce_dice_stats"),
                (kce, "ce_dice_bwd")]


@pytest.fixture(scope="module")
def runs():
    """JAX and port results of the same work at the seeded weights: the
    train-mode forward in f32; then, with f64 activations, its gradients,
    STEPS baseline steps and one eval step."""
    cfg, pcfg = _cfgs()
    v0 = seeded_variables(_jax_model(jnp.float32), HW, 17)
    batches = _batches()
    out = {"cfg": cfg, "v0": v0}

    # --- JAX
    jlogits, jbs = jax.jit(functools.partial(
        jbase.apply_train, _jax_model(jnp.float32), rngs={}))(
        v0["params"], v0["batch_stats"], batches[0]["image"])
    out["jax_f32"] = (np.asarray(jlogits), _running(_sd(v0["params"], jbs)))
    with jax.enable_x64(True):
        jm = _jax_model(jnp.float64)
        tx = jbase.make_optimizer(cfg.optim)
        state = jbase.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=v0["params"],
                                 batch_stats=v0["batch_stats"],
                                 opt_state=tx.init(v0["params"]),
                                 key=jax.random.key(0))
        step = jax.jit(jbaseline.make_train_step(cfg, jm, tx))
        out["jax_steps"] = []
        f32 = functools.partial(jax.tree.map,
                                lambda a: a.astype(jnp.float32))
        for b in batches:
            state, m = step(state, b)
            # the f64 learning rate of x64 mode lifts params and stats to
            # f64; both packages keep them in f32
            state = state.replace(params=f32(state.params),
                                  batch_stats=f32(state.batch_stats))
            out["jax_steps"].append(({k: float(v) for k, v in m.items()},
                                     _sd(state.params, state.batch_stats)))
            if len(out["jax_steps"]) == 1:
                # Adam's first moment after one step is (1 - b1) * grad
                mu = state.opt_state.inner_state[0].mu
                out["jax_grad"] = (m["loss"], _sd(jax.tree.map(
                    lambda a: a / (1 - cfg.optim.b1), mu)))
        ev = jax.jit(jbase.make_eval_step(cfg, jm))
        out["jax_eval"] = {k: float(v) for k, v in ev(
            v0["params"], v0["batch_stats"], batches[0]).items()}

    # --- port, with the kernel gates opened (see the module docstring)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tunet, "conv_kernel_ok", lambda *a: True)
        mp.setattr(tunet, "pool_pallas_ok", lambda x: True)
        counts = Counts(mp, KERNEL_CALLS)
        tb = _torch_batch(batches[0])
        model = _port_model(v0, torch.float32)
        with torch.no_grad():
            logits = base.apply_train(model, tb["image"], None)
        out["port_f32"] = (logits.numpy(), _running(
            {k: v.numpy() for k, v in model.state_dict().items()}))
        counts.n.clear()

        model = _port_model(v0, torch.float64)
        logits = base.apply_train(model, tb["image"], None)
        ce, dice = base.supervised_ce_dice(logits, tb["label"])
        loss = 0.5 * (ce + dice)
        loss.backward()
        out["port_grad"] = (float(loss.detach()), {
            k: p.grad.numpy() for k, p in model.named_parameters()})
        out["port_counts_fwd_bwd"] = dict(counts.n)

        model = _port_model(v0, torch.float64)
        pstate = base.init_model_state(pcfg, model)
        pstep = baseline.make_train_step(pcfg, model)
        out["port_steps"] = []
        for b in batches:
            pstate, m = pstep(pstate, _torch_batch(b))
            sd = {k: v.detach().clone().numpy()
                  for k, v in model.state_dict().items()}
            out["port_steps"].append(({k: float(v) for k, v in m.items()},
                                      sd))
        out["port_step_count"] = pstate.step
        out["port_eval"] = {k: float(v) for k, v in base.make_eval_step(
            pcfg, _port_model(v0, torch.float64))(tb).items()}
    return out


def test_unet_train_mode_matches_jax(runs):
    """f32 logits and the BN running stats after one train-mode forward
    (biased batch variance); every parameter gradient (f64 activations)."""
    jlogits, jbs = runs["jax_f32"]
    plogits, pbs = runs["port_f32"]
    np.testing.assert_allclose(plogits, jlogits, rtol=1e-3, atol=1e-4)
    assert set(pbs) == set(jbs)
    for k in jbs:
        np.testing.assert_allclose(pbs[k], jbs[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    jl, jg = runs["jax_grad"]
    pl_, pg = runs["port_grad"]
    np.testing.assert_allclose(pl_, jl, rtol=1e-5)
    assert set(pg) == set(jg)
    scale = max(np.abs(g).max() for g in jg.values())
    for k, g in jg.items():
        if k.endswith(ZERO_GRAD_BIASES):
            assert np.abs(g).max() < 1e-4 * scale, k
            assert np.abs(pg[k]).max() < 1e-4 * scale, k
        else:
            np.testing.assert_allclose(pg[k], g, rtol=1e-3,
                                       atol=1e-4 * np.abs(g).max(),
                                       err_msg=k)


def test_train_mode_routes_through_kernel_modules(runs):
    """One train-mode forward + backward at the neu routing: 9 convs, 8
    dgrads (none for the input conv), 9 wgrads, 2 pools each way and the
    fused CE+Dice forward and backward."""
    assert runs["port_counts_fwd_bwd"] == {
        "conv3x3_nchw": 9, "conv3x3_nchw_dgrad": 8, "conv3x3_nchw_wgrad": 9,
        "max_pool_2x2_nchw": 2, "max_pool_2x2_nchw_bwd": 2,
        "ce_dice_stats": 1, "ce_dice_bwd": 1}


@pytest.mark.parametrize("n_steps", [1, STEPS])
def test_baseline_steps_match_jax(runs, n_steps):
    """Losses and metrics of every step, then the params and BN stats after
    `n_steps` baseline steps (Adam, lr 1e-3)."""
    lr = runs["cfg"].optim.base_lr
    rtol = 1e-5 if n_steps == 1 else 1e-4
    for i in range(n_steps):
        jm, _ = runs["jax_steps"][i]
        pm, _ = runs["port_steps"][i]
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=rtol,
                                       err_msg=f"step {i + 1} {k}")
    _, jsd = runs["jax_steps"][n_steps - 1]
    _, psd = runs["port_steps"][n_steps - 1]
    jparams = {k: v for k, v in jsd.items() if "running" not in k}
    check_params(jparams, psd, runs["jax_grad"][1], n_steps, lr,
                  atol=2e-6 if n_steps == 1 else 2e-5)
    for k, sj in _running(jsd).items():
        np.testing.assert_allclose(
            psd[k], sj, rtol=1e-4,
            atol=1e-5 if n_steps == 1 or k.endswith("var") else 2 * lr,
            err_msg=k)
    assert runs["port_step_count"] == STEPS


def test_eval_step_matches_jax(runs):
    """make_eval_step at the seeded weights (eval BN with random running
    stats): val loss, CE, Dice loss, mIoU, mDice, accuracy."""
    jm, pm = runs["jax_eval"], runs["port_eval"]
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("pools", [{}, {"labeled_pool": 3, "hard": True}])
def test_synthetic_data_matches_jax(pools):
    """The port's copy of SyntheticDefects gives the JAX package's batches
    for a seed: both training streams and the validation stream."""
    from uaps_tpu.data.synthetic import SyntheticDefects as JaxData
    from uaps_tpu_torch.data import SyntheticDefects
    cfg = _cfgs()[1]
    jd, pd = JaxData(cfg.data, 3, **pools), SyntheticDefects(cfg.data, 3,
                                                              **pools)
    for a, b in ((next(jd.train_iter()), next(pd.train_iter())),
                 (next(jd.val_iter(1)), next(pd.val_iter(1)))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_trainer_one_epoch_on_cpu(tmp_path):
    """`python -m uaps_tpu_torch.train` with --device cpu: one epoch of two
    baseline steps on the synthetic data, validation, one metrics JSONL
    line and a best_model.pth that loads back strict; --resume is not
    ported and says so."""
    import json
    from uaps_tpu_torch import train
    from uaps_tpu_torch.utils.cli import parse_args
    from uaps_tpu_torch.utils.weights import load_pth
    argv = ["--preset", "synthetic", "--method", "baseline", "--device",
            "cpu", "--epochs", "1", "--iter_per_epoch", "2", "--batch_size",
            "2", "--dropout_backend", "xla", "--out_dir", str(tmp_path)]
    best = train.main(argv)
    (line,) = (tmp_path / "metrics.jsonl").read_text().splitlines()
    rec = json.loads(line)
    assert rec["step"] == 1 and rec["lr"] == 1e-3
    assert np.isfinite([rec[k] for k in ("loss", "ce_loss", "dice_loss",
                                         "val_loss", "val_ce")]).all()
    assert best == rec["val_mdice"]
    load_pth(base.build_model(parse_args(argv)[0], "cpu"),
             str(tmp_path / "best_model.pth"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(argv + ["--resume"])
