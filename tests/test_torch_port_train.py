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
from _torch_port_util import (ZERO_GRAD_BIASES, Counts, check_params, jit,
                              neu_config, open_gates, seeded_variables)
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
    jlogits, jbs = jit(functools.partial(
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
        step = jit(jbaseline.make_train_step(cfg, jm, tx))
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
        ev = jit(jbase.make_eval_step(cfg, jm))
        out["jax_eval"] = {k: float(v) for k, v in ev(
            v0["params"], v0["batch_stats"], batches[0]).items()}

    # --- port, with the kernel gates opened (see the module docstring)
    with pytest.MonkeyPatch.context() as mp:
        open_gates(mp, HW[1])
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
    line and a best_model.pth that loads back strict; --resume with
    --epochs 2 goes on from the epoch-1 checkpoint (step 2) and writes
    epoch 2's line."""
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
    train.main(argv + ["--resume", "--epochs", "2"])
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in lines] == [1, 2]
    assert "resumed from step 2" in (tmp_path / "run.log").read_text()


@pytest.mark.parametrize("knob,value", [
    (None, None), ("steps_per_dispatch", 4), ("device_pools", True),
    ("save_every", 5), ("keep_checkpoints", 3), ("profile_steps", (2, 4)),
    ("debug_nans", True)])
def test_unported_run_knobs_raise(tmp_path, knob, value):
    """Every RunConfig knob that the JAX Trainer reads is ported: the
    Trainer builds with each set away from its default (and with the
    JAX-only prng_impl and use_shard_map), and takes it up: K and the
    pools, the checkpoint manager's keep, and debug_nans' single steps."""
    from uaps_tpu_torch import train
    cfg = _pool_cfg(tmp_path, "baseline", prng_impl="rbg",
                    use_shard_map=True)
    cfg.run = dataclasses.replace(cfg.run, **{"device_pools": False,
                                              **({knob: value} if knob
                                                 else {})})
    t = train.Trainer(cfg, device="cpu", data=_pool_data(cfg))
    assert t.ckpt.keep == cfg.run.keep_checkpoints
    assert t.ckpt.directory == str(tmp_path / "checkpoints")
    assert (t.pools is not None) == (knob == "device_pools")
    assert t.k_dispatch == (4 if knob == "steps_per_dispatch" else 1)
    assert (t.train_step.__name__ == "checked") == (knob == "debug_nans")


def test_unported_paths_still_raise():
    """--num_devices takes one GPU a rank: asking for more ranks than the
    visible GPUs (none here) raises before anything runs, with no fallback
    to gloo, a shared card or the CPU (tests/test_torch_port_parallel.py
    trains on ranks). The real-image pipeline is ported: without an image
    root make_data raises JAX's ValueError (tests/test_torch_port_data.py
    runs it on image files)."""
    from uaps_tpu_torch import train
    with pytest.raises(RuntimeError, match="visible GPUs"):
        train.main(["--num_devices", "2"])
    cfg = _cfgs()[1]
    cfg.data = dataclasses.replace(cfg.data, name="neu")
    with pytest.raises(ValueError, match="needs data.image_root"):
        train.make_data(cfg)


def test_steps_per_dispatch_rule():
    """K: 0 means 4 on a CUDA device and 1 on the CPU (JAX: 4 on a single
    TPU); profile_steps forces 1; a set K holds on either device."""
    from uaps_tpu_torch.dispatch import steps_per_dispatch
    from uaps_tpu_torch.utils.config import RunConfig
    assert steps_per_dispatch(RunConfig(), "cuda") == 4
    assert steps_per_dispatch(RunConfig(), "cpu") == 1
    assert steps_per_dispatch(RunConfig(steps_per_dispatch=3), "cpu") == 3
    assert steps_per_dispatch(RunConfig(steps_per_dispatch=3,
                                        profile_steps=(0, 1)), "cuda") == 1


def test_tensor_lr_adam_matches_float_lr():
    """make_optimizer's Adam (a 0-d lr tensor, filled in place by set_lr)
    against torch's Adam with a float lr on the same gradients: the same
    parameters bit for bit after 3 steps, and after 2 more once both lrs are
    set to 1e-4, which takes effect on the next step."""
    from uaps_tpu_torch.utils.config import OptimConfig
    rng = np.random.default_rng(3)
    init = [rng.standard_normal(s).astype(np.float32)
            for s in ((7, 5), (13,), (3, 3, 4, 2))]
    grads = [[rng.standard_normal(a.shape).astype(np.float32)
              for a in init] for _ in range(5)]
    cfg = OptimConfig()
    pa = [torch.tensor(a, requires_grad=True) for a in init]
    pb = [torch.tensor(a, requires_grad=True) for a in init]
    state = base.TrainState(0, base.make_optimizer(pa, cfg, "cpu"), None,
                            torch.zeros((), dtype=torch.int64))
    ref = torch.optim.Adam(pb, lr=cfg.base_lr, betas=(cfg.b1, cfg.b2),
                           eps=cfg.eps)
    lr = state.optimizer.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and lr.shape == ()
    assert base.get_lr(state) == cfg.base_lr
    before = None
    for i, gs in enumerate(grads):
        if i == 3:
            base.set_lr(state, 1e-4)
            for group in ref.param_groups:
                group["lr"] = 1e-4
            assert state.optimizer.param_groups[0]["lr"] is lr
            assert base.get_lr(state) == 1e-4
            before = [p.detach().clone() for p in pa]
        for p, q, g in zip(pa, pb, gs):
            p.grad, q.grad = torch.from_numpy(g), torch.from_numpy(g).clone()
        state.optimizer.step()
        ref.step()
        for p, q in zip(pa, pb):
            assert torch.equal(p, q), i
    # Adam's update is about lr a step: the two steps at 1e-4 moved the
    # parameters by at most ~2e-4
    moved = max(float((p - b).abs().max()) for p, b in zip(pa, before))
    assert 1e-5 < moved < 2.2e-4


def _pool_cfg(tmp_path, method="uaps", **run_kw):
    """The synthetic preset at 32 x 32, batch 2, one auxiliary decoder, 2
    epochs of 3 steps, with device pools (tests/test_device_pools.py's
    run, narrower)."""
    from uaps_tpu_torch.utils.config import preset
    cfg = preset("synthetic", method=method)
    cfg.data = dataclasses.replace(cfg.data, image_size=(32, 32),
                                   batch_size=2)
    cfg.model = dataclasses.replace(cfg.model, n_aux=1)
    cfg.run = dataclasses.replace(cfg.run, epochs=2, iter_per_epoch=3,
                                  seed=11, device_pools=True,
                                  out_dir=str(tmp_path), **run_kw)
    return cfg


def _pool_data(cfg, **kw):
    from uaps_tpu_torch.data import SyntheticDefects
    kw = {"labeled_pool": 8, "unlabeled_pool": 16, "val_pool": 4, **kw}
    return SyntheticDefects(cfg.data, seed=cfg.run.seed, **kw)


def test_device_pool_trainer_runs_and_learns(tmp_path):
    """Trainer with device pools on the CPU: batches sampled from the
    resident pools, the val sweep over the resident val pool, finite
    metrics and val mDice; two steps a dispatch (the K-step function, then
    one remainder step an epoch) train exactly as one a dispatch."""
    from uaps_tpu_torch import train
    runs = []
    for k in (2, 1):
        cfg = _pool_cfg(tmp_path / str(k), steps_per_dispatch=k)
        t = train.Trainer(cfg, device="cpu", data=_pool_data(cfg))
        assert t.pools is not None and t._val_pool is not None
        assert t.k_dispatch == k and t.graphed is None
        best = t.run()
        assert np.isfinite(best) and best >= 0
        assert t.state.step == int(t.state.counter) == 6
        runs.append(({n: v.clone() for n, v in t.model.state_dict().items()},
                     (tmp_path / str(k) / "metrics.jsonl").read_text()))
    (sd2, log2), (sd1, log1) = runs
    for n, v in sd1.items():
        assert torch.equal(sd2[n], v), n
    import json
    for a, b in zip(log2.splitlines(), log1.splitlines()):
        a, b = json.loads(a), json.loads(b)
        for key in ("loss", "sup_loss", "ps_loss", "val_mdice", "val_loss"):
            assert a[key] == b[key], key


def test_pool_val_sweep_matches_host_path(tmp_path):
    """The sweep over the resident val pool (sequential slices, the plain
    mean over batches) equals Trainer.validate's host path."""
    from uaps_tpu_torch import train
    cfg = _pool_cfg(tmp_path, "baseline")
    t = train.Trainer(cfg, device="cpu", data=_pool_data(cfg, val_pool=6))
    dev = t.validate()
    pool, t._val_pool = t._val_pool, None
    host = t.validate()
    assert pool is not None and dev.keys() == host.keys()
    for k in host:
        assert dev[k] == host[k], k


def test_pool_batches_deterministic_per_epoch():
    """The sampled indices are a function of (seed, epoch, step) alone: a
    sampler started at an epoch repeats that epoch's batches whatever ran
    before it, another epoch or seed draws others; every index lies in its
    pool, and over 4000 draws each of 8 indices comes up 500 +- 100
    times."""
    from uaps_tpu_torch.data.device_pool import PoolSampler
    from uaps_tpu_torch.utils.config import DataConfig
    from uaps_tpu_torch.data import SyntheticDefects
    cfg = DataConfig(image_size=(8, 8), batch_size=4)
    data = SyntheticDefects(cfg, seed=0, labeled_pool=8, unlabeled_pool=5)

    def epoch(sampler, e, steps=3):
        sampler.start_epoch(e)
        return torch.stack([sampler.indices() for _ in range(steps)])

    a, b = PoolSampler(data, 4, 11, "cpu"), PoolSampler(data, 4, 11, "cpu")
    first = epoch(a, 2)
    epoch(b, 1)
    epoch(b, 5)
    assert torch.equal(epoch(b, 2), first)
    assert not torch.equal(epoch(a, 3), first)
    assert not torch.equal(epoch(PoolSampler(data, 4, 12, "cpu"), 2), first)
    many = epoch(a, 7, steps=1000)
    assert int(many[:, :4].min()) >= 0 and int(many[:, :4].max()) == 7
    assert int(many[:, 4:].min()) >= 0 and int(many[:, 4:].max()) == 4
    counts = torch.bincount(many[:, :4].flatten(), minlength=8)
    assert int(counts.min()) >= 400 and int(counts.max()) <= 600, counts
    batch = a.sample()
    assert batch["image"].shape == (4, 8, 8, 3)
    assert batch["label"].dtype == torch.int32
    assert set(batch) == {"image", "label", "uimage"}


def test_cli_steps_per_dispatch_from_host_stream(tmp_path, caplog):
    """`python -m uaps_tpu_torch.train --steps_per_dispatch 2
    --device_pools` on the CPU with the CLI's synthetic data (no fixed
    pools: a warning, and the host stream): 3 baseline steps as one
    2-step dispatch of stacked host batches and one remainder step, with
    the same metrics as 3 single steps."""
    import json
    from uaps_tpu_torch import train
    argv = ["--preset", "synthetic", "--method", "baseline", "--device",
            "cpu", "--epochs", "1", "--iter_per_epoch", "3", "--batch_size",
            "2", "--dropout_backend", "xla"]
    recs = []
    for k in ("2", "1"):
        out = tmp_path / k
        with caplog.at_level("WARNING", logger="uaps"):
            train.main(argv + ["--steps_per_dispatch", k, "--device_pools",
                               "--out_dir", str(out)])
        (line,) = (out / "metrics.jsonl").read_text().splitlines()
        recs.append(json.loads(line))
    assert "device_pools requested but disabled" in caplog.text
    for key in ("loss", "ce_loss", "dice_loss", "train_mdice", "val_loss"):
        assert recs[0][key] == recs[1][key], key


def test_device_pools_disabled_without_pools(tmp_path, caplog):
    """device_pools on data without fixed pools: a warning naming the
    reason, and the Trainer keeps the host stream (as JAX does); a val
    pool that is no batch multiple: a warning, and the host val path,
    which sweeps the remainder batch too."""
    from uaps_tpu_torch import train
    from uaps_tpu_torch.data import SyntheticDefects
    cfg = _pool_cfg(tmp_path, "baseline")
    with caplog.at_level("WARNING", logger="uaps"):
        t = train.Trainer(cfg, device="cpu",
                          data=SyntheticDefects(cfg.data, seed=1))
        odd = train.Trainer(cfg, device="cpu",
                            data=_pool_data(cfg, val_pool=3))
    assert t.pools is None and t._val_pool is None
    assert "device_pools requested but disabled" in caplog.text
    assert "no fixed _pool/_upool" in caplog.text
    assert odd.pools is not None and odd._val_pool is None
    assert "val pool size 3 not a multiple of batch_size 2" in caplog.text


def test_profile_steps_writes_trace(tmp_path):
    """profile_steps=(0, 1) forces one step a dispatch and writes a
    torch.profiler trace of epoch 1's first two steps to out_dir/profile."""
    import json
    from uaps_tpu_torch import train
    cfg = _pool_cfg(tmp_path, "baseline", steps_per_dispatch=4,
                    profile_steps=(0, 1))
    cfg.run = dataclasses.replace(cfg.run, epochs=1, device_pools=False)
    t = train.Trainer(cfg, device="cpu", data=_pool_data(cfg))
    assert t.k_dispatch == 1
    t.run()
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert trace["traceEvents"]
