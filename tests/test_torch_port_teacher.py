"""The port's mean-teacher steps, `mt` and `uamt`, against the JAX package
on the CPU, with the EMA teacher; the uamt T-pass and the teacher's BN
stats; and the K-step function of a dispatch for mt.

The recipe of tests/test_torch_port_methods.py (`_torch_port_util`'s
`jax_method_runs`, `port_method_runs`, `check_method_steps`): the plain
U-Net with dropout 0 on both sides, the same seeded f32 weights for the
student and its teacher, 2 + 2 images of 16 x 128 at narrow widths, f64
activations, one `jax.jit` a method; the teacher's noise comes in through
JAX's hooks `tnoise` and `tnoise_T`, the same draws to both packages. Each
method takes 2 steps from step 0 (the EMA's alpha 0, then 1/2) and 2 from
consistency_start_iter exactly (1000: the first step mt's gate lets
through; alpha = ema_decay). uamt runs with uamt_num_samples = 2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from _torch_port_util import (check_method_steps, jax_runs, jit,
                              neu_config, port_method_runs, seeded_variables)
from uaps_tpu.methods import mt as jmt
from uaps_tpu.methods import uamt as juamt
from uaps_tpu.models.unet import UNet as JaxUNet
from uaps_tpu_torch import dispatch
from uaps_tpu_torch.methods import base, get_method
from uaps_tpu_torch.methods import uamt as puamt
from uaps_tpu_torch.models import unet as tunet
from uaps_tpu_torch.utils.weights import load_jax_params

HW = (16, 128)
B = 2
T = 2   # uamt_num_samples
FEATURES = (4, 8, 16, 32, 64)
STEPS = 2
METHODS = {"mt": jmt, "uamt": juamt}


def _cfgs(method):
    """The same config from each package's preset, f32, at HW and B, T
    teacher passes."""
    from uaps_tpu_torch.utils.config import preset as port_preset
    out = []
    for cfg in (neu_config(method, "float32"),
                port_preset("neu", method=method)):
        cfg.model = dataclasses.replace(cfg.model, compute_dtype="float32")
        cfg.data = dataclasses.replace(cfg.data, image_size=HW,
                                       batch_size=B)
        cfg.method = dataclasses.replace(cfg.method, uamt_num_samples=T)
        out.append(cfg)
    return out


def _jax_model(dtype):
    return JaxUNet(num_classes=4, features=FEATURES, dropout=(0.0,) * 5,
                   nchw_levels=2, conv_variant="dwmf", head_variant="dwmf",
                   dtype=dtype)


def _port_model(v0, dtype=torch.float64):
    m = tunet.UNet(4, 3, dtype, nchw_levels=2, head_variant="dwmf",
                   features=FEATURES, dropout=(0.0,) * 5)
    return load_jax_params(m, v0["params"], v0["batch_stats"])


def _noise(rng, n):
    return np.clip(0.1 * rng.standard_normal((n, *HW, 3)), -0.2,
                   0.2).astype(np.float32)


def _batches(method):
    rng = np.random.default_rng(52)
    out = []
    for _ in range(STEPS):
        b = {"image": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "uimage": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "label": rng.integers(0, 4, (B, *HW)).astype(np.int32),
             "tnoise": _noise(rng, B)}
        if method == "uamt":
            b["tnoise_T"] = _noise(rng, T * B)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def v0():
    return seeded_variables(_jax_model(jnp.float32), HW, 61)


@pytest.fixture(scope="module")
def teacher_runs(v0):
    """{method: (cfg, JAX runs, JAX step-1 gradients, port runs)}, from
    step 0 and from consistency_start_iter."""
    cases, jobs, out = {}, {}, {}
    for name, jmethod in METHODS.items():
        cfg, pcfg = _cfgs(name)
        batches = _batches(name)
        starts = (0, cfg.method.consistency_start_iter)
        cases[name] = (cfg, pcfg, batches, starts)
        jobs[name] = ((jmethod, cfg, _jax_model(jnp.float64), v0, batches,
                       starts), {"teacher": True})
    for name, (jruns, jgrads) in jax_runs(jobs):
        cfg, pcfg, batches, starts = cases[name]
        pruns = port_method_runs(get_method(name), pcfg,
                                 lambda: _port_model(v0), batches, starts,
                                 jruns, teacher=True)
        out[name] = (cfg, jruns, jgrads, pruns)
    return out


@pytest.mark.parametrize("start", ["step 0", "consistency_start_iter"])
@pytest.mark.parametrize("n_steps", [1, STEPS])
@pytest.mark.parametrize("method", list(METHODS))
def test_teacher_steps_match_jax(teacher_runs, method, start, n_steps):
    """Every metric and the state after each of the first n_steps steps:
    the student's params, BN stats and Adam moments, and the teacher's EMA
    params and its own BN stats (the first teacher pass moves them; uamt's
    T-pass leaves them), from step 0 (mt's consistency gated to 0) and from
    consistency_start_iter (the gate open)."""
    cfg, jruns, jgrads, pruns = teacher_runs[method]
    s0 = 0 if start == "step 0" else cfg.method.consistency_start_iter
    cons = jruns[s0][0]["metrics"]["consistency_loss"]
    assert (cons == 0) == (method == "mt" and s0 == 0), cons
    check_method_steps(jruns[s0][:n_steps], pruns[s0][:n_steps], jgrads[s0],
                       cfg.optim.base_lr)


def test_uamt_t_pass_leaves_teacher_stats(v0):
    """The T-pass (one train-mode forward of the T noised copies) gives
    JAX's entropy map and leaves every buffer of the teacher as it was,
    bit for bit, where a plain train-mode forward of the same batch moves
    the running stats."""
    pcfg = _cfgs("uamt")[1]
    model = _port_model(v0)
    state = base.init_model_state(pcfg, model)
    state.ema_model = base.make_teacher(model)
    rng = np.random.default_rng(3)
    rep = rng.standard_normal((T * B, *HW, 3)).astype(np.float32)
    before = {k: v.clone() for k, v in state.ema_model.state_dict().items()}
    got = puamt.uncertainty_samples(state, torch.from_numpy(rep), T)
    for k, v in state.ema_model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with jax.enable_x64(True):
        jm = _jax_model(jnp.float64)
        logits, _ = jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(v0, rep)
        soft = jax.nn.softmax(logits, -1)
        mean = jnp.mean(soft.reshape(T, B, *soft.shape[1:]), 0)
        ref = np.asarray(-jnp.sum(mean * jnp.log(mean + 1e-6), -1))
    assert got.shape == (B, *HW)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)
    from uaps_tpu_torch.methods.mt import teacher_softmax
    teacher_softmax(state, torch.from_numpy(rep))
    assert not torch.equal(
        state.ema_model.encoder.in_conv.conv_conv[1].running_mean,
        before["encoder.in_conv.conv_conv.1.running_mean"])


def test_mt_k_step_function_equals_its_steps(v0):
    """dispatch.run_steps, K = 2 mt steps in one call (what a CUDA graph of
    a dispatch captures), from step 999 (the gate opens at the second),
    with the teacher's noise drawn from the state's generator: the [K]
    metrics, the student's state dict and the teacher's equal two
    sequential steps from the same state and generator seed, bit for bit;
    the host step and the device counter advanced by K."""
    pcfg = _cfgs("mt")[1]
    batches = [{k: torch.from_numpy(v) for k, v in b.items()
                if k != "tnoise"} for b in _batches("mt")]
    out = []
    for k in (None, 2):
        model = _port_model(v0, torch.float32)
        state = base.init_model_state(pcfg, model)
        state.ema_model = base.make_teacher(model)
        state.step = pcfg.method.consistency_start_iter - 1
        step = get_method("mt").make_train_step(pcfg, model)
        if k is None:
            ms = []
            for b in batches:
                state, m = step(state, b)
                ms.append(m)
            metrics = {n: torch.stack([m[n] for m in ms]) for n in ms[0]}
        else:
            state, metrics = dispatch.run_steps(step, state,
                                                lambda i: batches[i], k)
        assert state.step == int(state.counter) == \
            pcfg.method.consistency_start_iter + 1
        out.append((metrics, model.state_dict(),
                    state.ema_model.state_dict()))
    (m1, sd1, ema1), (m2, sd2, ema2) = out
    assert set(m1) == set(m2)
    for n in m1:
        assert m2[n].shape == (2,) and torch.equal(m1[n], m2[n]), n
    assert float(m1["consistency_loss"][0]) == 0.0
    assert float(m1["consistency_loss"][1]) > 0.0
    for a, b in ((sd1, sd2), (ema1, ema2)):
        for n, v in a.items():
            assert torch.equal(v, b[n]), n
