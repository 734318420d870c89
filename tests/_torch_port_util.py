"""Shared helpers of the tests/test_torch_port_*.py parity tests.

JAX models get cheap seeded variables: `jax.eval_shape(model.init, ...)`
gives the tree's shapes (about 2 s, where `model.init` takes 12-17 s on
this CPU) and numpy fills them from a seed; the same numbers then go to the
port through `load_jax_params`.

Every port test file imports `torch_threads`, an autouse fixture that caps
torch's intra-op threads at TORCH_THREADS while the file's tests run: the
port's test tensors are small, and under `pytest -n 6` torch's default (one
thread per core) mostly takes CPU from the workers running the JAX
package's tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uaps_tpu.utils.config import preset

TORCH_THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """torch's intra-op threads capped at TORCH_THREADS for the module's
    tests and fixtures, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


def neu_config(method="uaps", dtype="float32", **model_kw):
    cfg = preset("neu", method=method)
    cfg.model = dataclasses.replace(cfg.model, compute_dtype=dtype,
                                    **model_kw)
    return cfg


_SHAPES = {}


def _variable_shapes(model, hw, channels):
    """The variable tree's shapes, traced once per model configuration (a
    flax module's repr lists every field) and input shape."""
    key = (repr(model), tuple(hw), channels)
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(
            lambda: model.init({"params": jax.random.key(0),
                                "dropout": jax.random.key(1),
                                "perturb": jax.random.key(2)},
                               jnp.zeros((1, *hw, channels)), train=False))
    return _SHAPES[key]


def seeded_variables(model, hw, seed, channels=3):
    """{'params', 'batch_stats'} for a flax model on `channels`-channel
    images, filled from a numpy seed: lecun-scaled normal kernels, small
    biases, BN scale near 1, BN running mean near 0 and running var from
    U(0.5, 1.5)."""
    shapes = _variable_shapes(model, hw, channels)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = jax.tree_util.keystr(path)
        if leaf.endswith("['var']"):
            v = rng.uniform(0.5, 1.5, s.shape)
        elif leaf.endswith("['mean']"):
            v = 0.1 * rng.standard_normal(s.shape)
        elif leaf.endswith("['scale']"):
            v = rng.uniform(0.8, 1.2, s.shape)
        elif leaf.endswith("['bias']"):
            v = 0.05 * rng.standard_normal(s.shape)
        else:   # conv kernel, HWIO
            v = (rng.standard_normal(s.shape)
                 / np.sqrt(np.prod(s.shape[:-1])))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_main_only(model, variables, x):
    """JAX eval logits (NHWC, numpy): main_only where the model has it."""
    method = getattr(model, "main_only", None)
    fn = jax.jit(lambda v, xx: model.apply(v, xx, train=False,
                                           method=method))
    return np.asarray(fn(variables, jnp.asarray(x)))


def port_logits(model, x):
    with torch.inference_mode():
        fwd = getattr(model, "main_only", model)
        return fwd(torch.from_numpy(x)).numpy()


# the biases of the convs that feed a train-mode BN: their exact gradient is
# 0 (BN subtracts the batch mean), so both packages give rounding noise
ZERO_GRAD_BIASES = ("conv_conv.0.bias", "conv_conv.4.bias")


def jax_sd(params, stats=None):
    """{torch name: numpy} of JAX trees (params, grads, batch stats)."""
    from uaps_tpu_torch.utils.weights import state_dict_from_jax
    return {k: v.numpy()
            for k, v in state_dict_from_jax(params, stats or {}).items()
            if not k.endswith("num_batches_tracked")}


def running(sd):
    return {k: v for k, v in sd.items() if "running" in k}


def check_params(jparams, psd, jgrad, steps, lr, atol, noise=1e-6):
    """Params after `steps` Adam steps: elements whose JAX step-1 gradient
    is at the packages' rounding noise (below `noise` of the largest, or a
    BN-fed conv bias) held to 2 * steps * lr * 1.05, the rest to `atol`
    (tests/test_torch_port_train.py docstring)."""
    scale = max(np.abs(g).max() for g in jgrad.values())
    for k, pj in jparams.items():
        pp = psd[k]
        noisy = np.abs(jgrad[k]) < noise * scale
        if k.endswith(ZERO_GRAD_BIASES):
            noisy[...] = True
        bound = 2 * steps * lr * 1.05
        assert np.abs(pp - pj)[noisy].max(initial=0.0) <= bound, k
        np.testing.assert_allclose(pp[~noisy], pj[~noisy], rtol=0,
                                   atol=atol, err_msg=k)


class Counts:
    """Counts calls of the port's kernel-module functions (the launch
    counters stay 0 on the CPU): `targets` are (module, attribute) pairs,
    patched through the monkeypatch `mp`."""

    def __init__(self, mp, targets):
        self.n = {}
        for mod, name in targets:
            mp.setattr(mod, name, self._wrap(name, getattr(mod, name)))

    def _wrap(self, name, fn):
        def counted(*a, **kw):
            self.n[name] = self.n.get(name, 0) + 1
            return fn(*a, **kw)
        return counted


# ------------------------------------------- a method's steps, both packages
def keep_dtypes(new, old):
    """The JAX tree `new` with every float leaf at `old`'s dtype (x64 mode
    lifts them to f64), so that one compile serves every step."""
    return jax.tree.map(lambda n, o: n.astype(o.dtype)
                        if jnp.issubdtype(o.dtype, jnp.floating) else n,
                        new, old)


def jax_method_runs(jmethod, cfg, jmodel, v0, batches, starts,
                    teacher=False):
    """JAX's steps of `jmethod` (one jit) on `batches`, from each step count
    of `starts`, from the weights v0 (the teacher, with `teacher`, a copy
    of them): ({start: [one record a step]}, {start: the step-1 gradient
    from Adam's first moment}). A record holds the step's "metrics" and the
    state after it as {torch name: numpy}: "sd" (params and BN stats),
    "ema" (the teacher's, or None) and Adam's "mu" and "nu". Call under
    jax.enable_x64(True) with an f64 model."""
    from uaps_tpu.methods import base as jbase
    tx = jbase.make_optimizer(cfg.optim)
    step = jax.jit(jmethod.make_train_step(cfg, jmodel, tx))
    runs, grads = {}, {}
    extra = ({"ema_params": v0["params"],
              "ema_batch_stats": v0["batch_stats"]} if teacher else {})
    for start in starts:
        state = jbase.TrainState(
            step=jnp.asarray(start, jnp.int32), params=v0["params"],
            batch_stats=v0["batch_stats"], opt_state=tx.init(v0["params"]),
            key=jax.random.key(0), **extra)
        runs[start] = []
        for b in batches:
            new, m = step(state, b)
            state = keep_dtypes(new, state)
            adam = state.opt_state.inner_state[0]
            if not runs[start]:
                grads[start] = jax_sd(jax.tree.map(
                    lambda a: a / (1 - cfg.optim.b1), adam.mu))
            runs[start].append({
                "metrics": {k: float(v) for k, v in m.items()},
                "sd": jax_sd(state.params, state.batch_stats),
                "ema": (jax_sd(state.ema_params, state.ema_batch_stats)
                        if teacher else None),
                "mu": jax_sd(adam.mu), "nu": jax_sd(adam.nu)})
    return runs, grads


def _load(module, sd):
    """Copy {torch name: numpy} into the module's tensors of those names."""
    with torch.no_grad():
        for k, t in module.state_dict().items():
            if k in sd:
                t.copy_(torch.from_numpy(np.asarray(sd[k])))


def port_method_runs(pmethod, pcfg, make_model, batches, starts, jax_runs,
                     teacher=False):
    """The port's steps of `pmethod` on `batches` from each step count of
    `starts`, a fresh `make_model()` each time (and, with `teacher`, the
    mean teacher as its copy), with the kernel shape gates opened, so that
    the level-0/1 convs and pools go through the kernel modules (their
    plain versions on the CPU) as at 256 px on the GPU: {start: [one
    record a step, as jax_method_runs's]}.

    Every step after the first starts from JAX's state after the step
    before (`jax_runs`: params, BN stats, the teacher, Adam's moments),
    once the port's own state after that step is recorded (and compared by
    check_method_steps). Run on from its own state, the port drifted from
    JAX at step 2 beyond check_params' tolerances in places (cct past the
    ramp, ucc from step 0): the f32 logits heads of both packages leave
    gradient noise that decides Adam's step-1 update of the elements whose
    gradient is near Adam's eps, and the parameters that differ so move
    some LeakyReLU input of step 2 across its kink at 2 x 16 x 128."""
    from uaps_tpu_torch.methods import base
    from uaps_tpu_torch.models import unet as tunet

    def sd(m):
        return {k: v.detach().clone().numpy()
                for k, v in m.state_dict().items()}

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tunet, "conv_kernel_ok", lambda *a: True)
        mp.setattr(tunet, "pool_pallas_ok", lambda x: True)
        for start in starts:
            model = make_model()
            state = base.init_model_state(pcfg, model)
            if teacher:
                state.ema_model = base.make_teacher(model)
            state.step = start
            step = pmethod.make_train_step(pcfg, model)
            named = dict(model.named_parameters())
            runs[start] = []
            for i, b in enumerate(batches):
                if i:
                    prev = jax_runs[start][i - 1]
                    _load(model, prev["sd"])
                    if teacher:
                        _load(state.ema_model, prev["ema"])
                    with torch.no_grad():
                        for k, p in named.items():
                            st = state.optimizer.state[p]
                            st["exp_avg"].copy_(torch.from_numpy(
                                prev["mu"][k]))
                            st["exp_avg_sq"].copy_(torch.from_numpy(
                                prev["nu"][k]))
                state, m = step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
                adam = {k: state.optimizer.state[p]
                        for k, p in named.items()}
                runs[start].append({
                    "metrics": {k: float(v) for k, v in m.items()},
                    "sd": sd(model),
                    "ema": sd(state.ema_model) if teacher else None,
                    "mu": {k: a["exp_avg"].numpy().copy()
                           for k, a in adam.items()},
                    "nu": {k: a["exp_avg_sq"].numpy().copy()
                           for k, a in adam.items()}})
            assert state.step == int(state.counter) == start + len(batches)
    return runs


def check_method_steps(jruns, pruns, jgrad, lr):
    """After each step (the port's from JAX's state before it, from the
    second on: port_method_runs), every metric at rtol 1e-5, then the
    params (check_params at atol 2e-6), the BN running stats (rtol 1e-4,
    atol 1e-5) and Adam's moments (rtol 1e-4, atol 1e-5 of each moment's
    largest element: f32 gradients summed in another order), of the
    student and, where the runs hold one, of the
    teacher."""
    for i, (jr, pr) in enumerate(zip(jruns, pruns)):
        where = f"step {i + 1}"
        assert set(pr["metrics"]) == set(jr["metrics"])
        for k, v in jr["metrics"].items():
            np.testing.assert_allclose(pr["metrics"][k], v, rtol=1e-5,
                                       err_msg=f"{where} {k}")
        for j, p in ((jr["sd"], pr["sd"]), (jr["ema"], pr["ema"])):
            if j is None:
                continue
            check_params({k: v for k, v in j.items() if "running" not in k},
                         p, jgrad, 1, lr, 2e-6)
            for k, sj in running(j).items():
                np.testing.assert_allclose(p[k], sj, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{where} {k}")
        for moment in ("mu", "nu"):
            top = max(np.abs(v).max() for v in jr[moment].values())
            for k, v in jr[moment].items():
                np.testing.assert_allclose(
                    pr[moment][k], v, rtol=1e-4, atol=1e-5 * top,
                    err_msg=f"{where} {moment} {k}")
