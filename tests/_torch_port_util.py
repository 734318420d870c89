"""Shared helpers of the tests/test_torch_port_*.py parity tests.

JAX models get cheap seeded variables: `jax.eval_shape(model.init, ...)`
gives the tree's shapes (about 2 s, where `model.init` takes 12-17 s on
this CPU) and numpy fills them from a seed; the same numbers then go to the
port through `load_jax_params`.

Every port test file imports `torch_threads`, an autouse fixture that caps
torch's intra-op threads at TORCH_THREADS (one) while the file's tests
run: the port's test tensors are small, and under `pytest -n 6` more
threads mostly take CPU from the worker that runs
tests/test_config_knobs.py, which bounds that run. One thread took two of
the heaviest files from 238 to 212 CPU-s at the same wall time (8-core
host, one process).

The JAX functions the tests build (the f64 steps, most f32 forwards)
build at XLA's optimisation level 0 (`jit`, COMPILE_OPTIONS) unless their
run is long (RUN_OPTIONS), and the fixtures
that need several of them build them one after the other (`jax_runs`):
the JAX halves are most of these tests' CPU time, and neither choice
changes what they compute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_ranks import (  # noqa: F401  (re-exported)
    open_gates, port_method_runs)
from uaps_tpu.utils.config import preset

TORCH_THREADS = 1
# compile options of the f64 JAX steps that the parity tests jit (`jit`):
# XLA's CPU backend at optimisation level 0 builds a train step with about
# half the CPU time of level 1 (LLVM's passes are most of a build), and a
# test's few steps at 32 px or 2 x 16 x 128 run about as fast; a step that
# runs long (dct's 128 x 128 steps) takes RUN_OPTIONS, level 1, whose
# build (~23 CPU-s for cct's step) costs less than level 0's slower run.
# Level 0's results are ~1e-16 apart in f64 from the default build's, far
# inside every tolerance here. The f32 forwards build at level 0 too where
# their comparisons hold as they did (the eval-mode forwards, `jax_main_only`);
# unet_f's train-mode forward keeps the default build, as level 0 moved two
# elements of its f4 feature 1.3e-5, past that test's atol of 1e-5.
COMPILE_OPTIONS = {"xla_backend_optimization_level": 0}
RUN_OPTIONS = {"xla_backend_optimization_level": 1}


def jit(fn, options=None, **kw):
    """jax.jit with `options` (default COMPILE_OPTIONS)."""
    return jax.jit(fn, compiler_options=options or COMPILE_OPTIONS, **kw)


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
    fn = jit(lambda v, xx: model.apply(v, xx, train=False, method=method))
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
    lifts them to f64), so that one compile serves every step (inside the
    jitted step, so the casts compile with it)."""
    return jax.tree.map(lambda n, o: n.astype(o.dtype)
                        if jnp.issubdtype(o.dtype, jnp.floating) else n,
                        new, old)


def _jax_net_record(state):
    """A JAX net's state as {torch name: numpy}: "sd" (params and BN
    stats) and Adam's "mu" and "nu"."""
    adam = state.opt_state.inner_state[0]
    return {"sd": jax_sd(state.params, state.batch_stats),
            "mu": jax_sd(adam.mu), "nu": jax_sd(adam.nu)}


def _jax_grad(record, cfg):
    """The step-1 gradient, from Adam's first moment after step 1 (a
    _jax_net_record), in numpy."""
    return {k: v / (1 - cfg.optim.b1) for k, v in record["mu"].items()}


def jax_method_runs(jmethod, cfg, jmodel, v0, batches, starts,
                    teacher=False, second=None, options=None, shards=1):
    """JAX's steps of `jmethod` (one jit) on `batches`, from each step count
    of `starts`, from the weights v0 (the teacher, with `teacher`, a copy
    of them; a second net, cps's `state.second`, from the weights
    `second`): ({start: [one record a step]}, {start: the step-1 gradient
    from Adam's first moment}). A record holds the step's "metrics" and the
    state after it as {torch name: numpy}: "sd" (params and BN stats),
    "ema" (the teacher's, or None), Adam's "mu" and "nu", and "second"
    (net 2's "sd", "mu", "nu" and its step-1 gradient "grad", or None).
    The step builds with `options` (`jit`). With `shards` > 1 the step is
    JAX's shard_map step in vmap form: the method's step with
    axis_name="data" under jax.vmap over the batches' `shards` row blocks
    (the state shared, `mix_w` given to every block), its replicated
    results read from block 0. Call under jax.enable_x64(True) with an
    f64 model."""
    from uaps_tpu.methods import base as jbase
    tx = jbase.make_optimizer(cfg.optim)
    if shards > 1:
        train_step = jax.vmap(
            jmethod.make_train_step(cfg, jmodel, tx, axis_name="data"),
            in_axes=(None, 0), axis_name="data")
        batches = [{k: np.stack([v] * shards) if k == "mix_w"
                    else v.reshape(shards, -1, *v.shape[1:])
                    for k, v in b.items()} for b in batches]
    else:
        train_step = jmethod.make_train_step(cfg, jmodel, tx)

    def step_fn(state, b):
        new, m = train_step(state, b)
        if shards > 1:
            new, m = jax.tree.map(lambda x: x[0], (new, m))
        return keep_dtypes(new, state), m

    step = jit(step_fn, options)

    runs, grads = {}, {}
    extra = ({"ema_params": v0["params"],
              "ema_batch_stats": v0["batch_stats"]} if teacher else {})
    for start in starts:
        if second is not None:
            extra["second"] = jbase.TrainState(
                step=jnp.asarray(start, jnp.int32),
                params=second["params"], batch_stats=second["batch_stats"],
                opt_state=tx.init(second["params"]), key=jax.random.key(1))
        state = jbase.TrainState(
            step=jnp.asarray(start, jnp.int32), params=v0["params"],
            batch_stats=v0["batch_stats"], opt_state=tx.init(v0["params"]),
            key=jax.random.key(0), **extra)
        runs[start] = []
        grad2 = None
        for b in batches:
            state, m = step(state, b)
            rec = {"metrics": {k: float(v) for k, v in m.items()},
                   **_jax_net_record(state),
                   "ema": (jax_sd(state.ema_params, state.ema_batch_stats)
                           if teacher else None),
                   "second": None}
            if not runs[start]:
                grads[start] = _jax_grad(rec, cfg)
            if second is not None:
                rec["second"] = _jax_net_record(state.second)
                if not runs[start]:
                    grad2 = _jax_grad(rec["second"], cfg)
                rec["second"]["grad"] = grad2
            runs[start].append(rec)
    return runs, grads


def jax_runs(jobs):
    """Yield (name, jax_method_runs(*args, **kw)) for jobs {name: (args,
    kw)}, one after the other under jax.enable_x64(True), so that the
    caller's work on a result comes before the next build."""
    for name, (args, kw) in jobs.items():
        with jax.enable_x64(True):
            yield name, jax_method_runs(*args, **kw)


def _check_net(where, jr, pr, jgrad, lr):
    """One net after a step: the params (check_params at atol 2e-6), the BN
    running stats and Adam's moments (check_method_steps)."""
    check_params({k: v for k, v in jr["sd"].items() if "running" not in k},
                 pr["sd"], jgrad, 1, lr, 2e-6)
    for k, sj in running(jr["sd"]).items():
        np.testing.assert_allclose(pr["sd"][k], sj, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{where} {k}")
    for moment in ("mu", "nu"):
        top = max(np.abs(v).max() for v in jr[moment].values())
        for k, v in jr[moment].items():
            np.testing.assert_allclose(
                pr[moment][k], v, rtol=1e-4, atol=1e-5 * top,
                err_msg=f"{where} {moment} {k}")


def check_method_steps(jruns, pruns, jgrad, lr):
    """After each step (the port's from JAX's state before it, from the
    second on: port_method_runs), every metric at rtol 1e-5, then the
    params (check_params at atol 2e-6), the BN running stats (rtol 1e-4,
    atol 1e-5) and Adam's moments (rtol 1e-4, atol 1e-5 of each moment's
    largest element: f32 gradients summed in another order), of the
    student, of cps's net 2 (against its own step-1 gradient) where the
    runs hold one, and the params and BN stats of the teacher where they
    hold one."""
    for i, (jr, pr) in enumerate(zip(jruns, pruns)):
        where = f"step {i + 1}"
        assert set(pr["metrics"]) == set(jr["metrics"])
        for k, v in jr["metrics"].items():
            np.testing.assert_allclose(pr["metrics"][k], v, rtol=1e-5,
                                       err_msg=f"{where} {k}")
        _check_net(where, jr, pr, jgrad, lr)
        if jr["second"] is not None:
            _check_net(f"{where} net 2", jr["second"], pr["second"],
                       jr["second"]["grad"], lr)
        if jr["ema"] is not None:
            check_params({k: v for k, v in jr["ema"].items()
                          if "running" not in k}, pr["ema"], jgrad, 1, lr,
                         2e-6)
            for k, sj in running(jr["ema"]).items():
                np.testing.assert_allclose(pr["ema"][k], sj, rtol=1e-4,
                                           atol=1e-5,
                                           err_msg=f"{where} ema {k}")
