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
