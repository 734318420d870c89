"""The port's U-Net family against the JAX models, eval forward on the CPU.

Same seeded weights on both sides (tests/_torch_port_util.py), carried
across with `load_jax_params` (strict); full widths, 2 x 64 x 64 inputs,
the `neu` preset's knobs (nchw_levels=2, dwmf conv and head variants).
f32 logits are held to rtol 1e-3 / atol 1e-4 as tests/test_torch_import.py
holds the reference torch model; bf16 rounds at other places in the two
frameworks, so there the masks must agree on >= 99% of pixels.
"""
import functools

import jax  # noqa: F401  (jax before torch)
import numpy as np
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from _torch_port_util import (jax_main_only, neu_config, port_logits,
                              seeded_variables)
from uaps_tpu.methods.base import build_model as jax_build_model
from uaps_tpu_torch.kernels import conv3x3_nchw as kconv
from uaps_tpu_torch.kernels import pool_nchw as kpool
from uaps_tpu_torch.methods.base import build_model
from uaps_tpu_torch.models import unet as tunet
from uaps_tpu_torch.utils.weights import load_jax_params

HW = (64, 64)


@functools.lru_cache(maxsize=None)
def _variables(method, seed):
    """Seeded JAX variables per method (the tree is the same for every
    dtype and backend knob), shared by the tests of this file."""
    return seeded_variables(jax_build_model(neu_config(method)), HW, seed)


def _pair(method, dtype, seed, **model_kw):
    cfg = neu_config(method, dtype, **model_kw)
    jm = jax_build_model(cfg)
    variables = _variables(method, seed)
    tm = load_jax_params(build_model(cfg, "cpu"), variables["params"],
                         variables["batch_stats"])
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, *HW, 3)).astype(np.float32)
    return jax_main_only(jm, variables, x), port_logits(tm, x)


@pytest.mark.parametrize("method", ["uaps", "baseline"])
def test_main_only_f32_matches_jax(method):
    ref, got = _pair(method, "float32", seed=11)
    assert got.shape == ref.shape == (2, *HW, 4)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_main_only_xla_backend_f32_matches_jax():
    """conv_backend/head_variant 'xla' (plain torch everywhere)."""
    ref, got = _pair("uaps", "float32", seed=11, conv_backend="xla",
                     head_variant="xla")
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_main_only_bf16_masks_agree():
    ref, got = _pair("uaps", "bfloat16", seed=11)
    assert got.dtype == np.float32   # f32 logits from the bf16 head
    agree = (ref.argmax(-1) == got.argmax(-1)).mean()
    assert agree >= 0.99, agree


def test_neu_dispatch_routes_9_convs_and_2_pools(monkeypatch):
    """At 256 x 256 the neu knobs send exactly the 9 convs and 2 pools of
    the JAX Pallas path through the kernel wrappers (which run their twins
    on the CPU); conv_backend='xla' sends none."""
    calls = {"conv": [], "pool": []}

    def conv(x, w, out_dtype=None, variant="taps"):
        calls["conv"].append((x.shape[1], w.shape[3], x.shape[2], x.dtype,
                              out_dtype))
        return kconv.conv3x3_nchw(x, w, out_dtype, variant=variant)

    def pool(x):
        calls["pool"].append(tuple(x.shape[1:]))
        return kpool.max_pool_2x2_nchw(x)

    monkeypatch.setattr(tunet, "conv3x3_nchw", conv)
    monkeypatch.setattr(tunet, "max_pool_2x2_nchw", pool)
    x = torch.zeros((1, 256, 256, 3))
    model = build_model(neu_config("uaps", "bfloat16"), "cpu")
    with torch.inference_mode():
        out = model.main_only(x)
    assert out.shape == (1, 256, 256, 4) and out.dtype == torch.float32
    bf = torch.bfloat16
    assert calls["conv"] == [
        (3, 16, 256, bf, bf), (16, 16, 256, bf, bf),     # in_conv
        (16, 32, 128, bf, bf), (32, 32, 128, bf, bf),    # down1
        (64, 32, 128, bf, bf), (32, 32, 128, bf, bf),    # up3
        (32, 16, 256, bf, bf), (16, 16, 256, bf, bf),    # up4
        (16, 4, 256, bf, torch.float32)]                 # logits head
    assert calls["pool"] == [(16, 256, 256), (32, 128, 128)]
    calls["conv"].clear()
    calls["pool"].clear()
    plain = build_model(neu_config("uaps", "bfloat16", conv_backend="xla"),
                        "cpu")
    with torch.inference_mode():
        plain.main_only(x)
    assert calls == {"conv": [], "pool": []}


def test_state_dict_names_match_export():
    """Every port module holds exactly the reference's torch names."""
    from uaps_tpu.utils.torch_import import export_state_dict
    for method, top in [("uaps", "main_decoder"), ("baseline", "decoder")]:
        cfg = neu_config(method)
        variables = _variables(method, 11)
        names = set(export_state_dict(variables["params"],
                                      variables["batch_stats"]))
        port = set(build_model(cfg, "cpu").state_dict())
        assert port == names
        assert f"{top}.out_conv.weight" in port
        assert "encoder.down4.maxpool_conv.1.conv_conv.5.running_var" in port


@pytest.mark.parametrize("knob,value", [
    ("packed_heads", True), ("stack_decoders", True)])
def test_unported_knobs_raise(knob, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(neu_config("uaps", **{knob: value}), "cpu")


def test_bad_enum_and_training_forward_raise():
    """A bad enum raises; the perturbed multi-decoder forward needs a
    generator (for its perturbations, in eval mode too) and returns the 4
    decoders' logits; train mode runs main_only with dropout from an
    explicit generator, and the fused dropout module ("pallas") runs its
    plain version on the CPU, drawing what the plain ops ("xla") draw."""
    with pytest.raises(ValueError, match="conv_variant"):
        build_model(neu_config("uaps", conv_variant="bogus"), "cpu")
    model = build_model(neu_config("uaps"), "cpu")
    x = torch.zeros((1, 64, 64, 3))
    with torch.no_grad():
        with pytest.raises(ValueError, match="torch.Generator"):
            model(x)
        outs = model(x, torch.Generator())
        assert len(outs) == 4
        assert all(o.shape == (1, 64, 64, 4) for o in outs)
    model.train()
    with torch.no_grad():
        with pytest.raises(ValueError, match="torch.Generator"):
            model.main_only(x)
        assert model.main_only(x, torch.Generator()).shape == (1, 64, 64, 4)
        ys = []
        for backend in ("pallas", "xla"):
            drop = build_model(neu_config("uaps", dropout_backend=backend),
                               "cpu").train()
            ys.append(drop.main_only(x + 1, torch.Generator().manual_seed(3)))
        assert torch.equal(ys[0], ys[1])


def test_init_matches_flax_statistics():
    """lecun_normal: truncated at 2 std, std sqrt(1/fan_in); zero biases,
    BN ones/zeros; the same generator seed gives the same weights."""
    cfg = neu_config("uaps")
    a = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
    b = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.encoder.down4.maxpool_conv[1].conv_conv[0].weight   # 128 -> 256
    std = (1.0 / (128 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    bn = a.encoder.in_conv.conv_conv[1]
    assert torch.equal(bn.weight, torch.ones(16))
    assert torch.equal(bn.running_var, torch.ones(16))
    assert torch.equal(a.main_decoder.out_conv.bias, torch.zeros(4))
