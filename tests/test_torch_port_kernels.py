"""The port's kernel modules against the JAX Pallas kernels (interpret mode).

On the CPU each port wrapper runs its plain twin; these tests hold the twin
to the Pallas kernel on the same numpy inputs, at the small shapes of
tests/test_pallas.py (2 x Cin x 16 x 128). The CUDA kernels themselves are
held to the twins on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uaps_tpu_torch.kernels import _build
from uaps_tpu_torch.kernels import conv3x3_nchw as kconv
from uaps_tpu_torch.kernels import pool_nchw as kpool

H, W = 16, 128


def _bf16(a):
    """numpy f32 values rounded to bf16 (exact in both frameworks)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 32), (64, 32)])
def test_conv_flat_matches_pallas(cin, cout):
    """conv3x3_fast_flat, f32: the ConvBlock convs (in_conv's Cin=3 is the
    unaligned case)."""
    from uaps_tpu.pallas.conv3x3_nchw import conv3x3_fast_flat
    rng = np.random.default_rng(cin * 100 + cout)
    x = rng.standard_normal((2, cin, H * W)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout))
         / np.sqrt(9 * cin)).astype(np.float32)
    ref = np.asarray(conv3x3_fast_flat(jnp.asarray(x), jnp.asarray(w),
                                       (H, W), True))
    before = kconv.launches
    got = kconv.conv3x3_fast_flat(torch.from_numpy(x), torch.from_numpy(w),
                                  (H, W))
    assert got.shape == (2, cout, H * W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert kconv.launches == before   # CPU tensors never reach the kernel


def test_conv_head_bf16_in_f32_out_matches_pallas():
    """conv3x3_fast_nchw as the logits head: bf16 in, f32 out, Cout=4."""
    from uaps_tpu.pallas.conv3x3_nchw import conv3x3_fast_nchw
    rng = np.random.default_rng(4)
    x = _bf16(rng.standard_normal((2, 16, H, W)))
    w = _bf16(rng.standard_normal((3, 3, 16, 4)) / 12.0)
    ref = np.asarray(conv3x3_fast_nchw(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), True,
        "dwmf", jnp.float32))
    got = kconv.conv3x3_fast_nchw(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(w).to(torch.bfloat16), torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _pool_input(rng, with_inf):
    # quantised values force in-window ties
    x = (np.round(rng.standard_normal((2, 16, 32, W)) * 2) / 2)
    if with_inf:
        # single -inf entries; a window of only -inf (or any +inf) poisons
        # the Pallas kernel's selection matmul (inf * 0 = NaN), a fault of
        # the reference recorded in ROADMAP.md Queue C
        x[0, 0, 0, 0] = -np.inf
        x[1, 5, 7, 33] = -np.inf
        x[1, 15, 31, W - 1] = -np.inf
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype,with_inf", [
    ("float32", False), ("float32", True), ("bfloat16", True)])
def test_pool_matches_pallas(dtype, with_inf):
    from uaps_tpu.pallas.pool_nchw import max_pool_2x2_nchw
    x = _pool_input(np.random.default_rng(7), with_inf)
    ref = np.asarray(max_pool_2x2_nchw(jnp.asarray(x, dtype), True)
                     .astype(jnp.float32))
    before = kpool.launches
    got = kpool.max_pool_2x2_nchw(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert kpool.launches == before


def test_pool_gate_matches_jax():
    from uaps_tpu.pallas.pool_nchw import pool_pallas_ok as jax_ok
    for shape in [(1, 16, 256, 256), (1, 32, 128, 128), (1, 64, 64, 64),
                  (1, 16, 20, 128), (1, 64, 256, 256), (2, 8, 32, 256)]:
        assert kpool.pool_pallas_ok(torch.zeros(shape)) == jax_ok(
            jnp.zeros(shape)), shape


def test_forward_only_and_device_guards():
    x = torch.zeros((1, 4, 16, 128), requires_grad=True)
    w = torch.zeros((3, 3, 4, 8))
    with pytest.raises(RuntimeError, match="forward-only"):
        kconv.conv3x3_nchw(x, w)
    with pytest.raises(RuntimeError, match="forward-only"):
        kpool.max_pool_2x2_nchw(x)
    with torch.no_grad():
        assert kconv.conv3x3_nchw(x, w).shape == (1, 8, 16, 128)
    meta = torch.zeros((1, 4, 16, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        kconv.conv3x3_nchw(meta, w.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        kpool.max_pool_2x2_nchw(meta)
    with pytest.raises(ValueError, match=r"\[3,3,Cin,Cout\]"):
        kconv.conv3x3_nchw(torch.zeros((1, 5, 16, 128)), w)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    assert _build.sources() == ["conv3x3_nchw", "pool_nchw"]
