"""The kernels' forwards as `torch.library` operators, namespace `uaps`.

Every kernel forward that an eval-mode forward of a port model can reach
is one operator with three implementations:

  * CUDA: the kernel module's ctypes launch, which ticks its launch
    counter (kernels/__init__.py);
  * CPU: the kernel's plain PyTorch version;
  * fake (`register_fake`, also the Meta kernel): shapes and dtypes only,
    so that `torch.export` traces through the launch.

The kernel modules' wrappers (and through them the models and the
autograd functions of training) call these operators on both devices, so
an exported program holds one `uaps::` node per kernel launch, and a
program exported on the CPU has the same nodes as one exported on the
card. A program saved by `torch.export.save` needs, to load and run, torch
and this module (which registers the operators): nothing else of the
package (uaps_tpu_torch/serve.py `ExportedEngine`).

The operators are functional: each returns fresh tensors, never a view of
an input. The dropout seed and rate of the chain conv are operator
arguments. The backward kernels are not operators: the autograd
functions of the kernel modules call them.

    uaps::conv3x3_nchw(x, w, out_dtype)          conv3x3_nchw.py (row 1)
    uaps::conv3x3_nchw_fullh(x, w)               conv3x3_nchw.py (row 3)
    uaps::conv3x3_nchw_stats(x, w) -> (y, mom)   conv3x3_nchw.py (row 5)
    uaps::max_pool_2x2_nchw(x)                   pool_nchw.py (row 6)
    uaps::conv3x3_bnl(y, f, s, w, out_dtype)     conv_bnl.py (row 13)
    uaps::chain_conv_plain(x, w) -> (y, mom)     block_conv.py (row 14)
    uaps::chain_conv_bnl(x, f, s, w, seed, rate) -> (y, mom)
    uaps::conv3x3_nhwc(x, w)                     conv3x3.py (row 15)

`mom` is the [2, Cout] f32 pair (sum, sum of squares) of y over (B, H, W).
"""
from __future__ import annotations

import torch

from uaps_tpu_torch.kernels import block_conv as bc
from uaps_tpu_torch.kernels import conv3x3 as nhwc
from uaps_tpu_torch.kernels import conv3x3_nchw as cn
from uaps_tpu_torch.kernels import conv_bnl as bnl
from uaps_tpu_torch.kernels import pool_nchw as pool

NAMESPACE = "uaps"
_lib = torch.library.Library(NAMESPACE, "DEF")   # lives as long as the module


def _define(schema: str, cuda, cpu, fake) -> None:
    name = schema.split("(")[0]
    _lib.define(schema)
    _lib.impl(name, cuda, "CUDA")
    _lib.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_lib)


def _nchw_out(x, cout, dtype):
    return x.new_empty((x.shape[0], cout, x.shape[2], x.shape[3]),
                       dtype=dtype)


def _moments_out(x, cout):
    return x.new_empty((2, cout), dtype=torch.float32)


# ------------------------------------------------------------- conv3x3_nchw
def _conv_cuda(x, w, out_dtype):
    y = cn._launch(x, w, out_dtype, flipped=False)
    cn.launches += 1
    return y


_define("conv3x3_nchw(Tensor x, Tensor w, ScalarType out_dtype) -> Tensor",
        _conv_cuda, cn.conv3x3_nchw_plain,
        lambda x, w, out_dtype: _nchw_out(x, w.shape[3], out_dtype))


def _fullh_cuda(x, w):
    y = cn._launch(x, w, x.dtype, flipped=False)
    cn.fullh_launches += 1
    return y


_define("conv3x3_nchw_fullh(Tensor x, Tensor w) -> Tensor",
        _fullh_cuda, cn.conv3x3_nchw_plain,
        lambda x, w: _nchw_out(x, w.shape[3], x.dtype))


def _stats_cuda(x, w):
    y, mom = bc.kernel_fwd(x.contiguous(), bc.w9(w, x.dtype), None, None,
                           None, 0.0, True, "conv3x3_nchw_stats")
    cn.stats_launches += 1
    return y, mom


def _plain_moments(y, s1, s2):
    return y, torch.stack([s1, s2])


_define("conv3x3_nchw_stats(Tensor x, Tensor w) -> (Tensor, Tensor)",
        _stats_cuda, lambda x, w: _plain_moments(*bc.chain_plain_ref(x, w)),
        lambda x, w: (_nchw_out(x, w.shape[3], x.dtype),
                      _moments_out(x, w.shape[3])))


# --------------------------------------------------------- max_pool_2x2_nchw
def _pool_fake(x):
    b, c, h, w = x.shape
    return x.new_empty((b, c, h // 2, w // 2))


_define("max_pool_2x2_nchw(Tensor x) -> Tensor",
        pool._launch_fwd, pool.max_pool_2x2_nchw_plain, _pool_fake)


# -------------------------------------------------------------- conv3x3_bnl
def _bnl_cuda(y, f, s, w, out_dtype):
    if out_dtype != y.dtype:
        raise TypeError(f"conv3x3_bnl: the kernel writes y's dtype "
                        f"{y.dtype}; asked for {out_dtype}")
    out, _ = bc.kernel_fwd(y.contiguous(), bc.w9(w, y.dtype), f, s, None,
                           0.0, False, "conv3x3_bnl")
    bnl.fwd_launches += 1
    return out


_define("conv3x3_bnl(Tensor y, Tensor f, Tensor s, Tensor w, "
        "ScalarType out_dtype) -> Tensor",
        _bnl_cuda, bnl.conv3x3_bnl_ref,
        lambda y, f, s, w, out_dtype: _nchw_out(y, w.shape[3], out_dtype))


# ------------------------------------------------------------- chain convs
def _chain_plain_cuda(x, w):
    y, mom = bc.kernel_fwd(x.contiguous(), bc.w9(w, x.dtype), None, None,
                           None, 0.0, True, "chain_conv_plain")
    bc.plain_launches += 1
    return y, mom


def _chain_bnl_cuda(x, f, s, w, seed, rate):
    y, mom = bc.kernel_fwd(x.contiguous(), bc.w9(w, x.dtype), f, s, seed,
                           rate, True, "chain_conv_bnl")
    bc.bnl_launches += 1
    return y, mom


def _chain_fake(x, w):
    return _nchw_out(x, w.shape[3], x.dtype), _moments_out(x, w.shape[3])


_define("chain_conv_plain(Tensor x, Tensor w) -> (Tensor, Tensor)",
        _chain_plain_cuda,
        lambda x, w: _plain_moments(*bc.chain_plain_ref(x, w)), _chain_fake)
_define("chain_conv_bnl(Tensor x, Tensor f, Tensor s, Tensor w, "
        "Tensor? seed, float rate) -> (Tensor, Tensor)",
        _chain_bnl_cuda,
        lambda x, f, s, w, seed, rate: _plain_moments(
            *bc.chain_bnl_ref(x, f, s, w, seed, rate)),
        lambda x, f, s, w, seed, rate: _chain_fake(x, w))


# ------------------------------------------------------------- conv3x3_nhwc
def _nhwc_cuda(x, w):
    y = nhwc._launch(x, w, flipped=False)
    nhwc.nhwc_launches += 1
    return y


_define("conv3x3_nhwc(Tensor x, Tensor w) -> Tensor",
        _nhwc_cuda, nhwc.conv3x3_forward_plain,
        lambda x, w: x.new_empty((*x.shape[:3], w.shape[3])))
