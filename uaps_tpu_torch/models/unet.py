"""U-Net building blocks, the multi-decoder and deep-supervision families,
NCHW.

Counterpart of `uaps_tpu/models/unet.py`. Module names follow the reference
torch code (`conv_conv.{0,1,4,5}`, `maxpool_conv.1`, `conv1x1`, `out_conv`),
so state dicts from `utils.weights.state_dict_from_jax` and reference
`.pth` files load with `strict=True`.

Matching the JAX model:
  * activations are NCHW at every level; the models take NHWC images and
    return NHWC logits, as the JAX models do;
  * parameters stay f32 and are cast to the compute dtype on the fly;
    ConvBlock convs output the compute dtype with the bias added in it, the
    logits head outputs f32 logits, eval BN normalises in f32 and casts back
    (flax `nn.BatchNorm` with `dtype=bf16`);
  * UpBlock is conv1x1 then bilinear x2 with align_corners=True (as two
    interpolation matmuls), then concat [skip, up]; LeakyReLU slope 0.01,
    BN eps 1e-5;
  * kernel dispatch mirrors the JAX gates: a ConvBlock's 3x3 conv runs
    the CUDA conv (kernels/conv3x3_nchw.py) wherever conv_backend != "xla"
    and the shape gate holds (H, W >= 128, H % 8 == 0, W % 128 == 0,
    Cout <= 32, Cin <= 64), at every level: JAX's `Conv3x3` takes the
    Pallas conv at its NCHW levels and, between two transposes
    (`conv3x3_fast`), at its NHWC levels too, so nchw_levels does not
    decide it; a 2x2 pool whose input level is < nchw_levels runs the
    CUDA pool where `pool_pallas_ok` holds and the backends allow it (JAX's
    NHWC pool is XLA's). The ConvBlock convs take ModelConfig.conv_variant and
    the head head_variant, as in JAX: "fullh" runs the fullh entries (their
    own launch counters; a bf16 fullh conv rounds its output to bf16 before
    any cast), every other Pallas variant name the default entries of the
    same CUDA kernels; "xla" means plain torch. On CPU tensors the kernel
    wrappers run their plain versions. The kernel conv and pool are
    autograd functions whose backward is the JAX VJP on kernels too (dgrad,
    wgrad, pool backward).

Train mode (`model.train()`), as flax computes it:
  * BN normalises with the batch mean and the biased batch variance
    (E[x^2] - E[x]^2 in f32, clipped at 0) and updates the running stats
    with that biased variance: running = 0.9 running + 0.1 batch (flax
    momentum 0.9, torch momentum 0.1); `nn.BatchNorm2d` would use the
    unbiased variance there;
  * dropout draws one seed per level from the `generator` the caller
    passes to `forward` (flax's "dropout" rng) and keeps an element by the
    counter-based generator of `kernels/perturb.py`; kept values are scaled
    by 1 / (1 - p) in f32 and cast once. dropout_backend "auto" (where the
    conv kernels are on) and "pallas" run the fused dropout module (the
    CUDA kernel on the GPU, its plain version on the CPU); "xla", and
    "auto" with conv_backend="xla", run the plain ops. Both draw the same
    masks from the same seeds.

ConvBlock recipes, in JAX's order (models/unet.py:312-349), at the levels
below nchw_levels (JAX's NCHW levels); deeper levels keep the default
block, its convs gated by shape alone:
  * "chain": conv1 emits its output's moments (kernels/block_conv.py
    `chain_conv_plain`), `BNFactorShift` turns them into BN's per-channel
    factor and shift, conv2 applies normalise + LeakyReLU + the level's
    dropout (train mode only; the position-hashed mask, seeded by the
    level's seed) to its input and emits its moments (`chain_conv_bnl`), and
    the block ends with y2 * f2 + sh2 and LeakyReLU in the compute dtype.
    The Dropout module is not applied there;
  * "fused": only blocks with dropout rate 0 (the decoders' up3 and up4);
    conv1 is the plain conv without its bias, its moments come from torch
    reductions, conv2 is `conv3x3_bnl` (kernels/conv_bnl.py).
  * `ConvBlock(bn_stats=True)` (no config field sets it, as in JAX): each
    conv returns its output's moments with the bias folded in (`Conv3x3(...,
    return_stats=True)`; the stats kernel, `conv3x3_fast_nchw_stats`, where
    the variant is "taps" and the kernel is allowed, else the variant's conv
    and f32 sums of its output), and `StatsBatchNorm` normalises with them;
  * bn_backend="flat": the default convs, then `StatsBatchNorm` fed by f32
    sums of each conv's output (JAX reduces the flat [B, C, H*W] view: the
    same sums).
  * otherwise the default block (`BatchNorm`).
The fused blocks run their kernel modules under the JAX gate
(`conv_kernel_ok` of the block's input), their plain versions elsewhere;
their conv biases fold into BN: in train mode they cancel and get no
gradient (None; JAX's is an exact zero), and only the running mean sees
them. `StatsBatchNorm` rounds BN's factor and shift to the compute dtype
before x * factor + shift, as the chain's last step does (JAX's recipe;
`BatchNorm` normalises in f32 and casts once). Module names and state dicts
are the default block's.

The multi-decoder forward (`MultiDecoderUNet.forward`) runs the encoder
once, the main decoder on its features and aux decoder i on the features
perturbed by `perturbations[i]` (all 5 skips, one seed each, drawn from the
generator after the encoder's). The perturbations apply in eval mode too,
as in JAX; only the encoder's dropout is train-only.

The deep-supervision net (`DeepSupervisionUNet`: unet_f, unet_g, unet_h,
the nets of cps) has no NCHW level in JAX: its pools are plain, its
ConvBlock convs take the kernel conv by the shape gate alone, and its four
logits heads are flax `nn.Conv` in f32 (plain `F.conv2d` here). Its forward
returns dp0, the one output JAX's cps step and eval read (XLA drops the
rest); `full=True` returns JAX's dict.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from uaps_tpu_torch.kernels.block_conv import (chain_bnl_ref, chain_conv_bnl,
                                               chain_conv_plain,
                                               chain_plain_ref, moments)
from uaps_tpu_torch.kernels.conv3x3_nchw import (conv3x3_fast_nchw_stats,
                                                 conv3x3_nchw, conv_kernel_ok)
from uaps_tpu_torch.kernels.conv_bnl import conv3x3_bnl, conv3x3_bnl_ref
from uaps_tpu_torch.kernels.perturb import fused_dropout
from uaps_tpu_torch.kernels.pool_nchw import (max_pool_2x2_nchw,
                                              pool_pallas_ok)
from uaps_tpu_torch.ops.perturbations import dropout, perturb_features
from uaps_tpu_torch.parallel import ranks

# Reference channel/dropout schedule (UAPS_unet.py:192-197)
UNET_FEATURES: Tuple[int, ...] = (16, 32, 64, 128, 256)
UNET_DROPOUT: Tuple[float, ...] = (0.05, 0.1, 0.2, 0.3, 0.5)

SKIPS = 5   # skip tensors the encoder hands to each decoder


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in `dtype`; t itself where it is already (no cast in an exported
    program's graph)."""
    return t if t.dtype == dtype else t.to(dtype)


def draw_seeds(generator: Optional[torch.Generator], n: int,
               device: torch.device) -> torch.Tensor:
    """n int64 seeds in [0, 2^31) on `device`, one draw from `generator`
    (no host sync: the kernels read them through a pointer), with a
    shard_map rank's rank folded in (parallel/ranks.py `device_seeds`)."""
    if generator is None:
        raise ValueError("train-mode dropout and the perturbations need a "
                         "torch.Generator (flax's 'dropout' and 'perturb' "
                         "rngs)")
    return ranks.device_seeds(torch.randint(0, 2 ** 31 - 1, (n,),
                                            generator=generator,
                                            device=device))


class Conv3x3(nn.Module):
    """3x3 SAME conv. weight [Cout, Cin, 3, 3] (torch layout) + bias.

    Casts x and the weight to `dtype`; `out_dtype` (the f32 logits head)
    takes the f32 accumulator straight out of the kernel. `kernel=True`
    allows the CUDA conv where the shape gate holds; `variant` is the JAX
    kernel variant it then runs (kernels/conv3x3_nchw.py)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype,
                 out_dtype: Optional[torch.dtype] = None,
                 kernel: bool = False, variant: str = "taps"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype
        self.out_dtype = out_dtype or dtype
        self.kernel = kernel
        self.variant = variant

    def forward(self, x: torch.Tensor, apply_bias: bool = True,
                bnl: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                return_stats: bool = False):
        """apply_bias=False returns the raw conv (the caller folds the bias
        into a following BN); bnl=(factor, shift) convolves
        leaky(x * factor + shift) instead of x (the fused ConvBlock's second
        conv); return_stats=True returns (out, s1, s2, n): the f32 sum and
        sum of squares of the biased output over its n = B * H * W pixels
        per channel (JAX `Conv3x3(return_stats=True)`)."""
        x = cast(x, self.dtype)
        w = cast(self.weight, self.dtype)
        cout, cin = w.shape[:2]
        use_k = self.kernel and conv_kernel_ok(x.shape[2], x.shape[3], cin,
                                               cout)
        stats = None
        if bnl is not None:
            fn = conv3x3_bnl if use_k else conv3x3_bnl_ref
            y = fn(x, bnl[0], bnl[1], w.permute(2, 3, 1, 0), self.out_dtype)
        elif use_k and return_stats and self.variant == "taps":
            y, *stats = conv3x3_fast_nchw_stats(x, w.permute(2, 3, 1, 0))
        elif use_k:
            y = conv3x3_nchw(x, w.permute(2, 3, 1, 0), self.out_dtype,
                             variant=self.variant)
        else:
            # the JAX fallback: a plain conv in the wider of the two dtypes
            y = F.conv2d(cast(x, self.out_dtype), cast(w, self.out_dtype),
                         padding=1)
        if not apply_bias:
            return y
        out = y + cast(self.bias, y.dtype).view(-1, 1, 1)
        if not return_stats:
            return out
        n = y.shape[0] * y.shape[2] * y.shape[3]
        s1, s2 = stats or moments(y)
        # the bias folded in: sum(y + b) = s1 + n b, sum((y + b)^2) = s2 +
        # 2 b s1 + n b^2
        b = self.bias.to(torch.float32)
        return out, s1 + n * b, s2 + 2.0 * b * s1 + n * b * b, n


class BatchNorm(nn.BatchNorm2d):
    """BN as flax computes it: (x - mean) * (rsqrt(var + eps) * scale)
    + bias in f32, cast to the compute dtype; the running stats in eval
    mode, the batch stats (biased variance) in train mode, which also
    updates the running stats; in GSPMD mode (parallel/ranks.py) the batch
    stats are the global batch's, from the ranks' summed moments (sync BN).
    The buffers and parameters are nn.BatchNorm2d's, so state dicts load
    unchanged."""

    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__(c, eps=1e-5, momentum=0.1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = cast(x, torch.float64 if x.dtype == torch.float64
                  else torch.float32)   # at least f32, as flax
        if self.training and ranks.gspmd():
            s1, s2, n = ranks.batch_moments(xf.sum((0, 2, 3)),
                                            (xf * xf).sum((0, 2, 3)),
                                            xf.numel() // xf.shape[1])
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
            self.update_running(mean, var)
        elif self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        # per-channel [C, 1, 1] views: one node each in an exported program
        y = ((xf - mean.view(-1, 1, 1)) * mul.view(-1, 1, 1)
             + self.bias.view(-1, 1, 1))
        return cast(y, self.dtype)

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """running = 0.9 running + 0.1 batch (flax momentum 0.9)."""
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var)


class BNFactorShift(BatchNorm):
    """BN folded to a per-channel (factor, shift) for the fused ConvBlocks
    (JAX `BNFactorShift`), from the moments (s1, s2) of the raw conv output
    over n elements and the conv bias b: BN(y + b) = y * factor + shift.
    Train mode: mean = s1 / n, var = max(s2 / n - mean^2, 0), factor =
    rsqrt(var + eps) * scale, shift = bias - mean * factor (b cancels); the
    running mean takes mean + b. Eval mode: the running stats with b folded
    in. The parameters and buffers are nn.BatchNorm2d's. Its moments are
    the rank's own: GSPMD mode routes no fused block (ROADMAP.md Queue A)."""

    def factor_shift(self, s1: torch.Tensor, s2: torch.Tensor, n: int,
                     conv_bias: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        b = conv_bias.to(torch.float32)
        if self.training and ranks.gspmd():
            raise NotImplementedError(
                "sync BN inside the fused ConvBlocks is not ported: GSPMD "
                "mode trains with conv_backend='xla' (ROADMAP.md Queue A)")
        if self.training:
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
            self.update_running(mean + b, var)
            factor = torch.rsqrt(var + self.eps) * self.weight
            return factor, self.bias - mean * factor
        factor = torch.rsqrt(self.running_var + self.eps) * self.weight
        return factor, self.bias - (self.running_mean - b) * factor


class StatsBatchNorm(BatchNorm):
    """BN from precomputed batch moments (JAX `StatsBatchNorm`): s1, s2 the
    f32 sum and sum of squares of x over its n pixels per channel. Train
    mode: mean = s1 / n, var = max(s2 / n - mean^2, 0) (biased), the
    running stats updated with them (in GSPMD mode s1, s2 and n summed over
    the ranks first: sync BN); eval mode: the running stats. Then
    factor = rsqrt(var + eps) * scale and shift = bias - mean * rsqrt(var +
    eps) * scale, both cast to the compute dtype, and x * factor + shift in
    that dtype. The parameters and buffers are nn.BatchNorm2d's."""

    def forward(self, x: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                n: int) -> torch.Tensor:
        if self.training:
            s1, s2, n = ranks.batch_moments(s1, s2, n)
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        factor = (inv * self.weight).to(self.dtype)
        shift = (self.bias - mean * inv * self.weight).to(self.dtype)
        return (x.to(self.dtype) * factor[:, None, None]
                + shift[:, None, None])


class Dropout(nn.Module):
    """flax nn.Dropout in train mode (keep with probability 1 - p, scale by
    1 / (1 - p)), the identity in eval mode or at p = 0. `backend` "auto"
    and "pallas" run the fused dropout module, "xla" the plain ops (the
    Encoder turns "auto" into "xla" where the conv kernels are off). In
    GSPMD mode the mask is the rank's rows of the global batch's
    (parallel/ranks.py `row_offset`), which only the plain ops draw."""

    def __init__(self, rate: float, backend: str):
        super().__init__()
        self.rate = rate
        self.backend = backend

    def forward(self, x: torch.Tensor,
                seed: Optional[torch.Tensor]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        offset = ranks.row_offset(x)
        if self.backend == "xla":
            return dropout(seed, x, self.rate, offset)
        if ranks.gspmd():
            raise ValueError("GSPMD mode draws dropout over the global "
                             "batch with the plain ops: dropout_backend "
                             "'auto' or 'xla' with conv_backend='xla'")
        return fused_dropout(x, seed, self.rate)


def block_recipe(nchw: bool, conv_backend: str, dropout: float,
                 bn_stats: bool, bn_backend: str) -> str:
    """JAX ConvBlock's route (models/unet.py:312-349): "fused" (dropout
    rate 0 only), "chain", "stats", "flat" or "default"; the first four
    only at JAX's NCHW levels (`nchw`)."""
    if nchw and not bn_stats:
        if conv_backend == "fused" and dropout == 0.0:
            return "fused"
        if conv_backend == "chain":
            return "chain"
    if nchw and bn_stats:
        return "stats"
    if nchw and bn_backend == "flat":
        return "flat"
    return "default"


class ConvBlock(nn.Module):
    """Conv3x3-BN-LeakyReLU, Dropout, Conv3x3-BN-LeakyReLU
    (UAPS_unet.py:31-47), by the recipe `block_recipe` picks (the module
    docstring). `nchw`: the block sits at one of JAX's NCHW levels;
    `kernel`: its convs may run the CUDA kernels."""

    def __init__(self, cin: int, cout: int, dropout: float,
                 dtype: torch.dtype, kernel: bool,
                 dropout_backend: str = "auto", conv_backend: str = "auto",
                 conv_variant: str = "taps", bn_backend: str = "auto",
                 bn_stats: bool = False, nchw: bool = True):
        super().__init__()
        self.block = block_recipe(nchw, conv_backend, dropout, bn_stats,
                                  bn_backend)
        self.dtype = dtype
        bn = {"default": BatchNorm, "chain": BNFactorShift,
              "fused": BNFactorShift, "stats": StatsBatchNorm,
              "flat": StatsBatchNorm}[self.block]
        self.conv_conv = nn.Sequential(
            Conv3x3(cin, cout, dtype, kernel=kernel, variant=conv_variant),
            bn(cout, dtype), nn.LeakyReLU(0.01),
            Dropout(dropout, dropout_backend),
            Conv3x3(cout, cout, dtype, kernel=kernel, variant=conv_variant),
            bn(cout, dtype), nn.LeakyReLU(0.01))

    def forward(self, x: torch.Tensor,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.block == "chain":
            return self._chain(x, seed)
        if self.block == "fused":
            return self._fused(x)
        c = self.conv_conv
        x = c[3](c[2](self._conv_bn(c[0], c[1], x)), seed)
        return c[6](self._conv_bn(c[4], c[5], x))

    def _conv_bn(self, conv: Conv3x3, bn: nn.Module,
                 x: torch.Tensor) -> torch.Tensor:
        """A conv and its BN: the moments from the conv ("stats"), from f32
        sums of its output ("flat"), or BN's own (default)."""
        if self.block == "stats":
            return bn(*conv(x, return_stats=True))
        y = conv(x)
        if self.block == "flat":
            return bn(y, *moments(y), y.shape[0] * y.shape[2] * y.shape[3])
        return bn(y)

    def _bn_leaky(self, y, factor, shift) -> torch.Tensor:
        dt = self.dtype
        return F.leaky_relu(y * factor.to(dt)[:, None, None]
                            + shift.to(dt)[:, None, None], 0.01)

    def _chain(self, x: torch.Tensor,
               seed: Optional[torch.Tensor]) -> torch.Tensor:
        """JAX `ConvBlock._chain`."""
        conv1, bn1, _, drop, conv2, bn2, _ = self.conv_conv
        dt = self.dtype
        b, cin, h, w = x.shape
        n = b * h * w
        if conv1.kernel and conv_kernel_ok(h, w, cin, conv1.weight.shape[0]):
            plain, bnl = chain_conv_plain, chain_conv_bnl
        else:
            plain, bnl = chain_plain_ref, chain_bnl_ref
        y1, s1, s2 = plain(x.to(dt), conv1.weight.to(dt).permute(2, 3, 1, 0))
        f1, sh1 = bn1.factor_shift(s1, s2, n, conv1.bias)
        rate = drop.rate if self.training else 0.0
        y2, s1, s2 = bnl(y1, f1, sh1, conv2.weight.to(dt).permute(2, 3, 1, 0),
                         seed if rate > 0 else None, rate)
        f2, sh2 = bn2.factor_shift(s1, s2, n, conv2.bias)
        return self._bn_leaky(y2, f2, sh2)

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """JAX `ConvBlock._fused`."""
        conv1, bn1, _, _, conv2, bn2, _ = self.conv_conv
        n = x.shape[0] * x.shape[2] * x.shape[3]
        y1 = conv1(x, apply_bias=False)
        f1, sh1 = bn1.factor_shift(*moments(y1), n, conv1.bias)
        y2 = conv2(y1, apply_bias=False, bnl=(f1, sh1))
        f2, sh2 = bn2.factor_shift(*moments(y2), n, conv2.bias)
        return self._bn_leaky(y2, f2, sh2)


def max_pool_2x2(x: torch.Tensor, kernel: bool) -> torch.Tensor:
    """2x2/stride-2 max pool: the CUDA pool where `kernel` and the JAX shape
    gate allow it, plain torch elsewhere."""
    if kernel and pool_pallas_ok(x):
        return max_pool_2x2_nchw(x)
    return F.max_pool2d(x, 2)


class MaxPool2x2(nn.Module):
    def __init__(self, kernel: bool):
        super().__init__()
        self.kernel = kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_2x2(x, self.kernel)


class DownBlock(nn.Module):
    """2x2 max-pool then ConvBlock (UAPS_unet.py:50-62)."""

    def __init__(self, cin: int, cout: int, dropout: float,
                 dtype: torch.dtype, pool_kernel: bool, conv_kernel: bool,
                 dropout_backend: str = "auto", **block):
        """`block`: ConvBlock's recipe keywords (`_block_kw`)."""
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            MaxPool2x2(pool_kernel),
            ConvBlock(cin, cout, dropout, dtype, conv_kernel,
                      dropout_backend, **block))

    def forward(self, x: torch.Tensor,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        pool, block = self.maxpool_conv
        return block(pool(x), seed)


def _align_corners_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] f32 linear-interpolation matrix with torch
    align_corners=True semantics (output i samples input
    i*(n_in-1)/(n_out-1)), built on `device`."""
    if n_in == 1:
        return torch.ones((n_out, 1), device=device)
    pos = (torch.arange(n_out, device=device, dtype=torch.float64)
           * ((n_in - 1) / (n_out - 1)))
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=n_in - 1)
    frac = (pos - lo).float()
    rows = torch.arange(n_out, device=device)
    w = torch.zeros((n_out, n_in), device=device)
    w.index_put_((rows, lo), 1.0 - frac, accumulate=True)
    w.index_put_((rows, hi), frac, accumulate=True)
    return w


def upsample2x_align_corners(x: torch.Tensor, mats=None) -> torch.Tensor:
    """2x bilinear upsample of NCHW x matching torch
    nn.Upsample(align_corners=True), as the JAX package computes it: two
    interpolation matmuls with the weights in x's dtype. `mats` = (wh,
    ww.T) from `_upsample_mats` skips rebuilding them."""
    wh, wwt = mats or _upsample_mats(x)
    return torch.matmul(torch.matmul(wh, x), wwt)


def _upsample_mats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    h, w = x.shape[2:]
    wh = _align_corners_weights(h, 2 * h, x.device).to(x.dtype)
    ww = _align_corners_weights(w, 2 * w, x.device).to(x.dtype)
    return wh, ww.t().contiguous()


class PointwiseConv(nn.Module):
    """1x1 conv, weight [Cout, Cin, 1, 1] + bias, in the compute dtype."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = cast(self.weight[:, :, 0, 0], self.dtype)
        y = torch.einsum("bchw,dc->bdhw", cast(x, self.dtype), k)
        return y + cast(self.bias, y.dtype).view(-1, 1, 1)


class UpBlock(nn.Module):
    """conv1x1, bilinear x2 (align_corners), concat [skip, up], ConvBlock
    (UAPS_unet.py:65-86; the reference's default bilinear=True path)."""

    def __init__(self, cin: int, skip: int, cout: int, dtype: torch.dtype,
                 conv_kernel: bool, **block):
        """`block`: ConvBlock's recipe keywords (`_block_kw`)."""
        super().__init__()
        self.conv1x1 = PointwiseConv(cin, skip, dtype)
        self.conv = ConvBlock(2 * skip, cout, 0.0, dtype, conv_kernel,
                              **block)
        # interpolation matrices by (h, w, dtype, device): built on the
        # device once instead of in every forward (a dozen small launches)
        self._mats = {}

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.conv1x1(x)
        key = (*x.shape[2:], x.dtype, x.device)
        if key not in self._mats:
            with torch.inference_mode(False):   # usable outside it later
                self._mats[key] = _upsample_mats(x)
        x = upsample2x_align_corners(x, self._mats[key])
        return self.conv(torch.cat([skip, x], dim=1))


def _block_kw(level: int, nchw_levels: int, conv_backend: str,
              conv_variant: str, bn_backend: str) -> dict:
    """ConvBlock's recipe keywords at `level` (JAX `_level_layout`: the
    levels below nchw_levels are NCHW)."""
    return dict(nchw=level < nchw_levels, conv_backend=conv_backend,
                conv_variant=conv_variant, bn_backend=bn_backend)


class Encoder(nn.Module):
    """5-stage encoder returning every skip feature (UAPS_unet.py:89-116).
    Every level's convs may run the CUDA conv (where the backend allows and
    the shape gate holds); the pool into level i runs the CUDA pool when
    its input level i-1 < nchw_levels."""

    def __init__(self, in_chns: int, features: Sequence[int],
                 dropout: Sequence[float], dtype: torch.dtype,
                 nchw_levels: int, conv_kernel: bool, pool_kernel: bool,
                 dropout_backend: str = "auto", conv_backend: str = "auto",
                 conv_variant: str = "taps", bn_backend: str = "auto"):
        super().__init__()
        ft, dp = features, dropout
        self.has_dropout = any(r > 0 for r in dp)
        # JAX's "auto" takes the fused dropout kernel only where the conv
        # kernels are on (conv_backend != "xla"), at every level
        drop = ("xla" if dropout_backend == "auto" and not conv_kernel
                else dropout_backend)
        knobs = (nchw_levels, conv_backend, conv_variant, bn_backend)
        self.in_conv = ConvBlock(in_chns, ft[0], dp[0], dtype, conv_kernel,
                                 drop, **_block_kw(0, *knobs))
        for i in range(1, SKIPS):
            self.add_module(f"down{i}", DownBlock(
                ft[i - 1], ft[i], dp[i], dtype,
                pool_kernel and i - 1 < nchw_levels, conv_kernel, drop,
                **_block_kw(i, *knobs)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """The 5 skip features; in train mode the dropout seeds (one per
        level) come from one draw from `generator`."""
        seeds = ([None] * SKIPS if not (self.training and self.has_dropout)
                 else draw_seeds(generator, SKIPS, x.device))
        feats = [self.in_conv(x, seeds[0])]
        for i in range(1, SKIPS):
            feats.append(getattr(self, f"down{i}")(feats[-1], seeds[i]))
        return feats


class Decoder(nn.Module):
    """4 up-stages + 3x3 logits head (UAPS_unet.py:119-153); returns NCHW
    f32 logits. The head runs the CUDA conv (compute-dtype inputs, f32
    out) when level 0 is NCHW and head_variant != "xla"; otherwise it is
    the JAX `nn.Conv(dtype=f32)`: an f32 conv with f32 weights, on the f32
    conv kernels where a subclass sets F32_HEAD_KERNEL."""

    F32_HEAD_KERNEL = False

    def __init__(self, num_classes: int, features: Sequence[int],
                 dtype: torch.dtype, nchw_levels: int, conv_kernel: bool,
                 head_variant: str, conv_backend: str = "auto",
                 conv_variant: str = "taps", bn_backend: str = "auto"):
        super().__init__()
        ft = features
        knobs = (nchw_levels, conv_backend, conv_variant, bn_backend)
        for j in range(4):
            lvl = 3 - j
            self.add_module(f"up{j + 1}", UpBlock(
                ft[lvl + 1], ft[lvl], ft[lvl], dtype, conv_kernel,
                **_block_kw(lvl, *knobs)))
        if nchw_levels > 0 and head_variant != "xla":
            self.out_conv = Conv3x3(ft[0], num_classes, dtype,
                                    out_dtype=torch.float32,
                                    kernel=conv_kernel, variant=head_variant)
        else:
            self.out_conv = Conv3x3(
                ft[0], num_classes, torch.float32,
                kernel=conv_kernel and self.F32_HEAD_KERNEL)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x0, x1, x2, x3, x4 = feats
        x = x4
        for j, skip in enumerate((x3, x2, x1, x0)):
            x = getattr(self, f"up{j + 1}")(x, skip)
        return self.out_conv(x)


def _kernel_flags(conv_backend: str,
                  pool_backend: str) -> Tuple[bool, bool]:
    """(conv kernel allowed, pool kernel allowed) for the model knobs."""
    conv_k = conv_backend != "xla"
    pool_k = conv_k and pool_backend in ("auto", "pallas")
    return conv_k, pool_k


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of NCHW logits (no copy: the loss kernels and softmax
    read it through its strides)."""
    return x.permute(0, 2, 3, 1)


class UNet(nn.Module):
    """Plain single-decoder U-Net (UAPS_unet.py:188-205). NHWC in, NHWC
    f32 logits out."""

    def __init__(self, num_classes: int, in_chns: int = 3,
                 dtype: torch.dtype = torch.float32, nchw_levels: int = 0,
                 conv_backend: str = "auto", head_variant: str = "taps",
                 pool_backend: str = "auto", bn_backend: str = "auto",
                 dropout_backend: str = "auto", conv_variant: str = "taps",
                 features: Sequence[int] = UNET_FEATURES,
                 dropout: Sequence[float] = UNET_DROPOUT):
        super().__init__()
        conv_k, pool_k = _kernel_flags(conv_backend, pool_backend)
        knobs = (conv_backend, conv_variant, bn_backend)
        self.encoder = Encoder(in_chns, features, dropout, dtype,
                               nchw_levels, conv_k, pool_k, dropout_backend,
                               *knobs)
        self.decoder = Decoder(num_classes, features, dtype, nchw_levels,
                               conv_k, head_variant, *knobs)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC images -> NHWC f32 logits; `generator` feeds dropout in
        train mode."""
        return _to_nhwc(self.decoder(self.encoder(_to_nchw(x), generator)))


class MultiDecoderUNet(nn.Module):
    """Shared encoder + main decoder + N perturbed auxiliary decoders
    (UNet_UAPS / UNet_CCT / UNet_UCC / UNet_CCPS); serving runs
    `main_only`."""

    def __init__(self, num_classes: int,
                 perturbations: Tuple[str, ...] = (
                     "feature_noise", "dropout", "feature_dropout"),
                 in_chns: int = 3, dtype: torch.dtype = torch.float32,
                 nchw_levels: int = 0, conv_backend: str = "auto",
                 head_variant: str = "taps", pool_backend: str = "auto",
                 bn_backend: str = "auto", packed_heads: bool = False,
                 dropout_backend: str = "auto", conv_variant: str = "taps",
                 features: Sequence[int] = UNET_FEATURES,
                 dropout: Sequence[float] = UNET_DROPOUT):
        super().__init__()
        if packed_heads:
            raise NotImplementedError(
                "packed_heads is not ported yet: ROADMAP.md Queue A, "
                "'Remainder'")
        conv_k, pool_k = _kernel_flags(conv_backend, pool_backend)
        self.perturbations = tuple(perturbations)
        self.conv_backend = conv_backend
        knobs = (conv_backend, conv_variant, bn_backend)
        self.encoder = Encoder(in_chns, features, dropout, dtype,
                               nchw_levels, conv_k, pool_k, dropout_backend,
                               *knobs)

        def decoder():
            return Decoder(num_classes, features, dtype, nchw_levels,
                           conv_k, head_variant, *knobs)

        self.main_decoder = decoder()
        for i in range(len(self.perturbations)):
            self.add_module(f"aux_decoder{i + 1}", decoder())

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        """NHWC images -> (main, aux 1, ..., aux N) NHWC f32 logits. The
        encoder runs once; aux decoder i sees all 5 skips perturbed by
        `perturbations[i]`, with seeds drawn from `generator` after the
        encoder's dropout seeds (in eval mode too, as in JAX)."""
        feats = self.encoder(_to_nchw(x), generator)
        outs = [self.main_decoder(feats)]
        n = len(self.perturbations)
        seeds = ([None] * (SKIPS * n)
                 if all(k == "none" for k in self.perturbations)
                 else draw_seeds(generator, SKIPS * n, feats[0].device))
        for i, kind in enumerate(self.perturbations):
            pfeats = perturb_features(seeds[SKIPS * i:SKIPS * (i + 1)],
                                      feats, kind, self.conv_backend)
            outs.append(getattr(self, f"aux_decoder{i + 1}")(pfeats))
        return tuple(_to_nhwc(o) for o in outs)

    def main_only(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """Encoder + main decoder only: the eval/serving path."""
        return _to_nhwc(self.main_decoder(self.encoder(_to_nchw(x),
                                                       generator)))


# the deep-supervision nets' feature perturbation (JAX factory unet_f/g/h)
DS_PERTURBATIONS = ("none", "feature_dropout", "feature_noise")


class DeepSupervisionDecoder(Decoder):
    """Decoder_mcps (JAX `DeepSupervisionDecoder`, m_unet.py:156-210):
    `Decoder` with every level JAX's NHWC (nchw_levels 0: the up-stages'
    default blocks, dropout 0, and the f32 logits head `out_conv`, dp0),
    and the coarser f32 heads `out_conv_dp3`, `_dp2` and `_dp1` on the
    first three up-stages, each resized to the input with nearest. The
    heads are flax `nn.Conv(dtype=f32)`: f32 convs. Where the conv kernel
    is allowed and its shape gate holds (dp0 at 256 px, and dp1 at 128
    px in `full` mode), a head runs the port's f32 conv kernels
    (kernels/conv3x3_nchw.py), which JAX's XLA conv is not: their weight
    gradient sums fixed per-strip partials in a fixed order, so a cps
    step gives the same bits on every call, where cuDNN's default weight
    gradient of the f32 dp0 head did not (ROADMAP Queue C #5)."""

    F32_HEAD_KERNEL = True

    def __init__(self, num_classes: int, features: Sequence[int],
                 dtype: torch.dtype, conv_kernel: bool,
                 conv_backend: str = "auto", conv_variant: str = "taps"):
        super().__init__(num_classes, features, dtype, 0, conv_kernel,
                         "taps", conv_backend, conv_variant)
        for i in (1, 2, 3):   # dp_i's head reads up(4 - i)'s ft[i] channels
            self.add_module(f"out_conv_dp{i}",
                            Conv3x3(features[i], num_classes, torch.float32,
                                    kernel=conv_kernel))

    def forward(self, feats: Sequence[torch.Tensor], full: bool = False):
        """dp0, NCHW f32 logits; with `full` JAX's dict: the bottleneck,
        the up-stages' features f1..f4 and the heads dp0..dp3."""
        if not full:
            return super().forward(feats)
        x0, x1, x2, x3, x4 = feats
        f = [x4]
        for j, skip in enumerate((x3, x2, x1, x0)):
            f.append(getattr(self, f"up{j + 1}")(f[-1], skip))

        def head(i):
            return F.interpolate(getattr(self, f"out_conv_dp{i}")(f[4 - i]),
                                 size=x0.shape[2:], mode="nearest")

        return {"bottleneck": x4, "f1": f[1], "f2": f[2], "f3": f[3],
                "f4": f[4], "dp0": self.out_conv(f[4]), "dp1": head(1),
                "dp2": head(2), "dp3": head(3)}


class DeepSupervisionUNet(nn.Module):
    """Encoder + deep-supervision decoder (JAX `DeepSupervisionUNet`,
    m_unet.py UNet_f / UNet_g / UNet_h), with `perturbation` "none",
    "feature_dropout" or "feature_noise" applied to all 5 skips after the
    encoder (seeds from the generator after the encoder's, JAX's "perturb"
    rng). JAX gives it no NCHW level: plain pools, the encoder's dropout
    by the "auto" backend, the ConvBlock convs by the shape gate alone.
    The torch module names are the reference's (`encoder`, `decoder`)."""

    def __init__(self, num_classes: int, perturbation: str = "none",
                 in_chns: int = 3, dtype: torch.dtype = torch.float32,
                 conv_backend: str = "auto", conv_variant: str = "taps",
                 features: Sequence[int] = UNET_FEATURES,
                 dropout: Sequence[float] = UNET_DROPOUT):
        super().__init__()
        if perturbation not in DS_PERTURBATIONS:
            raise ValueError(f"unknown perturbation kind: {perturbation!r}")
        conv_k, pool_k = _kernel_flags(conv_backend, "auto")
        self.perturbation = perturbation
        self.conv_backend = conv_backend
        self.encoder = Encoder(in_chns, features, dropout, dtype, 0, conv_k,
                               pool_k, "auto", conv_backend, conv_variant)
        self.decoder = DeepSupervisionDecoder(num_classes, features, dtype,
                                              conv_k, conv_backend,
                                              conv_variant)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                full: bool = False):
        """NHWC images -> dp0, NHWC f32 logits (what cps trains and eval
        and serving read: JAX's step keeps only dp0, methods/cps.py:52);
        with `full`, JAX's dict of NHWC tensors."""
        feats = self.encoder(_to_nchw(x), generator)
        if self.perturbation != "none":
            seeds = draw_seeds(generator, SKIPS, feats[0].device)
            feats = perturb_features(seeds, feats, self.perturbation,
                                     self.conv_backend)
        out = self.decoder(feats, full)
        if not full:
            return _to_nhwc(out)
        return {k: _to_nhwc(v) for k, v in out.items()}


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax `lecun_normal` on a torch conv weight [Cout, Cin, kh, kw]:
    truncated normal in [-2, 2] std with std = sqrt(1/fan_in) / 0.8796..."""
    fan_in = t.shape[1] * math.prod(t.shape[2:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
