"""The ResNet trunks and BaseNet with its multi-scale flip TTA.

Counterpart of `uaps_tpu/models/resnet.py`: BasicBlock, Bottleneck, the
dilated-stage ResNet (resnet50, 101 and 152 replace the strides of stages
3 and 4 with dilation: output stride 8), resnet18-152, the align-corners
resize, FCNHead and BaseNet. Module names are torchvision's (`conv1`,
`bn1`, `layer1.0.conv1`, `layer1.0.downsample.0` / `.1`; the head
`head.0`, `head.1`, `head.3`), so utils/weights.py maps JAX's trees onto
them and `.pth` files carry them.

Matching the JAX model:
  * `ResNet` and `BaseNet` take NHWC images and return NHWC tensors, as the
    JAX models do; inside, activations are NCHW (the blocks and the head
    are NCHW modules, as the U-Nets' ConvBlocks are);
  * parameters stay f32 and every conv casts its input and weight to the
    compute dtype (flax `nn.Conv(dtype=...)`); the convs are `F.conv2d`
    (cuDNN on the card): JAX runs flax convs here, outside any Pallas
    kernel, so no hand-written kernel stands behind them;
  * BN is the port's `BatchNorm` (flax: momentum 0.9, eps 1e-5, the biased
    batch variance in train mode and in the running update; normalised in
    f32, cast to the compute dtype);
  * the stem max-pool is 3x3 stride 2 with a 1-pixel -inf border; a 1x1
    stride-2 conv (flax SAME) reads every other pixel, as torch's does;
  * FCNHead's last 1x1 conv is f32 with a bias, so BaseNet returns f32
    logits;
  * `resize_align_corners` is two interpolation matmuls (H, then W) with
    the U-Net's `_align_corners_weights`, not `F.interpolate`; with TF32
    off (torch's default for matmuls) an f32 resize is full f32, as JAX's
    HIGHEST precision.

`BaseNet.forward(x, tta=True)` sums the 10 softmaxes of the scales 0.5,
0.75, 1.0, 1.5 and 2.0 (`int(h * scale)`), each with its W-flip, each
resized back to the input (reference utilities/base.py:23-46): the result
sums to 10 over the classes.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from uaps_tpu_torch.models.unet import (BatchNorm, _align_corners_weights,
                                        _to_nchw, _to_nhwc, cast)

TTA_SCALES = (0.5, 0.75, 1.0, 1.5, 2.0)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with f32 parameters that computes in `dtype`. `init`
    names its initialiser (models/factory.py): "kaiming" (JAX `_kaiming`,
    the trunk and the head's 3x3 conv) or "lecun" (flax's default, the
    head's f32 1x1 conv)."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = False, init: str = "kaiming"):
        super().__init__(cin, cout, k, stride, padding, dilation, bias=bias)
        self.dtype = dtype
        self.init = init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else cast(self.bias, dt)
        return F.conv2d(cast(x, dt), cast(self.weight, dt), b, self.stride,
                        self.padding, self.dilation)


def _downsample(cin: int, cout: int, stride: int,
                dtype: torch.dtype) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, 1, dtype, stride),
                         BatchNorm(cout, dtype))


class BasicBlock(nn.Module):
    """3x3 conv (stride, dilation) - BN - ReLU - 3x3 conv - BN, plus the
    identity or the 1x1 downsample, then ReLU (JAX `BasicBlock`)."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int,
                 dilation: int, downsample: bool, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, dtype, stride, dilation,
                            dilation)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv2d(planes, planes, 3, dtype, padding=1)
        self.bn2 = BatchNorm(planes, dtype)
        self.downsample = (_downsample(inplanes, planes, stride, dtype)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 - BN - ReLU - 3x3 (stride, dilation) - BN - ReLU - 1x1 (x4) -
    BN, plus the identity or the 1x1 downsample, then ReLU (JAX
    `Bottleneck`)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int,
                 dilation: int, downsample: bool, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, dtype)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv2d(planes, planes, 3, dtype, stride, dilation,
                            dilation)
        self.bn2 = BatchNorm(planes, dtype)
        self.conv3 = Conv2d(planes, planes * 4, 1, dtype)
        self.bn3 = BatchNorm(planes * 4, dtype)
        self.downsample = (_downsample(inplanes, planes * 4, stride, dtype)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """The dilated-stage ResNet (JAX `ResNet`): the 7x7 stride-2 stem, BN,
    ReLU, the 3x3 stride-2 max-pool and four stages of `layers` blocks;
    `forward` returns (c1, c2, c3, c4), NHWC."""

    def __init__(self, block: type, layers: Sequence[int],
                 replace_stride_with_dilation=(False, False, False),
                 in_chns: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_chns, 64, 7, dtype, 2, 3)
        self.bn1 = BatchNorm(64, dtype)
        inplanes, dilation = 64, 1
        for stage, (planes, n_blocks) in enumerate(
                zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            prev_dilation = dilation
            if stage > 0 and replace_stride_with_dilation[stage - 1]:
                dilation *= stride
                stride = 1
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                needs_down = b == 0 and (s != 1
                                         or inplanes != planes
                                         * block.expansion)
                blocks.append(block(inplanes, planes, s,
                                    prev_dilation if b == 0 else dilation,
                                    needs_down, dtype))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_channels = inplanes

    def features(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """NCHW images -> (c1, c2, c3, c4), NCHW."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats.append(x)
        return tuple(feats)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """NHWC images -> (c1, c2, c3, c4), NHWC."""
        return tuple(_to_nhwc(f) for f in self.features(_to_nchw(x)))


def resnet18(in_chns=3, dtype=torch.float32):
    return ResNet(BasicBlock, (2, 2, 2, 2), in_chns=in_chns, dtype=dtype)


def resnet34(in_chns=3, dtype=torch.float32):
    return ResNet(BasicBlock, (3, 4, 6, 3), in_chns=in_chns, dtype=dtype)


def resnet50(in_chns=3, dtype=torch.float32):
    return ResNet(Bottleneck, (3, 4, 6, 3), (False, True, True), in_chns,
                  dtype)


def resnet101(in_chns=3, dtype=torch.float32):
    return ResNet(Bottleneck, (3, 4, 23, 3), (False, True, True), in_chns,
                  dtype)


def resnet152(in_chns=3, dtype=torch.float32):
    return ResNet(Bottleneck, (3, 8, 36, 3), (False, True, True), in_chns,
                  dtype)


BACKBONES = {"resnet18": resnet18, "resnet34": resnet34,
             "resnet50": resnet50, "resnet101": resnet101,
             "resnet152": resnet152}


def resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int],
                         mats: Optional[Tuple[torch.Tensor, torch.Tensor]]
                         = None) -> torch.Tensor:
    """Bilinear resize of NCHW x to `out_hw` with torch align_corners=True
    semantics, as JAX computes it: the H interpolation matmul, then the W
    one, the weights in x's dtype. `mats` = (wh, ww.T) (`resize_mats`)
    skips rebuilding them. The same size returns x."""
    if tuple(out_hw) == tuple(x.shape[2:]):
        return x
    wh, wwt = mats or resize_mats(x, out_hw)
    return torch.matmul(torch.matmul(wh, x), wwt)


def resize_mats(x: torch.Tensor, out_hw: Tuple[int, int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    (h, w), (oh, ow) = x.shape[2:], out_hw
    wh = _align_corners_weights(h, oh, x.device).to(x.dtype)
    ww = _align_corners_weights(w, ow, x.device).to(x.dtype)
    return wh, ww.t().contiguous()


class FCNHead(nn.Sequential):
    """3x3 conv to C/4 channels - BN - ReLU - f32 1x1 conv with a bias to
    the classes (JAX `FCNHead`); NCHW."""

    def __init__(self, cin: int, num_classes: int, dtype: torch.dtype):
        super().__init__(
            Conv2d(cin, cin // 4, 3, dtype, padding=1),
            BatchNorm(cin // 4, dtype), nn.ReLU(),
            Conv2d(cin // 4, num_classes, 1, torch.float32, bias=True,
                   init="lecun"))


class BaseNet(nn.Module):
    """ResNet trunk + FCNHead with the multi-scale flip TTA (JAX
    `BaseNet`). NHWC images in, NHWC f32 logits (or, with `tta`, the sum of
    the 10 softmaxes) out."""

    def __init__(self, backbone: str = "resnet50", num_classes: int = 4,
                 in_chns: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = BACKBONES[backbone](in_chns, dtype)
        self.head = FCNHead(self.net.out_channels, num_classes, dtype)
        # interpolation matrices by (sizes, dtype, device): built once
        # instead of in every forward
        self._mats: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _resize(self, x: torch.Tensor, out_hw: Tuple[int, int]
                ) -> torch.Tensor:
        if tuple(out_hw) == tuple(x.shape[2:]):
            return x
        key = (*x.shape[2:], *out_hw, x.dtype, x.device)
        if key not in self._mats:
            with torch.inference_mode(False):   # usable outside it later
                self._mats[key] = resize_mats(x, out_hw)
        return resize_align_corners(x, out_hw, self._mats[key])

    def base_forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images -> NCHW f32 logits at the input's size."""
        out = self.head(self.net.features(x)[-1])
        return self._resize(out, x.shape[2:])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                tta: bool = False) -> torch.Tensor:
        """NHWC images -> NHWC f32 logits; with `tta`, the sum over
        TTA_SCALES of the softmax of the resized batch and of its W-flip,
        each resized back. `generator` is unused (no dropout): the
        methods' train-mode forward passes one to every model."""
        del generator
        x = _to_nchw(x)
        if not tta:
            return _to_nhwc(self.base_forward(x))
        h, w = x.shape[2:]
        total = None
        for scale in TTA_SCALES:
            cur = self._resize(x, (int(h * scale), int(w * scale)))
            out = self._resize(torch.softmax(self.base_forward(cur), 1),
                               (h, w))
            total = out if total is None else total + out
            flipped = torch.softmax(self.base_forward(cur.flip(3)), 1)
            total = total + self._resize(flipped.flip(3), (h, w))
        return _to_nhwc(total)
