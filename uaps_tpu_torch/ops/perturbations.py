"""Feature-space perturbations of the UAPS auxiliary decoders: the port's
`uaps_tpu/ops/perturbations.py`.

Each perturbation is a draw from the port's counter-based generator and an
apply (`kernels/perturb.py` holds both, beside the kernels): a test can
hand JAX's own draw to the apply. The plain functions below differentiate
through torch ops; `perturb_features` routes to the kernel module where
JAX's gate (ops/perturbations.py:93) would take its Pallas kernels.

Features are NCHW at every level of the port, so feature dropout's channel
axis is always 1 (JAX's NCHW levels pass channel_axis=1 too). Seeds are
0-d int64 tensors on the features' device, one per call.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from uaps_tpu_torch.kernels.perturb import (  # noqa: F401  (re-exported)
    dropout_apply, dropout_plain, feature_dropout_apply, feature_dropout_plain,
    feature_noise_apply, feature_noise_plain, fused_dropout,
    fused_feature_dropout, fused_feature_noise)
from uaps_tpu_torch.parallel.ranks import gspmd, row_offset

# aux1 <- feature noise, aux2 <- dropout, aux3 <- feature dropout
PERTURBATIONS = ("feature_noise", "dropout", "feature_dropout")


def feature_noise(seed: torch.Tensor, x: torch.Tensor,
                  uniform_range: float = 0.3) -> torch.Tensor:
    """x * (1 + U(-r, r)), the noise of shape x.shape[1:] shared across the
    batch."""
    return feature_noise_plain(x, seed, uniform_range)


def dropout(seed: torch.Tensor, x: torch.Tensor, rate: float = 0.5,
            offset: int = 0) -> torch.Tensor:
    """Inverted dropout: zero with probability `rate`, survivors scaled by
    1 / (1 - rate); masks differ per example. The elements' flat indices
    start at `offset` (a GSPMD rank's rows of the global batch)."""
    return dropout_plain(x, seed, rate, offset)


def feature_dropout(seed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Attention-thresholded spatial dropout: attention = channel mean,
    pixels with attention >= scale * (the example's max) are zeroed, one
    scale ~ U(0.7, 0.9) per call shared across the batch."""
    return feature_dropout_plain(x, seed)


_PLAIN = {"feature_noise": feature_noise,
          "dropout": lambda s, f: dropout(s, f, offset=row_offset(f)),
          "feature_dropout": feature_dropout}
_FUSED = {"feature_noise": lambda s, f: fused_feature_noise(f, s),
          "dropout": lambda s, f: fused_dropout(f, s),
          "feature_dropout": lambda s, f: fused_feature_dropout(f, s)}


def perturb_features(seeds: torch.Tensor, features: Sequence[torch.Tensor],
                     kind: str, backend: str = "auto"
                     ) -> List[torch.Tensor]:
    """Apply one perturbation kind to every skip tensor, seeds[i] to
    features[i]. backend != "xla" routes to the kernel module (the kernels
    on the GPU, their plain versions on the CPU); "xla" to the plain
    functions. 'none' returns the features unchanged. In GSPMD mode
    (parallel/ranks.py) the dropout kind takes the rank's rows of the
    global batch's masks, which the kernel route does not draw: it raises
    there. Feature noise and feature dropout need no offset: the noise and
    the scale are shared across the batch, the attention is per example."""
    if kind == "none":
        return list(features)
    if kind not in _PLAIN:
        raise ValueError(f"unknown perturbation kind: {kind!r}")
    if kind == "dropout" and backend != "xla" and gspmd():
        raise ValueError("GSPMD mode perturbs with the plain ops: "
                         "conv_backend='xla'")
    fn = (_FUSED if backend != "xla" else _PLAIN)[kind]
    return [fn(s, f) for s, f in zip(seeds, features)]
