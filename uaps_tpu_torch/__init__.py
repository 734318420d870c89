"""uaps_tpu_torch: the PyTorch + CUDA port of uaps_tpu, for NVIDIA Hopper.

The JAX package `uaps_tpu` stays the reference; this package mirrors its
module names so each piece has an obvious counterpart, and every Pallas TPU
kernel on a ported path becomes a CUDA kernel written by hand for sm_90a
(`csrc/`), built with nvcc on first use and bound with ctypes (`kernels/`).
Each kernel module also holds the kernel's plain PyTorch version, which the
wrapper runs for CPU tensors only.

Ported so far:
  * serving: `InferenceEngine.predict` over `MultiDecoderUNet.main_only` /
    `UNet`, the `AsyncBatcher` + HTTP front;
  * training: the supervised `baseline` method (train-mode U-Net, Adam,
    plateau LR, eval step, single-device `Trainer`, `python -m
    uaps_tpu_torch.train`) on the synthetic data;
  * kernels: the 3x3 conv forward, dgrad and wgrad, the 2x2 max-pool
    forward and backward, and the fused CE + Dice loss with its gradient.
The UAPS step comes next (ROADMAP.md).

Rules: this package imports torch, numpy and the standard library, and
nothing of `uaps_tpu` (nor jax, flax, optax or orbax); what it needs of the
JAX package's host code it keeps as its own copy. Activations are NCHW
inside; public functions keep the JAX layouts (NHWC images in, NHWC
probs/logits out).

Layout:
  kernels/    _build (nvcc + ctypes), custom_ops (the kernels' forwards as
              `uaps::` operators), conv3x3_nchw, pool_nchw, ce_dice, ...
  csrc/       the CUDA sources
  models/     unet (U-Net family), resnet (BaseNet), factory (net_factory)
  methods/    base (model, optimizer, losses, eval step), baseline
  ops/        losses, metrics
  data/       synthetic (SyntheticDefects), device_pool (resident pools)
  utils/      config, cli, weights, logging_utils
  serve.py    InferenceEngine     server.py   AsyncBatcher + HTTP
  artifact.py the export artifact (ExportedEngine)
  train.py    Trainer + training CLI
  dispatch.py K steps a dispatch: one CUDA graph on the GPU
  parallel/   data-parallel training over ranks: mesh (the group, rows,
              replicated state), ranks (a step's draws and sums on a
              rank), shardmap_step
"""
