"""uaps_tpu_torch: the PyTorch + CUDA port of uaps_tpu, for NVIDIA Hopper.

The JAX package `uaps_tpu` stays the reference; this package mirrors its
module names so each piece has an obvious counterpart, and every Pallas TPU
kernel on a ported path becomes a CUDA kernel written by hand for sm_90a
(`csrc/`), built with nvcc on first use and bound with ctypes (`kernels/`).
Each kernel module also holds the kernel's plain PyTorch twin, which the
wrapper runs for CPU tensors only.

Ported so far (serving): `InferenceEngine.predict` over
`MultiDecoderUNet.main_only` / `UNet`, the `AsyncBatcher` + HTTP front
(reused from `uaps_tpu.server`), and the conv3x3 and 2x2 max-pool forward
kernels. Training comes next (ROADMAP.md).

Rules: this package imports torch and never jax, flax, optax or orbax. It
reuses only the jax-free host modules of `uaps_tpu` (config, torch_import,
server, native, data.synthetic). Activations are NCHW inside; public
functions keep the JAX layouts (NHWC images in, NHWC probs/logits out).

Layout:
  kernels/    _build (nvcc + ctypes), conv3x3_nchw, pool_nchw
  csrc/       the CUDA sources
  models/     unet (U-Net family, eval forward), factory (net_factory)
  methods/    base (build_model + enum validation)
  utils/      weights (JAX trees / .pth -> module), cli (parse_args)
  serve.py    InferenceEngine        server.py   HTTP entry point
"""
