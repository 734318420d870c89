"""Hand-written Hopper kernels of the port, each beside its plain version.

Importing these modules builds nothing: a kernel library is compiled and
loaded by `_build` on its first CUDA launch (or by `_build.build()`).
"""
