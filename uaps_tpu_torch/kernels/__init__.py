"""Hand-written Hopper kernels of the port, each beside its plain version.

Importing these modules builds nothing: a kernel library is compiled and
loaded by `_build` on its first CUDA launch (or by `_build.build()`).

Each wrapper counts its launches in module-level integers (`launches`,
`fwd_launches`, ...), which the caller resets. A count ticks where the
wrapper enqueues its kernel: also while a CUDA graph captures the launch,
though nothing runs then, and never when the graph replays it, since no
Python runs then. So a graphed step (uaps_tpu_torch/dispatch.py) is counted
from the profiler's kernel names (chip_smoke.py phase 19), not here.

Importing the package registers the kernels' forwards as the `uaps::`
operators of `custom_ops`, through which every wrapper calls them.
"""
from uaps_tpu_torch.kernels import custom_ops  # noqa: F401
