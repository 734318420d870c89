"""Build the CUDA sources in `uaps_tpu_torch/csrc/` and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/lib<name>.so` through

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>.so csrc/<name>.cu

(a plain C interface, no PyTorch headers, so a source builds in seconds).
A library is rebuilt when its source or any `csrc/*.cuh` is newer than it.
`build()` starts one nvcc per stale source, all at once, under a file lock
so that concurrent processes never race on the same output. Nothing here
falls back: a missing nvcc or a failed build raises.

Pointers and the stream are passed to the libraries as `ctypes.c_void_p`
(each wrapper declares `argtypes`; an undeclared pointer would be cut to 32
bits), and every entry point returns `cudaGetLastError()`, which
`check()` turns into an exception.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")  # registers / spills into the build log
# dtype codes shared with csrc/common.cuh (uaps::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def sources() -> list:
    """Names of every kernel source (`csrc/<name>.cu`)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels are built from uaps_tpu_torch/csrc on first use")


def _stale(name: str) -> bool:
    so = lib_path(name)
    if not so.exists():
        return True
    deps = [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]
    return max(p.stat().st_mtime for p in deps) > so.stat().st_mtime


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the stale libraries among `names` (default: every source),
    one nvcc process each, all started together. Returns {name: compiler
    output} for the libraries it compiled; raises if any build fails."""
    names = sources() if names is None else list(names)
    for n in names:
        if not (CSRC_DIR / f"{n}.cu").exists():
            raise FileNotFoundError(CSRC_DIR / f"{n}.cu")
    BUILD_DIR.mkdir(exist_ok=True)
    logs: Dict[str, str] = {}
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        todo = [n for n in names if _stale(n)]
        if not todo:
            return logs
        nvcc = find_nvcc()
        jobs = []
        for n in todo:
            tmp = BUILD_DIR / f"lib{n}.so.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{n}.cu")]
            jobs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for n, tmp, proc in jobs:
            out, _ = proc.communicate()
            logs[n] = out
            if proc.returncode == 0:
                os.replace(tmp, lib_path(n))
            else:
                tmp.unlink(missing_ok=True)
                failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, building it if stale."""
    build([name])
    lib = ctypes.CDLL(str(lib_path(name)))
    lib.uaps_error_string.argtypes = [ctypes.c_int]
    lib.uaps_error_string.restype = ctypes.c_char_p
    return lib


def decoder_arrays(logits):
    """(pointers, element strides) of D logits [B, H, W, C] as the entry
    points of csrc/decoder_logits.cuh take them: a void* [D] array and a
    long long [4 D] array of (sb, sh, sw, sc) per decoder."""
    ptrs = (ctypes.c_void_p * len(logits))(*[lg.data_ptr() for lg in logits])
    strides = (ctypes.c_longlong * (4 * len(logits)))(
        *[s for lg in logits for s in lg.stride()])
    return ptrs, strides


def call(lib: ctypes.CDLL, fn, device: torch.device, what: str,
         *args) -> None:
    """Run entry point `fn(*args, stream)` on `device` with PyTorch's
    current stream there, and raise if it returned an error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, what)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if an entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.uaps_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
