"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into `_build/lib<name>.so`, then loaded with `ctypes`. The
build runs at first use, never at import; `build_all` starts one `nvcc` per
source at once. A library is rebuilt when its source is newer than it.
`VARIANTS` names further libraries built from a kernel's source with extra
flags; they serve checks and measurements, not the port's paths.

`build_host` compiles host C++ (the native mesh and raster code under
`native/src`) into one library in `_build`, with `nvcc` as the compiler
driver where the CUDA toolkit is installed and `c++` where it is not. It
takes the kernels' build lock.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNELS = ("nn1", "grid_trilinear")
# library name -> (source name, extra nvcc flags)
VARIANTS = {"nn1_exact": ("nn1", ("-DNN1_EXACT_ROUNDING",))}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _cuda_home() -> str | None:
    from torch.utils.cpp_extension import CUDA_HOME

    return CUDA_HOME


def _nvcc() -> str:
    if _cuda_home() is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return os.path.join(_cuda_home(), "bin", "nvcc")


def _paths(name: str) -> tuple[str, str]:
    source = VARIANTS[name][0] if name in VARIANTS else name
    return os.path.join(CSRC_DIR, f"{source}.cu"), os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    src, out = _paths(name)
    return not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src)


def _start(name: str) -> subprocess.Popen:
    src, out = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    extra = VARIANTS[name][1] if name in VARIANTS else ()
    cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.out_path, proc.tmp_path = out, tmp
    return proc


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(proc.tmp_path, proc.out_path)
    return log


def build_all(names=KERNELS) -> tuple[float, dict[str, str]]:
    """Compile every stale kernel library in parallel: (seconds taken, nvcc's
    output per kernel built, which holds ptxas's register/shared-memory report)."""
    t0 = time.perf_counter()
    with _lock:
        procs = {n: _start(n) for n in names if _stale(n)}
        logs = {n: _finish(n, p) for n, p in procs.items()}
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if _stale(name):
            _finish(name, _start(name))
        lib = ctypes.CDLL(_paths(name)[1])
        _libs[name] = lib
        return lib


def build_host(name: str, sources: list[str]) -> str:
    """Compile C++ `sources` into `_build/lib<name>.so` unless it is newer than
    every source; returns the library's path."""
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    with _lock:
        if os.path.exists(out) and all(os.path.getmtime(out) >= os.path.getmtime(s) for s in sources):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        if _cuda_home() is not None:
            cmd = [_nvcc(), "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, *sources]
        else:
            cmd = ["c++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building lib{name}.so failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out


@functools.lru_cache(maxsize=None)
def launcher(name: str, function: str, argtypes: tuple):
    """The C function `function` of library `name`, typed once; it returns a
    cudaError as an int (see `check`)."""
    fn = getattr(load(name), function)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on `device`, for a C launcher.
    `torch.cuda.current_stream(device).cuda_stream` gives the same number but
    builds a Stream object first, which takes microseconds on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, name: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
