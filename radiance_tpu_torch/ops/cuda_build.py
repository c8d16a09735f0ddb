"""Build and bind the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

Each kernel source is a shared library with a plain C interface, built
with nvcc for sm_90a into the git-ignored radiance_tpu_torch/_build/ at
first use (never at import) and loaded with ctypes.  load_all() starts
one nvcc per stale source at once and waits for all of them, so a
process that needs every kernel pays the longest build, not the sum.

A library is rebuilt when it is missing or older than its source or any
header under csrc/.  BUILD_INFO[name] holds the build seconds, the
command and nvcc's ptxas report (registers, spills).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p       # a device pointer or the stream, as a Python int
I32 = ctypes.c_int
I64 = ctypes.c_int64
F32 = ctypes.c_float


@dataclasses.dataclass(frozen=True)
class KernelLib:
    """One csrc/ source built into lib<name>.so.

    functions: (C function name, argtypes) pairs; every function
    returns an int (the cudaError_t of its launch).
    extra_flags: nvcc flags beyond NVCC_FLAGS (e.g. -fmad=false, or the
    -D defines of a variant).
    source_name: the csrc/ source's stem where it is not `name` (a
    variant: one source built with other defines, under its own name).
    """
    name: str
    functions: Tuple[Tuple[str, Tuple], ...]
    extra_flags: Tuple[str, ...] = ()
    source_name: str = ""

    @property
    def source(self) -> str:
        return os.path.join(CSRC_DIR, f"{self.source_name or self.name}.cu")

    def variant(self, suffix: str, defines: Dict[str, int]) -> "KernelLib":
        """This library's source built with `defines` (-DKEY=VALUE) into
        lib<name><suffix>.so; itself where there are none."""
        if not defines:
            return self
        return dataclasses.replace(
            self, name=self.name + suffix,
            source_name=self.source_name or self.name,
            extra_flags=self.extra_flags + tuple(
                f"-D{k}={v}" for k, v in sorted(defines.items())))

    @property
    def path(self) -> str:
        return os.path.join(BUILD_DIR, f"lib{self.name}.so")

    def command(self, out: str):
        return [nvcc(), *NVCC_FLAGS, *self.extra_flags, "-o", out,
                self.source]


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_INFO: Dict[str, dict] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin)")
    return path


def _stale(spec: KernelLib) -> bool:
    if not os.path.exists(spec.path):
        return True
    built = os.path.getmtime(spec.path)
    deps = [spec.source] + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def _bind(spec: KernelLib) -> ctypes.CDLL:
    lib = ctypes.CDLL(spec.path)
    for fn, argtypes in spec.functions:
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = list(argtypes)
    return lib


def load_all(specs: Sequence[KernelLib]) -> Dict[str, ctypes.CDLL]:
    """Build every stale library of `specs` in parallel, then load and
    bind them all; returns name -> CDLL."""
    with _lock:
        todo = [s for s in specs if s.name not in _libs and _stale(s)]
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.time()
            procs = []
            for s in todo:
                tmp = f"{s.path}.{os.getpid()}.tmp"
                cmd = s.command(tmp)
                procs.append((s, tmp, cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            failed = []
            for s, tmp, cmd, proc in procs:
                out, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    failed.append(f"{s.name}: nvcc failed ({proc.returncode}):"
                                  f"\n{err}{out}")
                    continue
                os.replace(tmp, s.path)
                BUILD_INFO[s.name] = dict(seconds=time.time() - t0,
                                          command=cmd, ptxas=err + out)
            if failed:
                raise RuntimeError("\n".join(failed))
        for s in specs:
            if s.name not in _libs:
                _libs[s.name] = _bind(s)
        return {s.name: _libs[s.name] for s in specs}


def load(spec: KernelLib) -> ctypes.CDLL:
    """Build (if stale) and load one library."""
    return load_all([spec])[spec.name]


def check_tensor(fn: str, name: str, x, dtype, shape, dev) -> None:
    """Raise unless x is a contiguous `dtype` tensor on `dev` whose shape
    matches `shape` (None matches any extent)."""
    if (x.device != dev or x.dtype != dtype or not x.is_contiguous()
            or x.dim() != len(shape)
            or any(s is not None and s != xs
                   for s, xs in zip(shape, x.shape))):
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor "
                         f"of shape {shape} on {dev}, got {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@contextlib.contextmanager
def on_device(dev):
    """Make `dev` the calling thread's current CUDA device for a launch and
    give the handle of its current stream.  A ctypes launch goes to the
    thread's current device, whatever device its pointers live on."""
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


_count_lock = threading.Lock()


def count_launch(fn, attr: str = "launches", key=None) -> None:
    """Add one to the launch count fn.<attr> (to fn.<attr>[key] where it is
    a dict), under a lock: the sharded frames launch from one thread per
    device."""
    with _count_lock:
        if key is None:
            setattr(fn, attr, getattr(fn, attr) + 1)
        else:
            counts = getattr(fn, attr)
            counts[key] = counts.get(key, 0) + 1
