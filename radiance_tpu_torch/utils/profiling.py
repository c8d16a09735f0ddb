"""Profiling / timing utilities.

Port of radiance_tpu/utils/profiling.py.  The reference's observability
is wall-clock printf timing around kernel dispatch and BVH builds
(reference: radiance.cpp:252-265, 25-49; sample1.cpp:457-476).  Here:
scoped wall-clock timers that end in a synchronize of the devices the
result lives on (a CUDA launch returns before the card finishes), frame
statistics, and a torch.profiler trace written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in x (a tensor, or a dict, list or
    tuple of them, nested)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


@contextlib.contextmanager
def timed(label: str, sync=None, quiet: bool = False):
    """Wall-clock scope.  Put the block's result tensors in box["sync"]
    (default: `sync`): the scope ends with a synchronize of every CUDA
    device they live on, so the time covers their device work.  The
    seconds go to box["seconds"] and, unless quiet, are printed."""
    t0 = time.time()
    box = {}
    try:
        yield box
    finally:
        for dev in _cuda_devices(box.get("sync", sync), set()):
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        box["seconds"] = dt
        if not quiet:
            print(f"[{label}] {dt:.4f}s")


@dataclass
class FrameStats:
    """Rolling frame statistics for the progressive render loop."""
    frames: int = 0
    total_s: float = 0.0
    last_s: float = 0.0
    history: List[float] = field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.frames += 1
        self.total_s += seconds
        self.last_s = seconds
        self.history.append(seconds)
        if len(self.history) > 100:
            self.history.pop(0)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.frames, 1)

    def rays_per_sec(self, rays_per_frame: int) -> float:
        return rays_per_frame / self.last_s if self.last_s else 0.0

    def report(self, rays_per_frame: Optional[int] = None) -> str:
        msg = (f"frames={self.frames} last={self.last_s * 1e3:.1f}ms "
               f"mean={self.mean_s * 1e3:.1f}ms")
        if rays_per_frame:
            msg += f" ({self.rays_per_sec(rays_per_frame) / 1e6:.2f} Mrays/s)"
        return msg


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Trace the block with torch.profiler (the CPU, and the card's
    kernels where CUDA is available) and write it as a Chrome trace,
    <log_dir>/trace.json (chrome://tracing, Perfetto); log_dir defaults
    to radiance_tpu_torch_trace under the temporary directory.  Yields
    log_dir."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "radiance_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")
