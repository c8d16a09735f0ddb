"""Profiling / timing utilities.

Port of radiance_tpu/utils/profiling.py.  The reference's observability
is wall-clock printf timing around kernel dispatch and BVH builds
(reference: radiance.cpp:252-265, 25-49; sample1.cpp:457-476).  Here:
scoped wall-clock timers that end in a synchronize of the devices the
result lives on (a CUDA launch returns before the card finishes), the
program's own spans, and a torch.profiler trace written as a Chrome
trace.

Spans.  The hot path marks each layer boundary with
`with profiling.span("<layer>.<part>") as sp:`, and `sp.note(**counts)`
attaches integer counts that are already on the host; a count that needs
a host read is taken only where `sp.live` holds.  Spans are off
unless a torch profiler session is active
(torch.autograd.profiler._is_profiler_enabled, which every
torch.profiler.profile sets, whatever its activities): off, span returns
one shared object that does nothing, with no record_function, CUDA
event, allocation, host read or device op.  On, each span appends a
SpanRecord to the process's log (its name, start and end on
time.perf_counter_ns, its parent, its root -- one frame or one
top-level trace call -- its thread and its counts; parents are kept per
thread) and enters torch.profiler.record_function(name), so that
device_trace's Chrome trace shows the spans beside the kernels.  The log
holds at most LOG_CAP records and counts the spans past that as dropped.
It restarts at the first span that finds the profiler on after a span
found it off, and then reads the anchor: perf_counter_ns and
DEVICE_CLOCK, the clock of torch's profiler records (the Unix clock),
back to back, so that a reader maps device records onto the spans
exactly (Anchor.to_perf_ns).  spans() reads the log.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# the clock torch's profiler puts its CPU and device records on
DEVICE_CLOCK = time.time_ns
LOG_CAP = 1 << 18


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


@dataclass(slots=True)
class SpanRecord:
    """One span: start_ns and end_ns on time.perf_counter_ns (end_ns 0
    while it is open); parent and root are indices into the log (parent
    -1 at a root, whose root is itself); thread is
    threading.get_ident(); counts are note()'s."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int
    thread: int
    counts: dict


@dataclass(frozen=True)
class Anchor:
    """perf_counter_ns and DEVICE_CLOCK read back to back."""
    perf_ns: int
    device_ns: int

    def to_perf_ns(self, device_ns: int) -> int:
        """A time on DEVICE_CLOCK (a profiler record's) on perf_counter_ns."""
        return device_ns - self.device_ns + self.perf_ns


class SpanLog(NamedTuple):
    """spans(): the records in the order they were entered, the anchor
    (None before the first span) and the spans dropped past LOG_CAP."""
    records: List[SpanRecord]
    anchor: Optional[Anchor]
    dropped: int


class _Log:
    def __init__(self):
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self.anchor: Optional[Anchor] = None
        self.gen = 0           # bumped at each restart
        self.live = False      # the last span found the profiler on
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        """This thread's open spans, as (gen, index)."""
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def restart(self) -> None:
        self.records, self.dropped, self.gen = [], 0, self.gen + 1
        a = time.perf_counter_ns()
        d = DEVICE_CLOCK()
        b = time.perf_counter_ns()
        self.anchor = Anchor(perf_ns=(a + b) // 2, device_ns=d)
        self.live = True


_LOG = _Log()


class _Off:
    __slots__ = ()
    live = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name, self.rec, self.rf = name, None, None

    @property
    def live(self) -> bool:
        """Whether the span is logged (False past LOG_CAP): a count that
        needs a host read is taken only then."""
        return self.rec is not None

    def __enter__(self):
        log = _LOG
        stack = log.stack()
        with log.lock:
            if not log.live:
                log.restart()
            recs = log.records
            if len(recs) >= LOG_CAP:
                log.dropped += 1
                return self
            idx, parent = len(recs), -1
            if stack and stack[-1][0] == log.gen:
                parent = stack[-1][1]
            self.rec = SpanRecord(self.name, 0, 0, parent,
                                  recs[parent].root if parent >= 0 else idx,
                                  threading.get_ident(), {})
            recs.append(self.rec)
            stack.append((log.gen, idx))
        self.rec.start_ns = time.perf_counter_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rf.__exit__(*exc)
            self.rec.end_ns = time.perf_counter_ns()
            _LOG.stack().pop()
        return False

    def note(self, **counts) -> None:
        if self.rec is None:
            return
        for k, v in counts.items():
            if not isinstance(v, int):
                raise TypeError(f"span count {k!r} must be a host int, "
                                f"not {type(v).__name__}")
        self.rec.counts.update(counts)


def span(name: str):
    """A context manager marking one layer boundary (module docstring);
    it yields an object whose note(**counts) attaches host ints."""
    if not _autograd_profiler._is_profiler_enabled:
        _LOG.live = False
        return _OFF
    return _Span(name)


def spans() -> SpanLog:
    """The log of the current or the last profiling session."""
    with _LOG.lock:
        return SpanLog(list(_LOG.records), _LOG.anchor, _LOG.dropped)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Trace the block with torch.profiler (the CPU with the program's
    spans, and the card's kernels where CUDA is available) and write it
    as a Chrome trace,
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
