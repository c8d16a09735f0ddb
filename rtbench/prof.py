"""What the traced run reads from torch.profiler's device records.

- records / busy_s: copies of chip_smoke.py:967 kernel_records and
  :2113 busy_ms (the union of the kernel and copy intervals);
- profiled: chip_smoke.py:1000 profiled's retake of a profile that lost
  records, here judged by the launches the harness counted itself;
- idle_pct: 1 - busy_s over the traced window, both idle metrics' reader;
- is_torch: the frozen classifier of a device record as torch's own
  (ATen, cub, thrust, a memcpy or a memset) or the program's;
- breakdown: the device operations that took most time and the longest
  idle gaps, each gap named by the harness's host span it fell in.
"""

import contextlib
import time

import torch

TORCH_MARKS = ("at::", "at_cuda_detail", "cub::", "thrust::", "c10::",
               "Memcpy", "Memset", "memcpy", "memset")
TRIES = 3


def idle_pct(run, unit):
    """100 x (1 - the union of the device records' intervals / the
    profiled host time) over a traced window whose work is counted in
    `unit` (frames or iterations); None in any other run."""
    w, p = run.window, run.profile
    if not p or w.get("unit") != unit or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def is_torch(name: str) -> bool:
    """A device record is torch's own when its name carries one of
    TORCH_MARKS; every other record is one of the program's kernels."""
    return any(m in name for m in TORCH_MARKS)


def records(prof):
    """(name, start ns, duration ns) of every device record, by start."""
    return sorted(((e.name(), e.start_ns(), e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA),
                  key=lambda r: r[1])


def busy_s(recs) -> float:
    """Seconds in which some record ran: the union of their intervals."""
    total, end = 0, float("-inf")
    for _, s, dur in recs:
        e = s + dur
        if s > end:
            total, end = total + dur, e
        elif e > end:
            total, end = total + e - end, e
    return total / 1e9


def gaps(recs):
    """(start ns, length ns) of every gap between busy intervals."""
    out, end = [], None
    for _, s, dur in recs:
        if end is not None and s > end:
            out.append((end, s - end))
        end = s + dur if end is None else max(end, s + dur)
    return out


def by_name(recs, top=10):
    """The `top` record names by total seconds: [[name, seconds], ...]."""
    tot = {}
    for name, _, dur in recs:
        tot[name] = tot.get(name, 0) + dur
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:200], ns / 1e9] for name, ns in ranked]


@contextlib.contextmanager
def device_profile():
    """torch.profiler over the CUDA activity, warmed by one small kernel
    and a synchronize, closed by a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        yield p
        torch.cuda.synchronize()


def clock_offset_ns(recs, host_t0_ns):
    """The offset that maps a device record's start onto the host clock
    the harness's spans use (time.perf_counter_ns): the records are on
    the wall clock or on the monotonic clock; None when neither is near
    the window's start."""
    if not recs:
        return None
    first = recs[0][1]
    for clock in (time.time_ns, time.monotonic_ns, time.perf_counter_ns):
        off = time.perf_counter_ns() - clock()
        if abs(first + off - host_t0_ns) < 30e9:
            return off
    return None


def label_gaps(recs, spans, host_t0_ns, top=10):
    """The `top` longest idle gaps as [[label, seconds], ...]: the label
    is the innermost host span (name, start ns, end ns) that holds the
    gap's start, or "between spans"."""
    off = clock_offset_ns(recs, host_t0_ns)
    out = []
    for s, length in sorted(gaps(recs), key=lambda g: -g[1])[:top]:
        label = "unlabelled (no common clock)"
        if off is not None:
            at = s + off
            inside = [sp for sp in spans if sp[1] <= at < sp[2]]
            label = (min(inside, key=lambda sp: sp[2] - sp[1])[0]
                     if inside else "between spans")
        out.append([label, length / 1e9])
    return out
