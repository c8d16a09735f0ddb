"""The program's own spans (radiance_tpu_torch.utils.profiling.span) over
a traced window, and the device's idle time put down to them.

- window_spans: the spans of the program's log that start at or after
  the traced window's start (run.profile["t0_ns"]: set-up's spans, and
  those of a lost profile that run.py took again, drop out), and the
  offset that maps a device record onto their clock by the log's anchor
  (perf_counter_ns and the profiler records' clock read back to back);
  None where the program keeps no span log or the window holds no span;
- idle_by_span: every instant of every idle gap of prof.gaps(records)
  given to the innermost program span open then (the latest started: a
  span's self time), else to OUTSIDE, the harness's own code;
- table: that split of one run, in ns by span name, computed once a run
  and logged whole to stderr, with the longest gaps and the span open at
  the start of each;
- idle_ms / count_pct: the readers of the cells' metrics.
"""

import bisect
import heapq
import sys

from rtbench import prof

OUTSIDE = "outside the program"


def window_spans(run):
    """([(start ns, end ns, name, counts)] on perf_counter_ns, device ->
    perf offset ns, spans dropped) of the traced window, or None."""
    p = run.profile
    if not p:
        return None
    try:
        from radiance_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    log = read()
    if log.anchor is None:
        return None
    spans = [(r.start_ns, r.end_ns, r.name, r.counts) for r in log.records
             if r.start_ns >= p["t0_ns"] and r.end_ns]
    if not spans:
        return None
    return spans, log.anchor.perf_ns - log.anchor.device_ns, log.dropped


def _segments(spans):
    """[(start, end, name or None)]: the time from the first span's start
    to the last one's end in pieces, each labelled by the innermost span
    open over it (None between spans)."""
    ev = []
    for i, (s, e, _, _) in enumerate(spans):
        if e > s:
            ev.append((s, 1, i))
            ev.append((e, 0, i))
    ev.sort()                       # at one instant, ends before starts
    heap, closed, out, k = [], set(), [], 0
    while k < len(ev):
        t = ev[k][0]
        while k < len(ev) and ev[k][0] == t:
            _, opens, i = ev[k]
            if opens:
                heapq.heappush(heap, (-spans[i][0], -i))
            else:
                closed.add(i)
            k += 1
        while heap and -heap[0][1] in closed:
            heapq.heappop(heap)
        if k < len(ev):
            out.append((t, ev[k][0], spans[-heap[0][1]][2] if heap
                        else None))
    return out


def idle_by_span(recs, spans, offset):
    """{span name or OUTSIDE: idle ns}: each instant of every gap of
    prof.gaps(recs) (device clock; + offset gives perf_counter_ns) to the
    innermost span (start ns, end ns, name, counts) open then.  The
    values sum to the gaps' total exactly."""
    segs = _segments(spans)
    starts = [s[0] for s in segs]
    out = {}
    for g0, length in prof.gaps(recs):
        t = g0 + offset
        b = t + length
        j = bisect.bisect_right(starts, t) - 1
        while t < b:
            if j < 0:
                end, name = (starts[0] if starts else b), None
            elif j < len(segs) and t < segs[j][1]:
                end, name = segs[j][1], segs[j][2]
            else:
                end, name = b, None
            end = min(end, b)
            key = name or OUTSIDE
            out[key] = out.get(key, 0) + end - t
            t, j = end, j + 1
    return out


def _open_at(spans, t):
    """The innermost span open at t, or OUTSIDE."""
    inside = [sp for sp in spans if sp[0] <= t < sp[1]]
    return max(inside, key=lambda sp: sp[0])[2] if inside else OUTSIDE


def table(run):
    """idle_by_span of the run's traced window (None without program
    spans), computed once and logged to stderr."""
    if not hasattr(run, "span_idle"):
        got = window_spans(run)
        run.span_idle = None
        if got is not None:
            spans, offset, dropped = got
            run.span_idle = idle_by_span(run.profile["records"], spans,
                                         offset)
            rows = sorted(run.span_idle.items(), key=lambda kv: -kv[1])
            print(f"idle by program span ({len(spans)} spans in the window, "
                  f"{dropped} dropped; ms over the window): " + ", ".join(
                      f"{n} {ns / 1e6:.3f}" for n, ns in rows),
                  file=sys.stderr, flush=True)
            longest = sorted(prof.gaps(run.profile["records"]),
                             key=lambda g: -g[1])[:10]
            print("longest idle gaps by the program span open at their "
                  "start (ms): " + ", ".join(
                      f"{_open_at(spans, g + offset)} {n / 1e6:.3f}"
                      for g, n in longest), file=sys.stderr, flush=True)
    return run.span_idle


def idle_ms(run, unit, prefix):
    """Device-idle ms per `unit` (iterations or frames) of the traced
    window inside the spans named `prefix`*; None in other runs."""
    w = run.window
    if w.get("unit") != unit or not w.get("done"):
        return None
    tab = table(run)
    if tab is None:
        return None
    return sum(ns for n, ns in tab.items() if n.startswith(prefix)) \
        / 1e6 / w["done"]


def count_pct(run, unit, name, part, whole):
    """100 x the sum of count `part` over the sum of count `whole`, over
    the window's spans called `name`; None in other runs or where the
    window holds none."""
    if run.window.get("unit") != unit:
        return None
    got = window_spans(run)
    if got is None:
        return None
    counts = [c for _, _, n, c in got[0] if n == name and whole in c]
    total = sum(c[whole] for c in counts)
    if not total:
        return None
    return 100.0 * sum(c.get(part, 0) for c in counts) / total
