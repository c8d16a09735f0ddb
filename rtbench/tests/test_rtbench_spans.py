"""rtbench/spans.py on synthetic device records and program spans: the
idle split sums to prof.gaps to the nanosecond, the innermost span takes
each instant, spans before the window's start are left out, and the
readers return None outside their cells' unit or without spans."""

import random
import types

import pytest

from rtbench import prof, spans


def _rec(start, dur):
    return ("k", start, dur)


def test_split_sums_to_the_gaps_exactly():
    rng = random.Random(5)
    recs, t = [], 1_000
    for _ in range(400):
        t += rng.randrange(0, 900)
        d = rng.randrange(1, 700)
        recs.append(_rec(t, d))
        t += rng.choice((0, d // 2, d))
    sp = []
    for _ in range(120):
        s = rng.randrange(0, t)
        sp.append((s, s + rng.randrange(0, 5_000), f"l{rng.randrange(4)}",
                   {}))
    offset = rng.randrange(-3_000, 3_000)
    got = spans.idle_by_span(sorted(recs, key=lambda r: r[1]), sp, offset)
    want = sum(g for _, g in prof.gaps(sorted(recs, key=lambda r: r[1])))
    assert want > 0 and sum(got.values()) == want
    assert spans.OUTSIDE in got


def test_innermost_span_takes_each_instant():
    # device busy [0, 100) and [1000, 1100): one gap [100, 1000)
    recs = [_rec(0, 100), _rec(1000, 100)]
    sp = [(50, 900, "outer", {}),        # holds inner, then its own tail
          (200, 400, "inner", {}),
          (300, 350, "leaf", {}),
          (600, 700, "late", {})]       # starts later: innermost there
    got = spans.idle_by_span(recs, sp, 0)
    assert got == {"outer": (200 - 100) + (600 - 400) + (900 - 700),
                   "inner": (300 - 200) + (400 - 350),
                   "leaf": 50, "late": 100,
                   spans.OUTSIDE: 1000 - 900}
    # an offset moves the device records onto the spans' clock
    shifted = spans.idle_by_span([_rec(-10, 100), _rec(990, 100)], sp, 10)
    assert shifted == got


class _Log:
    def __init__(self, records, anchor, dropped=0):
        self.records, self.anchor, self.dropped = records, anchor, dropped


def _run(recs, t0, unit, done):
    return types.SimpleNamespace(
        profile={"records": recs, "t0_ns": t0},
        window={"unit": unit, "done": done})


@pytest.fixture
def fake_log(monkeypatch):
    from radiance_tpu_torch.utils import profiling

    def set_log(records, perf_ns=0, device_ns=0):
        anchor = profiling.Anchor(perf_ns=perf_ns, device_ns=device_ns)
        monkeypatch.setattr(profiling, "spans",
                            lambda: _Log(records, anchor))
    return set_log


def _span(name, start, end, **counts):
    from radiance_tpu_torch.utils import profiling
    return profiling.SpanRecord(name, start, end, -1, 0, 1, counts)


def test_spans_before_the_window_are_left_out(fake_log):
    recs = [_rec(0, 100), _rec(1000, 100)]
    fake_log([_span("stream3.prep", 100, 1000),        # set-up's
              _span("stream3.emit", 500, 900),
              _span("stream3.trace", 400, 950, rays=10, residual_rays=1)],
             perf_ns=5, device_ns=5)
    run = _run(recs, 400, "iterations", 2)
    got, offset, dropped = spans.window_spans(run)
    assert [s[2] for s in got] == ["stream3.emit", "stream3.trace"]
    assert offset == 0 and dropped == 0
    tab = spans.table(run)
    assert spans._open_at([(500, 900, "emit", {}), (400, 950, "trace", {})],
                          600) == "emit"
    assert spans._open_at([(500, 900, "emit", {})], 950) == spans.OUTSIDE
    assert tab == {spans.OUTSIDE: 300 + 50, "stream3.trace": 100 + 50,
                   "stream3.emit": 400}
    assert sum(tab.values()) == 900
    assert spans.idle_ms(run, "iterations", "stream3.") == 550 / 1e6 / 2
    assert spans.idle_ms(run, "frames", "stream3.") is None
    assert spans.count_pct(run, "iterations", "stream3.trace",
                           "residual_rays", "rays") == 10.0


def test_readers_without_program_spans(fake_log, monkeypatch):
    fake_log([_span("rdapi.frame", 0, 50)])
    run = _run([_rec(0, 10), _rec(100, 10)], 60, "frames", 3)
    assert spans.window_spans(run) is None
    assert spans.idle_ms(run, "frames", "rdapi.") is None
    assert spans.count_pct(run, "frames", "stream3.trace", "a", "b") is None
    # a program without a span log (the parent of the spans) reads None
    from radiance_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    run = _run([_rec(0, 10)], 0, "frames", 3)
    assert spans.idle_ms(run, "frames", "rdapi.") is None
    assert spans.window_spans(_run([], 0, "frames", 0)) is None
