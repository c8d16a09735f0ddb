"""The instance scan's readers on hand-made span logs:
multi.overlap_pct.frames (100 x the block pairs the TLAS cull let
through over the blocks x instances grid), multi.poisoned_pct.frames
(100 x the poisoned rays over the rays) and multi.idle_ms.frames (the
device's idle in multi.* spans a frame); each None on a program without
the spans (an older program), outside the view cells' unit, or on
spans before the traced window."""

import types

import pytest

from rtbench import harness


def _run(t0, unit, recs=(("k", 0, 10),)):
    return types.SimpleNamespace(
        profile={"records": list(recs), "t0_ns": t0},
        window={"unit": unit, "done": 2})


@pytest.fixture
def fake_log(monkeypatch):
    from radiance_tpu_torch.utils import profiling

    def set_log(spans):
        records = [profiling.SpanRecord(name, start, end, -1, 0, 1, counts)
                   for name, start, end, counts in spans]
        log = types.SimpleNamespace(
            records=records, dropped=0,
            anchor=profiling.Anchor(perf_ns=0, device_ns=0))
        monkeypatch.setattr(profiling, "spans", lambda: log)
    return set_log


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


SCAN = dict(rays=1000, instances=64, instances_run=10, blocks=64,
            block_pairs=128, poisoned=0)


def test_overlap_and_poisoned_over_the_window(fake_log):
    fake_log([("multi.trace", 10, 20, dict(SCAN, poisoned=500)),  # set-up
              ("multi.trace", 100, 200, SCAN),
              ("multi.cull", 110, 120, {}),
              ("multi.trace", 300, 400, dict(SCAN, block_pairs=384,
                                             poisoned=10))])
    run = _run(50, "frames")
    assert _read("multi.overlap_pct.frames", run) == pytest.approx(
        100.0 * (128 + 384) / (2 * 64 * 64))
    assert _read("multi.poisoned_pct.frames", run) == pytest.approx(0.5)


def test_native_spans_without_block_pairs_are_left_out(fake_log):
    native = dict(rays=1000, instances=64, blocks=64, poisoned=0)
    fake_log([("multi.trace", 100, 200, SCAN),
              ("multi.trace", 300, 400, native)])
    run = _run(50, "frames")
    assert _read("multi.overlap_pct.frames", run) == pytest.approx(
        100.0 * 128 / (64 * 64))
    assert _read("multi.poisoned_pct.frames", run) == 0.0


def test_idle_in_multi_spans_a_frame(fake_log):
    # device busy 0-10 and 400-410: the gap 10-400 falls in the spans
    fake_log([("multi.trace", 0, 300, SCAN), ("multi.cull", 50, 100, {}),
              ("stream3.prep", 100, 200, {})])
    run = _run(0, "frames", [("k", 0, 10), ("k", 400, 10)])
    # multi.trace 10-50 and 200-300, multi.cull 50-100: 190 ns, 2 frames
    assert _read("multi.idle_ms.frames", run) == pytest.approx(190 / 1e6 / 2)


@pytest.mark.parametrize("name", ["multi.overlap_pct.frames",
                                  "multi.poisoned_pct.frames",
                                  "multi.idle_ms.frames"])
def test_parent_and_other_cells_read_none(fake_log, name):
    # a parent without the instance scan's spans
    fake_log([("engine.shade", 100, 200, {"rays": 64, "fused_rays": 64})])
    assert _read(name, _run(50, "frames", [("k", 0, 10), ("k", 300, 10)])) \
        is None
    fake_log([("multi.trace", 100, 200, SCAN)])
    assert _read(name, _run(50, "iterations")) is None
    fake_log([])
    assert _read(name, _run(50, "frames")) is None
