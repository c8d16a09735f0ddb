"""engine.fused_shade_pct.frames on hand-made span logs: 100.0 where every
engine.shade span of the traced window ran the fused material wave, its
share where some did not, and None where the spans carry no counts (a
program without the counter), outside the view cells' unit, or without
spans."""

import types

import pytest

from rtbench import harness


def _run(t0, unit):
    return types.SimpleNamespace(
        profile={"records": [("k", 0, 10)], "t0_ns": t0},
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


def _read(run):
    return harness.load_module("metrics",
                               "engine.fused_shade_pct.frames").read(run)


def test_every_wave_fused_reads_100(fake_log):
    fake_log([("engine.shade", 100, 200, {"rays": 64, "fused_rays": 64}),
              ("engine.trace.shadow", 120, 150, {}),
              ("engine.shade", 300, 400, {"rays": 64, "fused_rays": 64})])
    assert _read(_run(50, "frames")) == 100.0


def test_share_counts_only_the_window(fake_log):
    fake_log([("engine.shade", 10, 20, {"rays": 64, "fused_rays": 0}),
              ("engine.shade", 100, 200, {"rays": 64, "fused_rays": 64}),
              ("engine.shade", 300, 400, {"rays": 192, "fused_rays": 0})])
    assert _read(_run(50, "frames")) == 25.0


def test_parent_and_other_cells_read_none(fake_log):
    # the parent's engine.shade spans note no counts
    fake_log([("engine.shade", 100, 200, {}),
              ("engine.shade", 300, 400, {})])
    assert _read(_run(50, "frames")) is None
    fake_log([("engine.shade", 100, 200, {"rays": 64, "fused_rays": 64})])
    assert _read(_run(50, "iterations")) is None
    fake_log([])
    assert _read(_run(50, "frames")) is None
