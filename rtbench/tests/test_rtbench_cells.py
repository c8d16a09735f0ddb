"""Whole runs of each cell on the CPU at tiny sizes (a copy of the
benchmark cut to conftest.TINY, the program's kernels in their plain
versions): the control comes out not correct, and so does every fault
planted in the timed path underneath the harness."""

import json

import pytest

from conftest import run_cli

CELLS = ["city_waves", "interior_waves", "city_view", "interior_view"]

# faults planted in the program before the run (see each cell's driver)
WAVE_FAULTS = {
    # a step that returns its state unchanged: the primary wave hands back
    # the record of its first call forever
    "unchanged": """
from radiance_tpu_torch.ops import stream3
_build = stream3.build_tracer
def build_tracer(*a, **k):
    tr, held = _build(*a, **k), []
    def stale(*x, **y):
        if not held:
            held.append(tr(*x, **y))
        return held[0]
    return stale
stream3.build_tracer = build_tracer
""",
    # half of each wave left out: the second half of the live rays reports
    # a miss
    "half": """
from radiance_tpu_torch.ops import packet_trace
_trace = packet_trace.trace_rays_packet
def trace_rays_packet(scene, o, d, tmin, tmax, any_hit=False, live=None):
    live = live.clone()
    live[live.shape[0] // 2:] = False
    return _trace(scene, o, d, tmin, tmax, any_hit=any_hit, live=live)
packet_trace.trace_rays_packet = trace_rays_packet
""",
    # an answer altered where it is produced: the primary wave's hits name
    # the next triangle (the city's mirror bounces, straight back along
    # the primary, hit nothing to alter)
    "altered": """
import torch
from radiance_tpu_torch.ops import stream3
_build = stream3.build_tracer
def build_tracer(*a, **k):
    tr = _build(*a, **k)
    def altered(*x, **y):
        rec = tr(*x, **y)
        rec.prim = torch.where(rec.prim >= 0, rec.prim + 1, rec.prim)
        return rec
    return altered
stream3.build_tracer = build_tracer
""",
}
VIEW_FAULTS = {
    # a frame that returns its state unchanged: TraceRays does nothing
    # after its first call
    "unchanged": """
from radiance_tpu_torch.api import pipeline
_trace, calls = pipeline.TraceRays, []
def TraceRays(*a, **k):
    calls.append(1)
    if len(calls) == 1:
        _trace(*a, **k)
pipeline.TraceRays = TraceRays
""",
    # half of the samples left out, the mean taken over the rest: every
    # odd frame's samples are dropped from the running average
    "half": """
from radiance_tpu_torch.engine import pathtracer
_finish = pathtracer._finish_frame
def _finish_frame(tracer, batch, debug, accum, colors, total_samples):
    if (total_samples // batch) % 2:
        return _finish(tracer, batch, debug, accum, accum * batch, total_samples)
    return _finish(tracer, batch, debug, accum, colors, total_samples)
pathtracer._finish_frame = _finish_frame
""",
    # an answer altered where it is produced: every hit of the engine's
    # waves reports half its distance
    "altered": """
import torch
from radiance_tpu_torch.engine import pathtracer
from radiance_tpu_torch.ops.intersect import FLT_MAX
_wave = pathtracer._traced_wavefront
def _traced_wavefront(*a, **k):
    rec = _wave(*a, **k)
    rec.t = torch.where(rec.t < FLT_MAX, rec.t * 0.5, rec.t)
    return rec
pathtracer._traced_wavefront = _traced_wavefront
""",
}


def run_cell(tiny, cell, seed, extra=(), prelude="", seconds=2):
    rc, out, err = run_cli(tiny, ["--workload", cell, "--seed", str(seed),
                                  "--seconds", str(seconds), "--trace", "0",
                                  "--cpu",
                                  *extra], prelude=prelude)
    assert rc == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_checks_its_numbers(tiny, cell):
    line, err = run_cell(tiny, cell, 2 ** 31 + 17)
    assert line["correct"] is True, err[-2000:]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["checked"] and all(
        set(v) == {"value", "limit"} for v in line["checked"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny, cell):
    line, _ = run_cell(tiny, cell, 11, ["--control", "bf16"])
    assert line["correct"] is False


@pytest.mark.parametrize("fault", sorted(WAVE_FAULTS))
@pytest.mark.parametrize("cell", ["city_waves", "interior_waves"])
def test_a_wave_fault_is_not_correct(tiny, cell, fault):
    line, err = run_cell(tiny, cell, 5, prelude=WAVE_FAULTS[fault])
    assert line["correct"] is False, err[-2000:]


@pytest.mark.parametrize("fault", sorted(VIEW_FAULTS))
@pytest.mark.parametrize("cell", ["city_view", "interior_view"])
def test_a_view_fault_is_not_correct(tiny, cell, fault):
    # a window of several frames: the faults show from the second on
    line, err = run_cell(tiny, cell, 5, prelude=VIEW_FAULTS[fault],
                         seconds=40)
    assert line["attempted"] >= 2
    assert line["correct"] is False, err[-2000:]
