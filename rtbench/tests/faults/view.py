"""Faults planted in the program before a run of a cell whose traffic
names the view driver (rtbench/drivers/view.py): each must make the run
come out not correct.

NAME           the fault test is test_a_<NAME>_fault_is_not_correct
SECONDS        the window a fault run takes, in seconds: several frames,
               since the faults show from the second frame on
MIN_ATTEMPTED  the fewest frames a fault run must attempt
FAULTS         fault name -> Python that patches the program
"""

NAME = "view"
SECONDS = 40
MIN_ATTEMPTED = 2
FAULTS = {
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
