"""Faults planted in the program before a run of a cell whose traffic
names the waves driver (rtbench/drivers/waves.py): each must make the
run come out not correct.

NAME           the fault test is test_a_<NAME>_fault_is_not_correct
SECONDS        the window a fault run takes, in seconds
MIN_ATTEMPTED  the fewest iterations a fault run must attempt
FAULTS         fault name -> Python that patches the program
"""

NAME = "wave"
SECONDS = 2
MIN_ATTEMPTED = 1
FAULTS = {
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
