"""Faults planted in the program before a run of a cell whose traffic
names the view_glb driver (rtbench/drivers/view_glb.py): the view
driver's three (rtbench/tests/faults/view.py), and one of the instance
scan's own.  Each must make the run come out not correct.

NAME           the fault test is test_a_<NAME>_fault_is_not_correct
SECONDS        the window a fault run takes, in seconds: several frames,
               since the view faults show from the second frame on
MIN_ATTEMPTED  the fewest frames a fault run must attempt
FAULTS         fault name -> Python that patches the program
"""

import os

from rtbench import harness

_VIEW = harness.load_module("faults", "view", os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

NAME = "view_glb"
SECONDS = 60                # two tiny frames of up to 30 s each on the CPU
MIN_ATTEMPTED = 2
FAULTS = dict(_VIEW.FAULTS, **{
    # an instance lost by the TLAS level: the block cull of every
    # many-instance trace drops the last instance that any block
    # overlaps, so that trace_rows_multi skips its sub-wave
    "skipped": """
from radiance_tpu_torch.ops import stream3_multi
_overlap = stream3_multi._block_overlap
def _block_overlap(*a, **k):
    ov = _overlap(*a, **k)
    hit = ov.any(dim=0).nonzero().flatten()
    if hit.numel():
        ov[:, hit[-1]] = False
    return ov
stream3_multi._block_overlap = _block_overlap
""",
})
