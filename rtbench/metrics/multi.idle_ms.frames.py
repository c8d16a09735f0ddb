"""multi.idle_ms.frames: device-idle ms a frame of the traced window
inside the program's multi.* spans (their self time: the instance scan's
gathers, host loop over the meshes and min-fold in multi.trace,
the TLAS block cull and its host read in multi.cull), by spans.table;
None where the window holds no multi.* span (a program without them)."""

from rtbench import spans


def read(run):
    got = spans.window_spans(run)
    if got is None or not any(n.startswith("multi.") for _, _, n, _ in got[0]):
        return None
    return spans.idle_ms(run, "frames", "multi.")
