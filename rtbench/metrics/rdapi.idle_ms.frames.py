"""rdapi.idle_ms.frames: device-idle ms a frame of the traced window
inside the program's rdapi.* spans (their self time: the frame's
callback, TraceRays, its parse, the read-back), by spans.table."""

from rtbench import spans


def read(run):
    return spans.idle_ms(run, "frames", "rdapi.")
