"""stream3.idle_ms.waves: device-idle ms an iteration of the traced window
inside the program's stream3.* spans (their self time: prep, emit,
refine, isect, glue, residual and the trace's own), by spans.table."""

from rtbench import spans


def read(run):
    return spans.idle_ms(run, "iterations", "stream3.")
