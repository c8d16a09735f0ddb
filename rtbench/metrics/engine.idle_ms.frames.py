"""engine.idle_ms.frames: device-idle ms a frame of the traced window
inside the program's engine.* spans (their self time: raygen, the
waves' route glue, shading, the finish, the re-trace), by spans.table."""

from rtbench import spans


def read(run):
    return spans.idle_ms(run, "frames", "engine.")
