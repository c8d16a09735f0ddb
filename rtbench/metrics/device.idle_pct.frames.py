"""device.idle_pct.frames: the device's idle share over the traced
window of frames (prof.idle_pct)."""

from rtbench import prof


def read(run):
    return prof.idle_pct(run, "frames")
