"""device.idle_pct.waves: the device's idle share over the traced
window of iterations (prof.idle_pct)."""

from rtbench import prof


def read(run):
    return prof.idle_pct(run, "iterations")
