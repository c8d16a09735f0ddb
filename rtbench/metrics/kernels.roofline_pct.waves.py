"""kernels.roofline_pct.waves: the least time the card could take for the
window's waves over the program's kernel device time in the traced
window, in percent (roofline.py)."""

from rtbench import roofline


def read(run):
    w, p = run.window, run.profile
    if not p or w.get("unit") != "iterations" or not p["port_s"]:
        return None
    least = roofline.wave_least_s(w["n"], w["n_tris"]) * w["done"]
    return 100.0 * least / p["port_s"]
