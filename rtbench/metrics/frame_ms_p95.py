"""frame_ms_p95: the 95th percentile of the host-clock time between
successive frame completions (the first from the window's start), over
every frame of the window."""

from rtbench import harness


def read(run):
    w = run.window
    if w.get("unit") != "frames" or not w.get("done"):
        return None
    return 1e3 * harness.p95(harness.frame_intervals(w["t0"],
                                                     w["completions"]))
