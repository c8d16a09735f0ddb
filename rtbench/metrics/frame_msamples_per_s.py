"""frame_msamples_per_s: width x height x batch for every frame completed
in the window (its image read back), over the window's seconds, host
clock."""


def read(run):
    w = run.window
    if w.get("unit") != "frames" or not w.get("window_s"):
        return None
    return w["samples"] / w["window_s"] / 1e6
