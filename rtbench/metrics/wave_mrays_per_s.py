"""wave_mrays_per_s: 3 x 1920 x 1080 rays for every iteration of the
three waves the window completed, over the window's seconds (it ends in a
synchronize), host clock; bench.py's own definition."""


def read(run):
    w = run.window
    if w.get("unit") != "iterations" or not w.get("window_s"):
        return None
    return w["rays"] / w["window_s"] / 1e6
