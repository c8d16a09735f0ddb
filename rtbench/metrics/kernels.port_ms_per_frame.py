"""kernels.port_ms_per_frame: torch.profiler device ms of the program's
own kernels (prof.is_torch false) per frame of the traced window."""


def read(run):
    w, p = run.window, run.profile
    if not p or w.get("unit") != "frames" or not w.get("done"):
        return None
    return 1e3 * p["port_s"] / w["done"]
