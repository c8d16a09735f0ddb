"""engine.torch_ms_per_frame: torch.profiler device ms of torch's own
kernels (ATen, cub, thrust, copies, memsets: shading, glue,
accumulation) per frame of the traced window."""


def read(run):
    w, p = run.window, run.profile
    if not p or w.get("unit") != "frames" or not w.get("done"):
        return None
    return 1e3 * p["torch_s"] / w["done"]
