"""engine.fused_shade_pct.frames: 100 x the lanes shaded by the fused
material wave (the program's fused_rays count) over the lanes of every
closest-hit wave (rays), summed over the traced window's engine.shade
spans."""

from rtbench import spans


def read(run):
    return spans.count_pct(run, "frames", "engine.shade", "fused_rays",
                           "rays")
