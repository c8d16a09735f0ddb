"""stream3.residual_pct.waves: 100 x the rays stream3 re-traced exactly
(the flagged packets' and the temporal residual's, the program's
residual_rays count) over the rays it traced (rays), summed over the
traced window's stream3.trace spans."""

from rtbench import spans


def read(run):
    return spans.count_pct(run, "iterations", "stream3.trace",
                           "residual_rays", "rays")
