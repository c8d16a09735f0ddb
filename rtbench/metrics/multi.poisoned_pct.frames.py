"""multi.poisoned_pct.frames: 100 x the rays the many-instance traces
returned poisoned, slot == -2 (the program's poisoned count: a ray of a
step-capped or overflowed sub-wave, which the engine then reads as a
miss or as unoccluded) over the rays they traced (rays), summed over the
traced window's multi.trace spans."""

from rtbench import spans


def read(run):
    return spans.count_pct(run, "frames", "multi.trace", "poisoned", "rays")
