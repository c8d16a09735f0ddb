"""multi.overlap_pct.frames: 100 x the (block, instance) pairs the TLAS
block cull let through (the program's block_pairs count) over the whole
grid of the waves' blocks by their scenes' instances (blocks x
instances), summed over the traced window's multi.trace spans that note
both."""

from rtbench import spans


def read(run):
    if run.window.get("unit") != "frames":
        return None
    got = spans.window_spans(run)
    if got is None:
        return None
    counts = [c for _, _, n, c in got[0] if n == "multi.trace"
              and {"block_pairs", "blocks", "instances"} <= set(c)]
    grid = sum(c["blocks"] * c["instances"] for c in counts)
    if not grid:
        return None
    return 100.0 * sum(c["block_pairs"] for c in counts) / grid
