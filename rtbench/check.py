"""The comparisons that decide `correct`, and their readings.

Each judge computes its readings, logs them all, and compares those that
the cell's limits file (rtbench/limits/<workload>.json) names: a run is
correct when every named reading is at most its limit.  PERF.md gives,
for each limit, the readings it was set from.
"""

import sys

import torch

FLT_MAX = 3.4028234663852886e38


def _numbers(readings, limits):
    print("readings: " + ", ".join(f"{k} {v!r}" for k, v in
                                   readings.items()), file=sys.stderr)
    numbers = [(name, readings[name], limits[name]) for name in limits]
    return all(v <= lim for _, v, lim in numbers), numbers


def wave_readings(got, ref):
    """got: per checked iteration a [5, k] tensor (t1, prim1, t2, prim2,
    t3) of the program's; ref: the reference's dicts (o, t1, p1, o2, t2,
    p2, occ).  Readings over all checked rays:
      hit_mismatch   share of rays whose hit (primary, bounce) or
                     occlusion (shadow) differs, of 3 x rays;
      prim_mismatch  share of primary and bounce rays hit on both sides
                     whose triangle differs;
      t_rel_p99      99th percentile of |dt| / (|o| + t) over primary and
                     bounce rays hit on both sides on the same triangle;
      t_rel_max      its largest value."""
    n = hm = pm = both = 0
    rel = []
    for g, r in zip(got, ref):
        for t_g, p_g, t_r, p_r, o in ((g[0], g[1], r["t1"], r["p1"], r["o"]),
                                      (g[2], g[3], r["t2"], r["p2"],
                                       r["o2"])):
            h_g, h_r = t_g < FLT_MAX, p_r >= 0
            hm += int((h_g != h_r).sum())
            b = h_g & h_r
            same = b & (p_g.to(torch.int64) == p_r)
            both += int(b.sum())
            pm += int((b & ~same).sum())
            t_r32 = t_r.to(torch.float32)
            rel.append(((t_g - t_r32).abs()
                        / (torch.linalg.vector_norm(o, dim=-1) + t_r32))[same])
        hm += int(((g[4] < FLT_MAX) != r["occ"]).sum())
        n += 3 * g.shape[1]
    rel = torch.cat(rel).to(torch.float64)
    return dict(
        hit_mismatch=hm / max(n, 1), prim_mismatch=pm / max(both, 1),
        t_rel_p99=float(torch.quantile(rel, 0.99)) if rel.numel() else 0.0,
        t_rel_max=float(rel.max()) if rel.numel() else 0.0,
        rays_checked=n)


def judge_waves(got, ref, limits):
    return _numbers(wave_readings(got, ref), limits)


def view_readings(u8_g, u8_r):
    """The program's u8 images [F, P, 3] at the checked pixels after each
    checked frame against the reference's:
      u8_mean_gap  the mean |du8| over frames, pixels and channels;
      u8_max_gap   the widest |du8|;
      u8_gap_share the share of values whose |du8| exceeds 1."""
    du = (u8_g.to(torch.float64) - u8_r.to(torch.float64)).abs()
    return dict(u8_mean_gap=float(du.mean()), u8_max_gap=float(du.max()),
                u8_gap_share=float((du > 1).to(torch.float64).mean()),
                frames_checked=int(u8_g.shape[0]),
                pixels_checked=int(u8_g.shape[1]))


def judge_view(u8_g, u8_r, limits):
    return _numbers(view_readings(u8_g, u8_r), limits)
