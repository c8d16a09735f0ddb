"""The plain reference tracer: closest hit and any hit against a
triangle soup, in plain torch, built from the vertices alone.

It shares nothing with the program: its own tree (triangles sorted by
the Morton code of their centroids, LEAF to a leaf, over an implicit
complete binary tree whose boxes are reduced level by level), its own
walk (one node a step for every ray at once, near child first, a stack
per ray) and its own ray-triangle test (Moller-Trumbore).  Every
computation runs in `dtype`: float32 for the reference, bfloat16 for the
control that stands one precision below it.
"""

import dataclasses

import torch

LEAF = 8
STACK = 64
FLT_MAX = 3.4028234663852886e38


def _spread10(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    return (v | (v << 2)) & 0x9249249


@dataclasses.dataclass
class Tree:
    nleaf: int               # leaves, a power of two; node k's children
    lo: torch.Tensor         # are 2k and 2k+1, leaves are [nleaf, 2nleaf)
    hi: torch.Tensor         # [2 * nleaf, 3] boxes (row 0 unused)
    mid: torch.Tensor        # [2 * nleaf, 3] box centres
    full: torch.Tensor       # [2 * nleaf] the node holds a triangle
    v0: torch.Tensor         # [nleaf * LEAF, 3] in leaf order
    e1: torch.Tensor
    e2: torch.Tensor
    prim: torch.Tensor       # [nleaf * LEAF] triangle index, -1 on a pad


def build(tri_verts, dtype=torch.float32):
    """tri_verts: [T, 3, 3] float32 corners (any device)."""
    dev = tri_verts.device
    t = tri_verts.shape[0]
    c = tri_verts.mean(1)
    lo, hi = c.min(0).values, c.max(0).values
    q = ((c - lo) / torch.clamp(hi - lo, min=1e-30) * 1023.0)
    q = torch.clamp(q, 0, 1023).to(torch.int64)
    code = (_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1) \
        | _spread10(q[:, 2])
    order = torch.argsort(code, stable=True)
    nleaf = 1
    while nleaf * LEAF < t:
        nleaf *= 2
    prim = torch.full((nleaf * LEAF,), -1, dtype=torch.int64, device=dev)
    prim[:t] = order
    tv = tri_verts[torch.clamp(prim, min=0)].to(dtype)
    pad = (prim < 0)[:, None]
    big = torch.tensor(float("inf"), dtype=dtype, device=dev)
    box_lo = torch.where(pad, big, tv.amin(1)).view(nleaf, LEAF, 3).amin(1)
    box_hi = torch.where(pad, -big, tv.amax(1)).view(nleaf, LEAF, 3).amax(1)
    lo_all = torch.empty((2 * nleaf, 3), dtype=dtype, device=dev)
    hi_all = torch.empty_like(lo_all)
    full = torch.zeros(2 * nleaf, dtype=torch.bool, device=dev)
    lo_all[nleaf:], hi_all[nleaf:] = box_lo, box_hi
    full[nleaf:] = ~pad.view(nleaf, LEAF).all(1)
    s = nleaf // 2
    while s >= 1:
        lo_all[s:2 * s] = torch.minimum(lo_all[2 * s:4 * s:2],
                                        lo_all[2 * s + 1:4 * s:2])
        hi_all[s:2 * s] = torch.maximum(hi_all[2 * s:4 * s:2],
                                        hi_all[2 * s + 1:4 * s:2])
        full[s:2 * s] = full[2 * s:4 * s:2] | full[2 * s + 1:4 * s:2]
        s //= 2
    # an empty node's box is the origin point; `full` keeps walks out
    lo_all = torch.where(full[:, None], lo_all, 0.0)
    hi_all = torch.where(full[:, None], hi_all, 0.0)
    v0 = tv[:, 0]
    # a pad's corners are NaN: every comparison with its t is False
    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)
    v0 = torch.where(pad, nan, v0)
    return Tree(nleaf, lo_all, hi_all, 0.5 * (lo_all + hi_all), full, v0, tv[:, 1] - tv[:, 0],
                tv[:, 2] - tv[:, 0], prim)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def trace(tree: Tree, o, d, tmin, tmax, any_hit=False, live=None):
    """Closest hit (or, with any_hit, the first hit found) of each ray.
    o, d: [R, 3]; live: [R] bool, dead rays miss.  Returns (t, prim, u,
    v): t FLT_MAX (as float32) and prim -1 on a miss, u and v the
    barycentrics of corners 1 and 2; all float32 / int64 [R]."""
    dtype = tree.v0.dtype
    dev = o.device
    r = o.shape[0]
    o = o.to(dtype)
    d = d.to(dtype)
    inv = 1.0 / d
    best_t = torch.full((r,), float(tmax), dtype=dtype, device=dev)
    best_p = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(r, dtype=dtype, device=dev)
    best_v = torch.zeros(r, dtype=dtype, device=dev)
    stack = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    sp = torch.zeros(r, dtype=torch.int64, device=dev)
    node = torch.ones(r, dtype=torch.int64, device=dev)
    act = (torch.ones(r, dtype=torch.bool, device=dev) if live is None
           else live.clone())
    lanes = torch.arange(LEAF, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    lo_t = torch.tensor(float(tmin), dtype=dtype, device=dev)
    # one node a step for every live ray; the only host read is the
    # compaction of the live rays
    while True:
        ids = torch.nonzero(act).squeeze(1)
        if ids.numel() == 0:
            break
        n, spi = node[ids], sp[ids]
        oo, dd, ii, bt = o[ids], d[ids], inv[ids], best_t[ids]
        t0 = (tree.lo[n] - oo) * ii
        t1 = (tree.hi[n] - oo) * ii
        tn = torch.fmax(torch.fmin(t0, t1).amax(-1), lo_t)
        tf = torch.fmax(t0, t1).amin(-1)
        enter = (tn <= tf) & (tn < bt) & tree.full[n]
        leaf = enter & (n >= tree.nleaf)
        inner = enter & (n < tree.nleaf)
        # a leaf: test its LEAF triangles (rows of any other node are
        # tested too and masked off)
        rows = torch.clamp(n - tree.nleaf, min=0)[:, None] * LEAF + lanes
        v0, e1, e2 = tree.v0[rows], tree.e1[rows], tree.e2[rows]
        dl = dd[:, None]
        p = _cross(dl, e2)
        idet = 1.0 / _dot(e1, p)
        s = oo[:, None] - v0
        u = _dot(s, p) * idet
        qv = _cross(s, e1)
        v = _dot(dl, qv) * idet
        t = _dot(e2, qv) * idet
        ok = (leaf[:, None] & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t > tmin) & (t < bt[:, None]))
        tb, k = torch.where(ok, t, inf).min(-1)
        got = ok.any(-1)
        kk = k[:, None]
        best_t[ids] = torch.where(got, tb, bt)
        best_p[ids] = torch.where(got, tree.prim[rows.gather(1, kk)[:, 0]],
                                  best_p[ids])
        best_u[ids] = torch.where(got, u.gather(1, kk)[:, 0], best_u[ids])
        best_v[ids] = torch.where(got, v.gather(1, kk)[:, 0], best_v[ids])
        # an inner node: go to the nearer child, push the other; any
        # other node pops, or ends the walk on an empty stack
        c0 = 2 * n
        m0 = _dot(tree.mid[torch.clamp(c0, max=2 * tree.nleaf - 2)] - oo, dd)
        m1 = _dot(tree.mid[torch.clamp(c0 + 1, max=2 * tree.nleaf - 1)] - oo,
                  dd)
        first = m0 <= m1
        near = torch.where(first, c0, c0 + 1)
        far = torch.where(first, c0 + 1, c0)
        slot = torch.clamp(torch.where(inner, spi, spi - 1), 0, STACK - 1)
        top = stack[ids, slot]
        stack[ids, slot] = torch.where(inner, far, top)
        empty = ~inner & (spi == 0)
        node[ids] = torch.where(inner, near, top)
        sp[ids] = torch.where(inner, spi + 1, torch.clamp(spi - 1, min=0))
        done = empty | got if any_hit else empty
        act[ids] = ~done
    hit = best_p >= 0
    t_out = torch.where(hit, best_t.to(torch.float32),
                        torch.tensor(FLT_MAX, dtype=torch.float32,
                                     device=dev))
    return (t_out, best_p, best_u.to(torch.float32),
            best_v.to(torch.float32))
