"""The closed interior hall: a frozen copy of
radiance_tpu_torch/scene/procedural.py:202 interior_hall (with
_displaced_grid, :150, and _fluted_column, :181), which is itself a copy
of the JAX package's generator (bench.py's RADIANCE_BENCH_SCENE=interior).

A cathedral-class hall (the reference's house and cathedral scenes,
sample1.cpp:344-360): a tessellated shell, two colonnades, floor clutter
and ceiling window openings, so nearly every primary ray hits and a
fraction of shadow rays escape.
"""

import numpy as np


def _displaced_grid(origin, eu, ev, nu, nv, bump, rng, skip=None):
    origin = np.asarray(origin, np.float64)
    eu = np.asarray(eu, np.float64)
    ev = np.asarray(ev, np.float64)
    u = np.linspace(0.0, 1.0, nu + 1)
    v = np.linspace(0.0, 1.0, nv + 1)
    pts = (origin[None, None]
           + u[:, None, None] * eu[None, None]
           + v[None, :, None] * ev[None, None])
    nrm = np.cross(eu, ev)
    nrm = nrm / max(np.linalg.norm(nrm), 1e-12)
    h = rng.normal(scale=bump, size=(nu + 1, nv + 1))
    h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0)
         + np.roll(h, 1, 1) + np.roll(h, -1, 1)) / 5.0
    h[0, :] = h[-1, :] = 0.0
    h[:, 0] = h[:, -1] = 0.0
    pts = pts + h[:, :, None] * nrm[None, None]
    c00, c10 = pts[:-1, :-1], pts[1:, :-1]
    c01, c11 = pts[:-1, 1:], pts[1:, 1:]
    if skip is not None:
        keep = ~skip
        c00, c10, c01, c11 = (c[keep] for c in (c00, c10, c01, c11))
    else:
        c00, c10, c01, c11 = (c.reshape(-1, 3)
                              for c in (c00, c10, c01, c11))
    t1 = np.stack([c00, c10, c11], axis=1)
    t2 = np.stack([c00, c11, c01], axis=1)
    return np.concatenate([t1, t2]).astype(np.float32)


def _fluted_column(cx, cz, y0, y1, radius, nseg, nz, rng):
    th = np.linspace(0.0, 2.0 * np.pi, nseg + 1)
    ys = np.linspace(y0, y1, nz + 1)
    flute = 1.0 + 0.06 * np.cos(th * 8)[None, :]
    swell = 1.0 + 0.10 * np.sin(np.linspace(0, np.pi, nz + 1))[:, None]
    r = radius * flute * swell
    x = cx + r * np.cos(th)[None, :]
    z = cz + r * np.sin(th)[None, :]
    y = np.broadcast_to(ys[:, None], x.shape)
    pts = np.stack([x, y, z], axis=-1)
    c00, c10 = pts[:-1, :-1], pts[1:, :-1]
    c01, c11 = pts[:-1, 1:], pts[1:, 1:]
    c00, c10, c01, c11 = (c.reshape(-1, 3)
                          for c in (c00, c10, c01, c11))
    t1 = np.stack([c00, c10, c11], axis=1)
    t2 = np.stack([c00, c11, c01], axis=1)
    return np.concatenate([t1, t2]).astype(np.float32)


def generate(n_tris: int, seed: int = 11):
    """(verts [3T, 3] f32, tris [T, 3] u32) of the hall at about n_tris
    triangles (the shell 40%, 20 columns 24%, 120 clutter clusters)."""
    rng = np.random.default_rng(seed)
    HX, HY, HZ = 20.0, 12.0, 50.0
    parts = []

    shell_budget = int(n_tris * 0.40)
    total_area = (2 * (2 * HX * 2 * HZ) + 2 * (HY * 2 * HZ)
                  + 2 * (2 * HX * HY))
    quad_area = total_area / max(shell_budget // 2, 1)
    cell = max(np.sqrt(quad_area), 1e-3)

    def grid_n(lu, lv):
        return max(int(round(lu / cell)), 1), max(int(round(lv / cell)), 1)

    nu, nv = grid_n(2 * HX, 2 * HZ)
    parts.append(_displaced_grid(
        [-HX, 0, -HZ], [2 * HX, 0, 0], [0, 0, 2 * HZ], nu, nv, 0.05, rng))
    skip = np.zeros((nu, nv), bool)
    iu = (np.arange(nu)[:, None] * 3) // max(nu, 1)
    iv = (np.arange(nv)[None, :] * 8) // max(nv, 1)
    fu = (np.arange(nu)[:, None] * 3) / max(nu, 1) - iu
    fv = (np.arange(nv)[None, :] * 8) / max(nv, 1) - iv
    skip[((fu > 0.25) & (fu < 0.75) & (fv > 0.3) & (fv < 0.7))
         & ((iu + iv) % 2 == 0)] = True
    parts.append(_displaced_grid(
        [-HX, HY, -HZ], [2 * HX, 0, 0], [0, 0, 2 * HZ], nu, nv, 0.05,
        rng, skip=skip))
    nu, nv = grid_n(HY, 2 * HZ)
    parts.append(_displaced_grid(
        [-HX, 0, -HZ], [0, HY, 0], [0, 0, 2 * HZ], nu, nv, 0.08, rng))
    parts.append(_displaced_grid(
        [HX, 0, -HZ], [0, HY, 0], [0, 0, 2 * HZ], nu, nv, 0.08, rng))
    nu, nv = grid_n(2 * HX, HY)
    parts.append(_displaced_grid(
        [-HX, 0, -HZ], [2 * HX, 0, 0], [0, HY, 0], nu, nv, 0.08, rng))
    parts.append(_displaced_grid(
        [-HX, 0, HZ], [2 * HX, 0, 0], [0, HY, 0], nu, nv, 0.08, rng))

    col_budget = int(n_tris * 0.24)
    n_cols = 20
    per_col = max(col_budget // n_cols, 8)
    nseg = max(int(np.sqrt(per_col / 2.0 * (HY / (2 * np.pi * 1.2)))), 6)
    nz = max(per_col // (2 * nseg), 2)
    for z in np.linspace(-HZ * 0.8, HZ * 0.8, n_cols // 2):
        for cx in (-HX * 0.6, HX * 0.6):
            parts.append(_fluted_column(cx, z, 0.0, HY, 1.2, nseg, nz, rng))

    used = sum(len(t) for t in parts)
    clutter = max(n_tris - used, 0)
    n_clusters = 120
    per = max(clutter // n_clusters, 1)
    for _ in range(n_clusters):
        c = np.array([rng.uniform(-HX * 0.45, HX * 0.45),
                      rng.uniform(0.3, 3.0),
                      rng.uniform(-HZ * 0.9, HZ * 0.9)])
        local = rng.uniform(-1.0, 1.0, size=(per, 3)) \
            * np.array([1.0, 1.4, 1.0])
        offs = rng.normal(scale=0.12, size=(per, 3, 3))
        parts.append(((c + local)[:, None, :] + offs).astype(np.float32))

    verts = np.concatenate(parts).reshape(-1, 3).astype(np.float32)
    tris = np.arange(len(verts), dtype=np.uint32).reshape(-1, 3)
    return verts, tris
