"""The open "city" of triangle clusters: a frozen copy of bench.py's
scene_geometry("city") (bench.py:128-150).

Spatially coherent clusters of small random triangles, unlike a pure
random soup, so traversal behaves like a real scene; an open scene whose
primary rays mostly miss (hit rate about 0.18 from the bench camera).
"""

import numpy as np


def generate(n_tris: int, seed: int = 7, n_clusters: int = 1000,
             spread: float = 50.0):
    """(verts [3T, 3] f32, tris [T, 3] u32): n_clusters clusters of
    n_tris // n_clusters triangles, centred uniformly in [-spread,
    spread]^3, each vertex offset by N(0, 0.08)."""
    rng = np.random.default_rng(seed)
    per = n_tris // n_clusters
    centers = rng.uniform(-spread, spread,
                          size=(n_clusters, 3)).astype(np.float32)
    verts_all = []
    for c in centers:
        local = rng.uniform(-1.5, 1.5, size=(per, 3)).astype(np.float32)
        offs = rng.normal(scale=0.08, size=(per, 3, 3)).astype(np.float32)
        verts_all.append((c + local)[:, None, :] + offs)
    verts = np.concatenate(verts_all).reshape(-1, 3)
    tris = np.arange(len(verts), dtype=np.uint32).reshape(-1, 3)
    return verts, tris
