"""The 64-instance TLAS scene: a frozen copy of bench.py's
_build_multi_tlas geometry (bench.py:705-737, rng 11).

Eight unique meshes, each 40 clusters of small random triangles as the
city's (centres uniform in [-6, 6]^3, each vertex offset by N(0, 0.08)),
drawn first, all eight in order; then 64 translations uniform in
[-44, 44]^3, one per instance, the eight copies of mesh 0 first.  At
1,000,000 triangles a mesh holds 40 x 390 = 15,600 of them, and the
scene 998,400 in world space.
"""

import numpy as np


def scene(n_tris: int, seed: int = 11, n_unique: int = 8,
          n_copies: int = 8, n_clusters: int = 40, spread: float = 6.0,
          offset: float = 44.0):
    """(meshes, translations, mesh_of): n_unique vertex arrays [3T, 3]
    f32 (triangle k is rows 3k..3k+2), the instances' translations
    [n_unique * n_copies, 3] f32 and each instance's mesh [I] i64, in
    instance order."""
    rng = np.random.default_rng(seed)
    per = n_tris // (n_unique * n_copies) // n_clusters
    meshes = []
    for _ in range(n_unique):
        centers = rng.uniform(-spread, spread,
                              size=(n_clusters, 3)).astype(np.float32)
        verts_all = []
        for c in centers:
            local = rng.uniform(-1.5, 1.5, size=(per, 3)).astype(np.float32)
            offs = rng.normal(scale=0.08, size=(per, 3, 3)).astype(np.float32)
            verts_all.append((c + local)[:, None, :] + offs)
        meshes.append(np.concatenate(verts_all).reshape(-1, 3))
    translations = np.stack([
        rng.uniform(-offset, offset, 3).astype(np.float32)
        for _ in range(n_unique * n_copies)])
    mesh_of = np.repeat(np.arange(n_unique), n_copies)
    return meshes, translations, mesh_of


def flat_normals(verts):
    """[T, 3] f32 unit normals of the triangles of a vertex array [3T, 3],
    as bench._engine_setup makes them."""
    v = verts.reshape(-1, 3, 3)
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-9)
    return fn.astype(np.float32)


def world(meshes, translations, mesh_of):
    """(verts [3T, 3] f32, tris [T, 3] u32, normals [T, 3] f32): every
    instance's mesh moved by its translation in float32, in instance
    order, with its flat normals (a translation leaves them): the scene
    as one world-space mesh, with no TLAS."""
    verts = np.concatenate([meshes[m] + translations[i]
                            for i, m in enumerate(mesh_of)])
    fn = [flat_normals(m) for m in meshes]
    return (verts, np.arange(len(verts), dtype=np.uint32).reshape(-1, 3),
            np.concatenate([fn[m] for m in mesh_of]))


def generate(n_tris: int, seed: int = 11, **kw):
    """(verts [3T, 3] f32, tris [T, 3] u32): world()'s mesh of the
    scene."""
    return world(*scene(n_tris, seed, **kw))[:2]
