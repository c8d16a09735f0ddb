"""Minimal Wavefront OBJ loader.

A carried copy of radiance_tpu/scene/objmesh.py (numpy only).

Covers what the reference gets from assimp for sample2 (reference:
samples/sample2.cpp:15-69): positions, normals, UVs, triangulated faces
with per-vertex joined attributes.  Faces with quads are fan-triangulated;
`v//vn` and `v/vt/vn` forms are supported.  When normals are missing they
are generated as smooth (area-weighted) vertex normals, matching assimp's
aiProcess_GenSmoothNormals intent.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (vertices [V,3], triangles [T,3] u32, normals [V,3], uvs [V,3]).

    Vertices are deduplicated on (position, uv, normal) index triples, like
    assimp's JoinIdenticalVertices on indexed data.
    """
    positions, normals_in, uvs_in = [], [], []
    combos = {}
    out_pos, out_nrm, out_uv = [], [], []
    faces = []

    def vertex(spec: str) -> int:
        if spec in combos:
            return combos[spec]
        parts = spec.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ni = None
        if len(parts) > 1 and parts[1]:
            t = int(parts[1])
            ti = t - 1 if t > 0 else len(uvs_in) + t
        if len(parts) > 2 and parts[2]:
            nn = int(parts[2])
            ni = nn - 1 if nn > 0 else len(normals_in) + nn
        idx = len(out_pos)
        combos[spec] = idx
        out_pos.append(positions[vi])
        out_uv.append(uvs_in[ti] if ti is not None else (0.0, 0.0, 0.0))
        out_nrm.append(normals_in[ni] if ni is not None else None)
        return idx

    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                positions.append(tuple(float(x) for x in line.split()[1:4]))
            elif line.startswith("vn "):
                normals_in.append(tuple(float(x) for x in line.split()[1:4]))
            elif line.startswith("vt "):
                vals = [float(x) for x in line.split()[1:]]
                uvs_in.append((vals[0], vals[1] if len(vals) > 1 else 0.0, 0.0))
            elif line.startswith("f "):
                specs = line.split()[1:]
                ids = [vertex(s) for s in specs]
                for k in range(1, len(ids) - 1):  # fan triangulation
                    faces.append((ids[0], ids[k], ids[k + 1]))

    verts = np.asarray(out_pos, np.float32).reshape(-1, 3)
    tris = np.asarray(faces, np.uint32).reshape(-1, 3)
    uvs = np.asarray(out_uv, np.float32).reshape(-1, 3)

    if any(n is None for n in out_nrm):
        nrm = smooth_normals(verts, tris)
    else:
        nrm = np.asarray(out_nrm, np.float32).reshape(-1, 3)
    return verts, tris, nrm, uvs


def smooth_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    t = tris.astype(np.int64)
    fn = np.cross(verts[t[:, 1]] - verts[t[:, 0]],
                  verts[t[:, 2]] - verts[t[:, 0]])
    nrm = np.zeros_like(verts)
    for k in range(3):
        np.add.at(nrm, t[:, k], fn)
    lens = np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    return (nrm / lens).astype(np.float32)
