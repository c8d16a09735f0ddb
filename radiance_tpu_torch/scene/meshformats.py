"""Self-contained STL and PLY mesh importers.

A carried copy of radiance_tpu/scene/meshformats.py (numpy only).

The reference's Scene::Load accepts anything assimp reads
(reference: tools/sceneBuilder.cpp:32-67); this environment has no
assimp, so common interchange formats get small native readers with
the same output contract as scene/objmesh.load_obj:
(vertices [V,3] f32, triangles [T,3] u32, normals [V,3] f32,
uvs [V,3] f32).

- STL: binary and ASCII, auto-detected.  STL carries no UVs and only
  facet normals; vertices are deduplicated on exact position and
  normals rebuilt as smooth area-weighted vertex normals (assimp's
  GenSmoothNormals intent), like the OBJ path does when normals are
  absent.
- PLY: ASCII and binary_little_endian 1.0, the element/property
  subset every exporter emits (vertex: x y z [nx ny nz] [s t | u v],
  face: vertex_indices lists).  Quads and larger polygons are
  fan-triangulated.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from radiance_tpu_torch.scene.objmesh import smooth_normals

Mesh = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _dedup(tri_verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[T*3, 3] raw triangle vertices -> (unique verts, tris u32)."""
    verts, inv = np.unique(tri_verts.round(7), axis=0,
                           return_inverse=True)
    tris = inv.reshape(-1, 3).astype(np.uint32)
    return verts.astype(np.float32), tris


def load_stl(path: str) -> Mesh:
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        # could still be binary with a "solid" header; verify by size
        try:
            return _load_stl_ascii(path)
        except ValueError:
            pass
    return _load_stl_binary(path)


def _load_stl_binary(path: str) -> Mesh:
    with open(path, "rb") as f:
        f.read(80)
        (n,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8)
    if data.size != n * 50:
        raise ValueError(f"truncated binary STL: {path}")
    rec = data.reshape(n, 50)
    f32 = rec[:, :48].copy().view(np.float32).reshape(n, 12)
    tri_verts = f32[:, 3:12].reshape(n * 3, 3)
    verts, tris = _dedup(tri_verts)
    nrm = smooth_normals(verts, tris)
    uvs = np.zeros_like(verts)
    return verts, tris, nrm, uvs


def _load_stl_ascii(path: str) -> Mesh:
    pts = []
    with open(path, errors="ignore") as f:
        for line in f:
            parts = line.split()
            if parts[:1] == ["vertex"]:
                pts.append([float(parts[1]), float(parts[2]),
                            float(parts[3])])
    if not pts or len(pts) % 3:
        raise ValueError(f"not an ASCII STL: {path}")
    verts, tris = _dedup(np.asarray(pts, np.float32))
    nrm = smooth_normals(verts, tris)
    uvs = np.zeros_like(verts)
    return verts, tris, nrm, uvs


_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(b"ply"):
        raise ValueError(f"not a PLY file: {path}")
    end = raw.index(b"end_header")
    end = raw.index(b"\n", end) + 1
    header = raw[:end].decode("ascii", errors="ignore").splitlines()
    body = raw[end:]

    fmt = None
    elements = []          # (name, count, [(type, name) | list-spec])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3],
                                        parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r}: {path}")

    verts = nrm = uv = None
    faces = []
    if fmt == "ascii":
        tokens = body.decode("ascii", errors="ignore").split("\n")
        ti = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                while ti < len(tokens) and not tokens[ti].strip():
                    ti += 1
                rows.append(tokens[ti].split())
                ti += 1
            if name == "vertex":
                cols = [p[1] for p in props if p[0] != "list"]
                arr = np.asarray(
                    [[float(v) for v in r[:len(cols)]] for r in rows],
                    np.float32)
                verts, nrm, uv = _vertex_columns(arr, cols)
            elif name == "face":
                for r in rows:
                    k = int(r[0])
                    faces.append([int(v) for v in r[1:1 + k]])
    else:
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = [p[1] for p in props if p[0] != "list"]
                dt = np.dtype([(p[1], "<" + _PLY_DTYPES[p[0]])
                               for p in props])
                arr_s = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                arr = np.stack([arr_s[c].astype(np.float32)
                                for c in cols], axis=1)
                verts, nrm, uv = _vertex_columns(arr, cols)
            elif name == "face":
                for _ in range(count):
                    (p0,) = props
                    cnt_dt = np.dtype("<" + _PLY_DTYPES[p0[1]])
                    idx_dt = np.dtype("<" + _PLY_DTYPES[p0[2]])
                    k = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                    off += cnt_dt.itemsize
                    idx = np.frombuffer(body, idx_dt, k, off)
                    off += idx_dt.itemsize * k
                    faces.append([int(v) for v in idx])
            else:
                # skip unknown fixed-size elements
                dt = np.dtype([(p[1], "<" + _PLY_DTYPES[p[0]])
                               for p in props if p[0] != "list"])
                off += dt.itemsize * count

    if verts is None:
        raise ValueError(f"PLY without vertex element: {path}")
    tris = []
    for fc in faces:
        for i in range(1, len(fc) - 1):
            tris.append((fc[0], fc[i], fc[i + 1]))
    tris = np.asarray(tris, np.uint32).reshape(-1, 3)
    if nrm is None:
        nrm = smooth_normals(verts, tris)
    if uv is None:
        uv = np.zeros_like(verts)
    return verts, tris, nrm, uv


def _vertex_columns(arr: np.ndarray, cols):
    ix = {c: i for i, c in enumerate(cols)}
    verts = np.stack([arr[:, ix["x"]], arr[:, ix["y"]],
                      arr[:, ix["z"]]], axis=1).astype(np.float32)
    nrm = None
    if all(c in ix for c in ("nx", "ny", "nz")):
        nrm = np.stack([arr[:, ix["nx"]], arr[:, ix["ny"]],
                        arr[:, ix["nz"]]], axis=1).astype(np.float32)
    uv = None
    for a, b in (("s", "t"), ("u", "v")):
        if a in ix and b in ix:
            uv = np.stack([arr[:, ix[a]], arr[:, ix[b]],
                           np.zeros(len(arr), np.float32)],
                          axis=1).astype(np.float32)
            break
    return verts, nrm, uv


def corners_to_mesh(pos: np.ndarray, nrm: np.ndarray, uv: np.ndarray,
                    have_nrm: bool) -> Mesh:
    """Per-triangle-corner streams [C,3]/[C,3]/[C,2] -> indexed Mesh.

    Joins corners identical on (position, normal, uv), keeps first-
    occurrence order, and rebuilds smooth normals when the source had
    none (or produced non-finite / zero ones)."""
    pos = np.asarray(pos, np.float32)
    nrm = np.asarray(nrm, np.float32)
    uv = np.asarray(uv, np.float32)
    key = np.concatenate([pos.round(6), nrm.round(4), uv.round(6)],
                         axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    order = np.zeros(len(uniq), np.int64)
    order[inv[::-1]] = np.arange(len(pos))[::-1]    # first occurrence
    verts = pos[order]
    normals = nrm[order]
    uvs2 = uv[order]
    tris = inv.reshape(-1, 3).astype(np.uint32)

    if not have_nrm or not np.isfinite(normals).all() \
            or (np.abs(normals).sum(axis=1) == 0).any():
        normals = smooth_normals(verts, tris)
    uvs = np.concatenate(
        [uvs2, np.zeros((len(uvs2), 1), np.float32)], axis=1)
    return (verts.astype(np.float32), tris,
            normals.astype(np.float32), uvs.astype(np.float32))


def load_mesh(path: str) -> Mesh:
    """Extension-dispatched mesh import (obj/stl/ply/dae/fbx)."""
    low = path.lower()
    if low.endswith(".obj"):
        from radiance_tpu_torch.scene.objmesh import load_obj
        return load_obj(path)
    if low.endswith(".stl"):
        return load_stl(path)
    if low.endswith(".ply"):
        return load_ply(path)
    if low.endswith(".dae"):
        from radiance_tpu_torch.scene.collada import load_dae
        return load_dae(path)
    if low.endswith(".fbx"):
        from radiance_tpu_torch.scene.fbx import load_fbx
        return load_fbx(path)
    raise ValueError(f"unsupported mesh format: {path}")
