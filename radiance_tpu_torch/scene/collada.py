"""Self-contained COLLADA (.dae) mesh importer.

A carried copy of radiance_tpu/scene/collada.py (numpy only).

The reference's Scene::Load accepts anything assimp reads (reference:
tools/sceneBuilder.cpp:32-67); COLLADA is the common DCC interchange
format in that set.  This is a dependency-free reader of the subset
every exporter emits, with the same output contract as
scene/objmesh.load_obj: (vertices [V,3] f32, triangles [T,3] u32,
normals [V,3] f32, uvs [V,3] f32).

Covered:
  * library_geometries: <mesh> with <source>/<float_array> +
    accessor stride, <vertices> POSITION mapping, and <triangles> /
    <polylist> primitives (interleaved <p> indices at per-input
    offsets; polylist <vcount> polygons are fan-triangulated).
  * library_visual_scenes: node hierarchies with <matrix>,
    <translate>, <rotate>, <scale>, and <instance_geometry> --
    world transforms are accumulated and baked into the merged mesh
    (assimp's aiProcess_PreTransformVertices intent).  Geometries
    never instanced by the scene are imported untransformed.
  * <asset>: `unit/@meter` scale and `up_axis` (Z_UP / X_UP are
    rotated into the engine's Y-up convention, like assimp).
  * NORMAL / TEXCOORD inputs when present; smooth vertex normals are
    rebuilt when absent.  Vertices are deduplicated on joined
    (position, normal, uv) index tuples (JoinIdenticalVertices).

Namespaces are matched by local name, so 1.4 and 1.5 documents both
parse.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np


Mesh = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _children(el, name):
    return [c for c in el if _local(c.tag) == name]


def _child(el, name):
    cs = _children(el, name)
    return cs[0] if cs else None


def _floats(text: str) -> np.ndarray:
    return np.asarray(text.split(), dtype=np.float64)


def _ints(text: str) -> np.ndarray:
    return np.asarray(text.split(), dtype=np.int64)


def _parse_sources(mesh_el) -> Dict[str, np.ndarray]:
    """source id -> [N, stride] float array (accessor stride)."""
    out = {}
    for src in _children(mesh_el, "source"):
        sid = src.get("id")
        fa = _child(src, "float_array")
        if fa is None or sid is None:
            continue
        vals = _floats(fa.text or "")
        stride = 3
        tc = _child(src, "technique_common")
        if tc is not None:
            acc = _child(tc, "accessor")
            if acc is not None:
                stride = int(acc.get("stride", "3"))
        n = len(vals) // stride
        out[sid] = vals[: n * stride].reshape(n, stride)
    return out


def _node_matrix(node) -> np.ndarray:
    """Accumulate this node's local transform elements in document
    order (COLLADA composes them top to bottom)."""
    m = np.eye(4)
    for el in node:
        name = _local(el.tag)
        if name == "matrix":
            m = m @ _floats(el.text or "").reshape(4, 4)
        elif name == "translate":
            t = np.eye(4)
            t[:3, 3] = _floats(el.text or "")[:3]
            m = m @ t
        elif name == "scale":
            s = np.eye(4)
            s[[0, 1, 2], [0, 1, 2]] = _floats(el.text or "")[:3]
            m = m @ s
        elif name == "rotate":
            x, y, z, deg = _floats(el.text or "")[:4]
            a = math.radians(deg)
            c, s = math.cos(a), math.sin(a)
            axis = np.asarray([x, y, z])
            ln = np.linalg.norm(axis)
            if ln > 0:
                x, y, z = axis / ln
                r = np.eye(4)
                r[:3, :3] = [
                    [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                     x * z * (1 - c) + y * s],
                    [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                     y * z * (1 - c) - x * s],
                    [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                     c + z * z * (1 - c)],
                ]
                m = m @ r
    return m


def _collect_instances(root) -> Dict[str, List[np.ndarray]]:
    """geometry id -> list of world transforms instancing it."""
    out: Dict[str, List[np.ndarray]] = {}

    def walk(node, parent):
        world = parent @ _node_matrix(node)
        for ig in _children(node, "instance_geometry"):
            url = (ig.get("url") or "").lstrip("#")
            out.setdefault(url, []).append(world)
        for sub in _children(node, "node"):
            walk(sub, world)

    lvs = _child(root, "library_visual_scenes")
    if lvs is not None:
        for vs in _children(lvs, "visual_scene"):
            for node in _children(vs, "node"):
                walk(node, np.eye(4))
    return out


def _asset_transform(root) -> np.ndarray:
    """Unit scale + up-axis rotation into the engine's Y-up meters."""
    m = np.eye(4)
    asset = _child(root, "asset")
    if asset is None:
        return m
    unit = _child(asset, "unit")
    if unit is not None:
        m[:3, :3] *= float(unit.get("meter", "1.0"))
    up = _child(asset, "up_axis")
    axis = (up.text or "Y_UP").strip() if up is not None else "Y_UP"
    if axis == "Z_UP":
        # (x, y, z) -> (x, z, -y)
        r = np.zeros((4, 4))
        r[0, 0] = 1.0
        r[1, 2] = 1.0
        r[2, 1] = -1.0
        r[3, 3] = 1.0
        m = r @ m
    elif axis == "X_UP":
        # (x, y, z) -> (-y, x, z)
        r = np.zeros((4, 4))
        r[0, 1] = -1.0
        r[1, 0] = 1.0
        r[2, 2] = 1.0
        r[3, 3] = 1.0
        m = r @ m
    return m


def _prim_corners(mesh_el, prim) -> Optional[Tuple[np.ndarray, ...]]:
    """Decode one <triangles>/<polylist> into per-corner
    (pos [C,3], nrm [C,3] | None, uv [C,2] | None) arrays."""
    sources = _parse_sources(mesh_el)
    verts_el = _child(mesh_el, "vertices")
    pos_of_vertices = None
    if verts_el is not None:
        for inp in _children(verts_el, "input"):
            if inp.get("semantic") == "POSITION":
                pos_of_vertices = (inp.get("source") or "").lstrip("#")

    inputs = []
    max_off = 0
    for inp in _children(prim, "input"):
        off = int(inp.get("offset", "0"))
        max_off = max(max_off, off)
        src = (inp.get("source") or "").lstrip("#")
        sem = inp.get("semantic")
        if sem == "VERTEX":
            src = pos_of_vertices or src
            sem = "POSITION"
        inputs.append((sem, off, src))
    stride = max_off + 1

    p_el = _child(prim, "p")
    if p_el is None:
        return None
    p = _ints(p_el.text or "")
    p = p[: (len(p) // stride) * stride].reshape(-1, stride)

    name = _local(prim.tag)
    if name == "polylist":
        vc_el = _child(prim, "vcount")
        vcount = _ints(vc_el.text or "") if vc_el is not None else None
        if vcount is None:
            return None
        corners = []
        base = 0
        for c in vcount:
            for k in range(1, int(c) - 1):
                corners.extend((base, base + k, base + k + 1))
            base += int(c)
        p = p[np.asarray(corners, dtype=np.int64)]
    # triangles: p rows are already corner-ordered

    pos = nrm = uv = None
    for sem, off, src in inputs:
        arr = sources.get(src)
        if arr is None:
            continue
        idx = p[:, off]
        if sem == "POSITION":
            pos = arr[idx][:, :3]
        elif sem == "NORMAL" and nrm is None:
            nrm = arr[idx][:, :3]
        elif sem == "TEXCOORD" and uv is None:
            uv = arr[idx][:, :2]
    if pos is None:
        return None
    return pos, nrm, uv


def load_dae(path: str) -> Mesh:
    """Merged, world-transformed triangle mesh from a COLLADA file."""
    root = ET.parse(path).getroot()
    asset_m = _asset_transform(root)
    inst_of = _collect_instances(root)

    lg = _child(root, "library_geometries")
    if lg is None:
        raise ValueError(f"no library_geometries in {path}")

    pos_all, nrm_all, uv_all = [], [], []
    have_nrm = True
    for geom in _children(lg, "geometry"):
        gid = geom.get("id") or ""
        mesh_el = _child(geom, "mesh")
        if mesh_el is None:
            continue                    # splines / convex_mesh etc.
        prims = (_children(mesh_el, "triangles")
                 + _children(mesh_el, "polylist"))
        worlds = inst_of.get(gid) or [np.eye(4)]
        for prim in prims:
            decoded = _prim_corners(mesh_el, prim)
            if decoded is None:
                continue
            pos, nrm, uv = decoded
            for w in worlds:
                m = asset_m @ w
                rot = m[:3, :3]
                pw = pos @ rot.T + m[:3, 3]
                pos_all.append(pw)
                if nrm is None:
                    have_nrm = False
                    nrm_all.append(np.zeros_like(pw))
                else:
                    # normals transform by the inverse-transpose
                    nit = np.linalg.inv(rot).T
                    nw = nrm @ nit.T
                    ln = np.maximum(
                        np.linalg.norm(nw, axis=1, keepdims=True),
                        1e-20)
                    nrm_all.append(nw / ln)
                uv_all.append(
                    np.zeros((len(pw), 2)) if uv is None else uv)

    if not pos_all:
        raise ValueError(f"no triangle geometry in {path}")
    from radiance_tpu_torch.scene.meshformats import corners_to_mesh
    return corners_to_mesh(np.concatenate(pos_all),
                           np.concatenate(nrm_all),
                           np.concatenate(uv_all), have_nrm)
