"""Self-contained FBX 7.x importer (binary and ASCII).

A carried copy of radiance_tpu/scene/fbx.py (numpy only).

The reference's Scene::Load accepts FBX via assimp
(reference: tools/sceneBuilder.cpp:32-67); this environment has no
assimp, so FBX gets a native reader with the same output contract as
scene/objmesh.load_obj: (vertices [V,3] f32, triangles [T,3] u32,
normals [V,3] f32, uvs [V,3] f32).

Scope (the subset every mainstream exporter emits):
- Binary FBX ("Kaydara FBX Binary"), versions 7.0-7.7, including
  zlib-deflated array properties and the 7500+ 64-bit node headers.
- ASCII FBX 7.x (the `Name: props { ... }` / `a: 1,2,...` layout).
- Geometry: Vertices + PolygonVertexIndex (negative-terminated
  polygons, fan-triangulated), LayerElementNormal / LayerElementUV
  with ByPolygonVertex / ByVertice / ByPolygon / AllSame mapping and
  Direct / IndexToDirect referencing.
- Transforms: the Model hierarchy via OO Connections, composing
  Lcl Translation * PreRotation * Lcl Rotation * Lcl Scaling per
  node (Euler XYZ, degrees). Pivots/offsets and unit-scale
  conversion are ignored (identity for every common exporter).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

Mesh = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

_MAGIC = b"Kaydara FBX Binary  \x00"


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props=None, children=None):
        self.name = name
        self.props = props if props is not None else []
        self.children = children if children is not None else []

    def child(self, name) -> Optional["_Node"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def all(self, name) -> List["_Node"]:
        return [c for c in self.children if c.name == name]


# ---------------------------------------------------------------- binary

_SCALARS = {"Y": "<h", "C": "<b", "I": "<i", "F": "<f", "D": "<d",
            "L": "<q"}
_ARRAYS = {"f": "<f4", "d": "<f8", "l": "<i8", "i": "<i4", "b": "<u1"}


def _read_props(raw: bytes, pos: int, count: int):
    props = []
    for _ in range(count):
        t = chr(raw[pos])
        pos += 1
        if t in _SCALARS:
            fmt = _SCALARS[t]
            props.append(struct.unpack_from(fmt, raw, pos)[0])
            pos += struct.calcsize(fmt)
        elif t in _ARRAYS:
            n, enc, clen = struct.unpack_from("<III", raw, pos)
            pos += 12
            data = raw[pos:pos + clen]
            pos += clen
            if enc:
                data = zlib.decompress(data)
            props.append(np.frombuffer(data, _ARRAYS[t], n))
        elif t == "S":
            (n,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            props.append(raw[pos:pos + n].decode("utf-8", "ignore"))
            pos += n
        elif t == "R":
            (n,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            props.append(raw[pos:pos + n])
            pos += n
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
    return props, pos


def _read_node(raw: bytes, pos: int, big: bool):
    """One node record; returns (node | None-for-sentinel, next pos)."""
    if big:
        end, nprops, _plen = struct.unpack_from("<QQQ", raw, pos)
        pos += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", raw, pos)
        pos += 12
    nlen = raw[pos]
    pos += 1
    if end == 0 and nprops == 0 and nlen == 0:
        return None, pos
    name = raw[pos:pos + nlen].decode("ascii", "ignore")
    pos += nlen
    props, pos = _read_props(raw, pos, nprops)
    children = []
    while pos < end:
        node, pos = _read_node(raw, pos, big)
        if node is None:
            break
        children.append(node)
    return _Node(name, props, children), end


def _parse_binary(raw: bytes) -> _Node:
    (ver,) = struct.unpack_from("<I", raw, len(_MAGIC) + 2)
    big = ver >= 7500
    pos = len(_MAGIC) + 2 + 4
    root = _Node("")
    while pos + (25 if big else 13) <= len(raw):
        node, pos = _read_node(raw, pos, big)
        if node is None:
            break
        root.children.append(node)
    return root


# ---------------------------------------------------------------- ascii

def _tokenize_ascii(text: str):
    toks = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == ";":                       # comment to end of line
            while i < n and text[i] != "\n":
                i += 1
        elif c == '"':
            j = text.index('"', i + 1)
            toks.append(("str", text[i + 1:j]))
            i = j + 1
        elif c in "{}":
            toks.append((c, c))
            i += 1
        elif c in ", \t\r\n":
            i += 1
        else:
            j = i
            while j < n and text[j] not in ',{}" \t\r\n;':
                j += 1
            word = text[i:j]
            i = j
            if word.endswith(":"):
                toks.append(("name", word[:-1]))
            elif word.startswith("*"):
                pass                        # array length hint, ignored
            else:
                try:
                    toks.append(("num", int(word)))
                except ValueError:
                    try:
                        toks.append(("num", float(word)))
                    except ValueError:
                        toks.append(("str", word))
    return toks


def _parse_ascii_nodes(toks, i, out):
    n = len(toks)
    while i < n:
        kind, val = toks[i]
        if kind == "}":
            return i + 1
        if kind != "name":
            i += 1                          # stray token; skip
            continue
        node = _Node(val)
        i += 1
        while i < n and toks[i][0] in ("num", "str"):
            node.props.append(toks[i][1])
            i += 1
        if i < n and toks[i][0] == "{":
            i = _parse_ascii_nodes(toks, i + 1, node.children)
        # fold the `a:` numeric payload of array nodes into a prop
        if len(node.children) == 1 and node.children[0].name == "a":
            node.props = [np.asarray(node.children[0].props)]
            node.children = []
        out.append(node)
    return i


def _parse_ascii(text: str) -> _Node:
    root = _Node("")
    _parse_ascii_nodes(_tokenize_ascii(text), 0, root.children)
    return root


# ------------------------------------------------------------- geometry

def _arr(node: Optional[_Node]) -> Optional[np.ndarray]:
    if node is None:
        return None
    for p in node.props:
        if isinstance(p, np.ndarray):
            return p
    return None


def _sprop(node: _Node, idx: int) -> str:
    p = node.props[idx] if idx < len(node.props) else ""
    return p if isinstance(p, str) else ""


def _layer_per_corner(geom: _Node, layer_name: str, data_name: str,
                      idx_name: str, pvi_vertex: np.ndarray,
                      pvi_poly: np.ndarray, width: int
                      ) -> Optional[np.ndarray]:
    """Resolve one LayerElement* to a per-PVI-corner [C, width] array."""
    layer = geom.child(layer_name)
    if layer is None:
        return None
    data = _arr(layer.child(data_name))
    if data is None:
        return None
    data = np.asarray(data, np.float64).reshape(-1, width)
    mit = ""
    rit = "Direct"
    m = layer.child("MappingInformationType")
    r = layer.child("ReferenceInformationType")
    if m is not None:
        mit = _sprop(m, 0)
    if r is not None:
        rit = _sprop(r, 0)

    ncorners = len(pvi_vertex)
    if mit == "ByPolygonVertex":
        base = np.arange(ncorners)
    elif mit in ("ByVertice", "ByVertex"):
        base = pvi_vertex
    elif mit == "ByPolygon":
        base = pvi_poly
    elif mit == "AllSame":
        base = np.zeros(ncorners, np.int64)
    else:
        return None
    if rit == "IndexToDirect":
        idx = _arr(layer.child(idx_name))
        if idx is not None:
            base = np.asarray(idx, np.int64)[base]
    base = np.clip(base, 0, len(data) - 1)
    return data[base]


def _decode_geometry(geom: _Node):
    """-> (corner positions [C,3], per-corner normals/uv or None,
    corner->triangle fan index list) in object space."""
    verts = _arr(geom.child("Vertices"))
    pvi = _arr(geom.child("PolygonVertexIndex"))
    if verts is None or pvi is None:
        return None
    verts = np.asarray(verts, np.float64).reshape(-1, 3)
    pvi = np.asarray(pvi, np.int64)

    # split negative-terminated polygons; per-corner polygon ids
    vertex_ix = np.where(pvi < 0, -pvi - 1, pvi)
    poly_id = np.cumsum(np.concatenate([[0], (pvi < 0)[:-1]]))

    nrm = _layer_per_corner(geom, "LayerElementNormal", "Normals",
                            "NormalsIndex", vertex_ix, poly_id, 3)
    uv = _layer_per_corner(geom, "LayerElementUV", "UV", "UVIndex",
                           vertex_ix, poly_id, 2)

    # fan-triangulate each polygon in PVI corner order
    ends = np.where(pvi < 0)[0]
    tri_corners = []
    start = 0
    for e in ends:
        for k in range(start + 1, e):
            tri_corners.extend((start, k, k + 1))
        start = e + 1
    tri_corners = np.asarray(tri_corners, np.int64)

    pos = verts[vertex_ix[tri_corners]]
    nrm = None if nrm is None else nrm[tri_corners]
    uv = None if uv is None else uv[tri_corners]
    return pos, nrm, uv


# ------------------------------------------------------------ transforms

def _euler_xyz_deg(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx = np.cos(np.radians(rx)), np.sin(np.radians(rx))
    cy, sy = np.cos(np.radians(ry)), np.sin(np.radians(ry))
    cz, sz = np.cos(np.radians(rz)), np.sin(np.radians(rz))
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx                     # X applied first


def _p70(model: _Node, name: str) -> Optional[np.ndarray]:
    props = model.child("Properties70")
    if props is None:
        return None
    for p in props.all("P"):
        if p.props and p.props[0] == name:
            vals = [v for v in p.props if isinstance(v, (int, float))]
            if len(vals) >= 3:
                return np.asarray(vals[-3:], np.float64)
    return None


def _model_local(model: _Node) -> np.ndarray:
    m = np.eye(4)
    s = _p70(model, "Lcl Scaling")
    r = _p70(model, "Lcl Rotation")
    rpre = _p70(model, "PreRotation")
    t = _p70(model, "Lcl Translation")
    rot = np.eye(3)
    if rpre is not None:
        rot = rot @ _euler_xyz_deg(*rpre)
    if r is not None:
        rot = rot @ _euler_xyz_deg(*r)
    if s is not None:
        rot = rot @ np.diag(s)
    m[:3, :3] = rot
    if t is not None:
        m[:3, 3] = t
    return m


# ----------------------------------------------------------------- load

def load_fbx(path: str) -> Mesh:
    """Merged, world-transformed triangle mesh from a .fbx file."""
    from radiance_tpu_torch.scene.meshformats import corners_to_mesh

    with open(path, "rb") as f:
        raw = f.read()
    if raw.startswith(_MAGIC):
        root = _parse_binary(raw)
    else:
        root = _parse_ascii(raw.decode("utf-8", "ignore"))

    objects = root.child("Objects")
    if objects is None:
        raise ValueError(f"no Objects section in FBX: {path}")

    geoms: Dict[int, _Node] = {}
    models: Dict[int, _Node] = {}
    for g in objects.all("Geometry"):
        if len(g.props) >= 3 and _sprop(g, 2) not in ("Mesh", ""):
            continue
        geoms[int(g.props[0])] = g
    for mnode in objects.all("Model"):
        models[int(mnode.props[0])] = mnode

    parent: Dict[int, int] = {}             # model id -> parent model id
    geo_of: Dict[int, List[int]] = {}        # model id -> geometry ids
    conns = root.child("Connections")
    if conns is not None:
        for c in conns.all("C"):
            if len(c.props) < 3 or c.props[0] != "OO":
                continue
            src, dst = int(c.props[1]), int(c.props[2])
            if src in geoms and dst in models:
                geo_of.setdefault(dst, []).append(src)
            elif src in models and dst in models:
                parent[src] = dst

    def world(mid: int, depth=0) -> np.ndarray:
        local = _model_local(models[mid])
        pid = parent.get(mid, 0)
        if pid in models and depth < 64:
            return world(pid, depth + 1) @ local
        return local

    # geometries with no model connection render with identity
    placed = {g for gids in geo_of.values() for g in gids}
    instances: List[Tuple[int, np.ndarray]] = []
    for mid, gids in geo_of.items():
        w = world(mid)
        instances.extend((g, w) for g in gids)
    instances.extend((g, np.eye(4)) for g in geoms if g not in placed)

    pos_all, nrm_all, uv_all = [], [], []
    have_nrm = True
    for gid, w in instances:
        decoded = _decode_geometry(geoms[gid])
        if decoded is None:
            continue
        pos, nrm, uv = decoded
        rot = w[:3, :3]
        pos_all.append(pos @ rot.T + w[:3, 3])
        if nrm is None:
            have_nrm = False
            nrm_all.append(np.zeros_like(pos))
        else:
            nit = np.linalg.inv(rot).T
            nw = nrm @ nit.T
            ln = np.maximum(np.linalg.norm(nw, axis=1, keepdims=True),
                            1e-20)
            nrm_all.append(nw / ln)
        uv_all.append(np.zeros((len(pos), 2)) if uv is None else uv)

    if not pos_all:
        raise ValueError(f"no triangle geometry in FBX: {path}")
    return corners_to_mesh(
        np.concatenate(pos_all), np.concatenate(nrm_all),
        np.concatenate(uv_all), have_nrm)
