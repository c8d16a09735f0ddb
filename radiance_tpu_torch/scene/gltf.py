"""Minimal glTF 2.0 / GLB parser (no external deps).

A carried copy of radiance_tpu/scene/gltf.py (numpy only).

Covers what the reference obtains through assimp for its scene pipeline
(reference: tools/sceneBuilder.cpp:27-195): triangulated primitives with
POSITION/NORMAL/TEXCOORD_0, indices, PBR metallicRoughness materials
(+ KHR_materials_transmission / KHR_materials_ior), normal textures,
embedded images, and the node hierarchy with accumulated transforms.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


@dataclasses.dataclass
class Primitive:
    positions: np.ndarray          # [V, 3] f32
    normals: Optional[np.ndarray]  # [V, 3] f32
    uvs: Optional[np.ndarray]      # [V, 2] f32
    indices: np.ndarray            # [T, 3] u32
    material: int                  # material index or -1


@dataclasses.dataclass
class GLTFMaterial:
    name: str = ""
    base_color: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    base_color_tex: int = -1       # image index
    metallic: float = 1.0
    roughness: float = 1.0
    metallic_roughness_tex: int = -1
    normal_tex: int = -1
    transmission: float = 0.0
    ior: float = 1.45


@dataclasses.dataclass
class GLTFScene:
    meshes: List[List[Primitive]]          # per glTF mesh: its primitives
    materials: List[GLTFMaterial]
    images: List[bytes]                    # raw encoded image bytes
    nodes: List[dict]
    roots: List[int]

    def instances(self) -> List[Tuple[int, np.ndarray]]:
        """Flatten the node tree: [(mesh_index, world_transform 4x4 row-major)]
        in traversal order (reference: Scene::BuildInstance recursion,
        sceneBuilder.cpp:287-315)."""
        out = []

        def walk(node_idx: int, parent: np.ndarray):
            node = self.nodes[node_idx]
            tf = parent @ _node_transform(node)
            if "mesh" in node:
                out.append((node["mesh"], tf))
            for c in node.get("children", []):
                walk(c, tf)

        for r in self.roots:
            walk(r, np.eye(4, dtype=np.float32))
        return out


def _node_transform(node: dict) -> np.ndarray:
    """Row-major 4x4 from a glTF node (matrix is column-major in the file)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]).astype(np.float32) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1]], np.float32)
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _read_accessor(gltf: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    count = acc["count"]
    if "bufferView" not in acc:
        return np.zeros((count, n_comp), dtype)
    bv = gltf["bufferViews"][acc["bufferView"]]
    data = buffers[bv.get("buffer", 0)]
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride") or dtype.itemsize * n_comp
    if stride == dtype.itemsize * n_comp:
        arr = np.frombuffer(data, dtype, count=count * n_comp, offset=start)
        return arr.reshape(count, n_comp)
    rows = np.frombuffer(data, np.uint8,
                         count=stride * (count - 1) + dtype.itemsize * n_comp,
                         offset=start)
    strided = np.lib.stride_tricks.as_strided(
        rows, shape=(count, dtype.itemsize * n_comp), strides=(stride, 1))
    return strided.copy().view(dtype).reshape(count, n_comp)


def _read_external(base_dir, uri: str) -> bytes:
    """Resolve a glTF relative-URI resource next to the .gltf file."""
    from urllib.parse import unquote
    if base_dir is None:
        raise ValueError(
            f"external resource {uri!r} needs a file path, not bytes")
    path = os.path.normpath(os.path.join(base_dir, unquote(uri)))
    if not os.path.exists(path):
        raise FileNotFoundError(f"glTF external resource: {path}")
    with open(path, "rb") as f:
        return f.read()


def parse_glb(path_or_bytes) -> GLTFScene:
    """Parse a .glb container (or .gltf JSON with embedded base64 buffers)."""
    base_dir = None
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        base_dir = os.path.dirname(os.path.abspath(path_or_bytes))
        with open(path_or_bytes, "rb") as f:
            blob = f.read()

    if blob[:4] == b"glTF":
        magic, version, length = struct.unpack_from("<4sII", blob, 0)
        off = 12
        gltf_json = None
        bin_chunk = b""
        while off < length:
            chunk_len, chunk_type = struct.unpack_from("<I4s", blob, off)
            data = blob[off + 8:off + 8 + chunk_len]
            if chunk_type == b"JSON":
                gltf_json = json.loads(data)
            elif chunk_type == b"BIN\x00":
                bin_chunk = data
            off += 8 + chunk_len
        gltf = gltf_json
        buffers = [bin_chunk]
    else:
        gltf = json.loads(blob)
        buffers = []
        import base64
        for buf in gltf.get("buffers", []):
            uri = buf.get("uri", "")
            if uri.startswith("data:"):
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                # relative-URI file next to the .gltf (the common
                # on-disk layout; reference: assimp resolves the same
                # way, sceneBuilder.cpp:32-67)
                buffers.append(_read_external(base_dir, uri))

    # images
    images = []
    for img in gltf.get("images", []):
        if "bufferView" in img:
            bv = gltf["bufferViews"][img["bufferView"]]
            start = bv.get("byteOffset", 0)
            images.append(buffers[bv.get("buffer", 0)][start:start + bv["byteLength"]])
        else:
            import base64
            uri = img.get("uri", "")
            if uri.startswith("data:"):
                images.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                images.append(_read_external(base_dir, uri))

    # materials (reference: sceneBuilder.cpp:103-195 key mapping)
    def tex_image(tex_info) -> int:
        if tex_info is None:
            return -1
        tex = gltf["textures"][tex_info["index"]]
        return tex.get("source", -1)

    materials = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        ext = m.get("extensions", {})
        transmission = ext.get("KHR_materials_transmission", {}).get(
            "transmissionFactor", 0.0)
        ior = ext.get("KHR_materials_ior", {}).get("ior", 1.45)
        materials.append(GLTFMaterial(
            name=m.get("name", ""),
            base_color=tuple(pbr.get("baseColorFactor", (1, 1, 1, 1))),
            base_color_tex=tex_image(pbr.get("baseColorTexture")),
            metallic=pbr.get("metallicFactor", 1.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            metallic_roughness_tex=tex_image(pbr.get("metallicRoughnessTexture")),
            normal_tex=tex_image(m.get("normalTexture")),
            transmission=transmission,
            ior=ior))

    # meshes
    meshes = []
    for mesh in gltf.get("meshes", []):
        prims = []
        for p in mesh.get("primitives", []):
            if p.get("mode", 4) != 4:  # triangles only (aiProcess_SortByPType)
                continue
            attrs = p["attributes"]
            pos = _read_accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
            nrm = (_read_accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else None)
            uv = (_read_accessor(gltf, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else None)
            if "indices" in p:
                idx = _read_accessor(gltf, buffers, p["indices"]).reshape(-1)
            else:
                idx = np.arange(len(pos), dtype=np.uint32)
            prims.append(Primitive(
                positions=pos[:, :3],
                normals=None if nrm is None else nrm[:, :3],
                uvs=None if uv is None else uv[:, :2],
                indices=idx.astype(np.uint32).reshape(-1, 3),
                material=p.get("material", -1)))
        meshes.append(prims)

    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [{}])
    roots = scenes[scene_idx].get("nodes", [])
    return GLTFScene(meshes=meshes, materials=materials, images=images,
                     nodes=gltf.get("nodes", []), roots=roots)
