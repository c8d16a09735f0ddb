"""Minimal GLB writer: build .glb files from mesh/material/texture data.

A carried copy of radiance_tpu/scene/glb_writer.py (numpy only).

Used for test fixtures and for exporting procedural scenes; the reference
has no equivalent (its assets were authored in Blender and are not checked
into its repo).
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np


def write_glb(path: Optional[str],
              meshes: Sequence[dict],
              materials: Sequence[dict] = (),
              images: Sequence[bytes] = (),
              nodes: Optional[Sequence[dict]] = None) -> bytes:
    """meshes: [{positions [V,3], normals [V,3]?, uvs [V,2]?,
                 indices [T,3], material int?}]
    materials: [{baseColorFactor, metallicFactor, roughnessFactor,
                 baseColorTexture (image idx)?, transmission?, ior?}]
    images: encoded PNG bytes (become textures 1:1)
    nodes: [{mesh int, translation/rotation/scale/matrix?, children?}];
           default: one root node per mesh.
    Returns the GLB bytes (also written to `path` when given).
    """
    bin_parts: List[bytes] = []
    buffer_views = []
    accessors = []

    def add_data(arr: np.ndarray, target: Optional[int]) -> int:
        data = np.ascontiguousarray(arr).tobytes()
        offset = sum(len(p) for p in bin_parts)
        pad = (-offset) % 4
        if pad:
            bin_parts.append(b"\x00" * pad)
            offset += pad
        bin_parts.append(data)
        bv = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target:
            bv["target"] = target
        buffer_views.append(bv)
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, ctype: int, atype: str,
                     target: Optional[int]) -> int:
        bv = add_data(arr, target)
        acc = {"bufferView": bv, "componentType": ctype,
               "count": len(arr), "type": atype}
        if atype == "VEC3":
            acc["min"] = np.asarray(arr).min(axis=0).tolist()
            acc["max"] = np.asarray(arr).max(axis=0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    gltf_meshes = []
    for m in meshes:
        attrs = {"POSITION": add_accessor(
            np.asarray(m["positions"], np.float32), 5126, "VEC3", 34962)}
        if m.get("normals") is not None:
            attrs["NORMAL"] = add_accessor(
                np.asarray(m["normals"], np.float32), 5126, "VEC3", 34962)
        if m.get("uvs") is not None:
            attrs["TEXCOORD_0"] = add_accessor(
                np.asarray(m["uvs"], np.float32), 5126, "VEC2", 34962)
        idx = np.asarray(m["indices"], np.uint32).reshape(-1, 1)
        idx_acc = add_accessor(idx, 5125, "SCALAR", 34963)
        prim = {"attributes": attrs, "indices": idx_acc}
        if m.get("material") is not None:
            prim["material"] = m["material"]
        gltf_meshes.append({"primitives": [prim]})

    gltf_images = []
    gltf_textures = []
    for img_bytes in images:
        bv = add_data(np.frombuffer(img_bytes, np.uint8), None)
        gltf_images.append({"bufferView": bv, "mimeType": "image/png"})
        gltf_textures.append({"source": len(gltf_images) - 1})

    gltf_materials = []
    for m in materials:
        pbr = {
            "baseColorFactor": list(m.get("baseColorFactor", (1, 1, 1, 1))),
            "metallicFactor": m.get("metallicFactor", 0.0),
            "roughnessFactor": m.get("roughnessFactor", 1.0),
        }
        if m.get("baseColorTexture") is not None:
            pbr["baseColorTexture"] = {"index": m["baseColorTexture"]}
        mat = {"pbrMetallicRoughness": pbr}
        ext = {}
        if m.get("transmission"):
            ext["KHR_materials_transmission"] = {
                "transmissionFactor": m["transmission"]}
        if m.get("ior"):
            ext["KHR_materials_ior"] = {"ior": m["ior"]}
        if ext:
            mat["extensions"] = ext
        gltf_materials.append(mat)

    if nodes is None:
        nodes = [{"mesh": i} for i in range(len(gltf_meshes))]
    roots = [i for i in range(len(nodes))
             if not any(i in n.get("children", []) for n in nodes)]

    gltf = {
        "asset": {"version": "2.0", "generator": "radiance_tpu"},
        "scene": 0,
        "scenes": [{"nodes": roots}],
        "nodes": list(nodes),
        "meshes": gltf_meshes,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": sum(len(p) for p in bin_parts)}],
    }
    if gltf_materials:
        gltf["materials"] = gltf_materials
    if gltf_images:
        gltf["images"] = gltf_images
        gltf["textures"] = gltf_textures

    json_bytes = json.dumps(gltf).encode()
    json_bytes += b" " * ((-len(json_bytes)) % 4)
    bin_blob = b"".join(bin_parts)
    bin_blob += b"\x00" * ((-len(bin_blob)) % 4)

    total = 12 + 8 + len(json_bytes) + 8 + len(bin_blob)
    out = (struct.pack("<4sII", b"glTF", 2, total)
           + struct.pack("<I4s", len(json_bytes), b"JSON") + json_bytes
           + struct.pack("<I4s", len(bin_blob), b"BIN\x00") + bin_blob)
    if path:
        with open(path, "wb") as f:
            f.write(out)
    return out
