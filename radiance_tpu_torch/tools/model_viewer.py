"""Asset inspector: print a GLB/OBJ scene's structure.

Equivalent of the reference's modelViewer (reference:
tools/modelViewer.cpp): dumps meshes, materials, textures, and the node
tree with accumulated transforms.

Port of radiance_tpu/tools/model_viewer.py on the port's carried
importers (scene/gltf.py, scene/meshformats.py); its output is the JAX
tool's, line for line.

Usage: python -m radiance_tpu_torch.tools.model_viewer <asset.glb|obj|stl|ply|dae|fbx>
"""

from __future__ import annotations

import argparse

import numpy as np


def print_glb(path: str) -> None:
    from radiance_tpu_torch.scene import gltf

    scene = gltf.parse_glb(path)
    print(f"Scene: {path}")
    print(f"  meshes: {len(scene.meshes)}")
    for i, prims in enumerate(scene.meshes):
        for j, p in enumerate(prims):
            print(f"    mesh {i} primitive {j}: "
                  f"{len(p.positions)} vertices, {len(p.indices)} triangles, "
                  f"material {p.material}, "
                  f"normals={'yes' if p.normals is not None else 'no'}, "
                  f"uvs={'yes' if p.uvs is not None else 'no'}")
    print(f"  materials: {len(scene.materials)}")
    for i, m in enumerate(scene.materials):
        print(f"    material {i} {m.name!r}: baseColor={m.base_color} "
              f"metallic={m.metallic} roughness={m.roughness} "
              f"transmission={m.transmission} ior={m.ior} "
              f"texIdx(albedo/mr/normal)=({m.base_color_tex}, "
              f"{m.metallic_roughness_tex}, {m.normal_tex})")
    print(f"  textures: {len(scene.images)}")
    for i, img in enumerate(scene.images):
        kind = "png" if img[:4] == b"\x89PNG" else (
            "jpg" if img[:2] == b"\xff\xd8" else "?")
        print(f"    texture {i}: {len(img)} bytes ({kind})")

    print("  node tree (accumulated transforms):")

    def walk(idx: int, parent, depth: int):
        node = scene.nodes[idx]
        from radiance_tpu_torch.scene.gltf import _node_transform
        tf = parent @ _node_transform(node)
        mesh = f" mesh={node['mesh']}" if "mesh" in node else ""
        t = tf[:3, 3]
        print(f"    {'  ' * depth}node {idx}{mesh} "
              f"T=({t[0]:.2f}, {t[1]:.2f}, {t[2]:.2f})")
        for c in node.get("children", []):
            walk(c, tf, depth + 1)

    for r in scene.roots:
        walk(r, np.eye(4, dtype=np.float32), 0)


def print_mesh(path: str) -> None:
    from radiance_tpu_torch.scene import meshformats

    verts, tris, normals, uvs = meshformats.load_mesh(path)
    print(f"Mesh: {path}")
    print(f"  {len(verts)} vertices, {len(tris)} triangles")
    print(f"  bounds: {verts.min(axis=0)} .. {verts.max(axis=0)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("asset")
    args = ap.parse_args()
    if args.asset.lower().endswith((".obj", ".stl", ".ply", ".dae", ".fbx")):
        print_mesh(args.asset)
    else:
        print_glb(args.asset)


if __name__ == "__main__":
    main()
