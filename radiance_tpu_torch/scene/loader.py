"""Scene loader: RD::Scene::Load parity for glTF/GLB and raw mesh assets.

Port of radiance_tpu/scene/loader.py; the resources are made on the
device the caller names (the card unless it asks for the CPU).

Reference: tools/sceneBuilder.{h,cpp}.  Loads a GLB, decodes and resizes
every embedded texture into one image array (sceneBuilder.cpp:42-67),
concatenates mesh attributes with per-mesh element offsets (:69-101),
converts PBR materials (:103-195), builds one BLAS per primitive and one
TLAS instance per node-tree mesh reference with accumulated transform,
SBTOffset = 0 and customInstanceID = material index (:287-315), and
maintains the `<path>.cache` TLAS checkpoint (:222-263).
"""

from __future__ import annotations

import io
import os
import time
from typing import List, Optional

import numpy as np

from radiance_tpu_torch.api import accel
from radiance_tpu_torch.core import device as rdevice
from radiance_tpu_torch.core import types
from radiance_tpu_torch.scene import bindings, gltf
from radiance_tpu_torch.scene.objmesh import smooth_normals
from radiance_tpu_torch.scene.procedural import HostScene

# The reference fixes textures at 4096^2 (sceneBuilder.cpp:21 TEX_DIM);
# that costs 64 MiB per texture on device, so the default here is 1024
# with the reference's value available via tex_dim=4096.
DEFAULT_TEX_DIM = 1024


def _decode_textures(images: List[bytes], tex_dim: int,
                     path: str) -> Optional[np.ndarray]:
    if not images:
        return None
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise ImportError(f"{path}: decoding its {len(images)} embedded "
                          f"texture(s) needs PIL, which is not "
                          f"installed") from e

    out = np.zeros((len(images), tex_dim, tex_dim, 4), np.uint8)
    for i, data in enumerate(images):
        img = PILImage.open(io.BytesIO(data)).convert("RGBA")
        if img.size != (tex_dim, tex_dim):
            img = img.resize((tex_dim, tex_dim), PILImage.BILINEAR)
        out[i] = np.asarray(img)
    return out


_MESH_EXTS = (".obj", ".stl", ".ply", ".dae", ".fbx")


def _mesh_as_gltf_scene(path: str) -> gltf.GLTFScene:
    """Adapt a raw mesh file (obj/stl/ply/dae/fbx) into a one-primitive
    GLTFScene with a neutral diffuse material, so every format the mesh
    importers read gets the full Scene::Load pipeline (the reference
    gets this via assimp, sceneBuilder.cpp:32-67)."""
    from radiance_tpu_torch.scene.meshformats import load_mesh

    v, t, n, uv = load_mesh(path)
    prim = gltf.Primitive(positions=v, normals=n,
                          uvs=np.ascontiguousarray(uv[:, :2]),
                          indices=t, material=0)
    mat = gltf.GLTFMaterial(name=os.path.basename(path),
                            base_color=(0.8, 0.8, 0.8, 1.0),
                            metallic=0.0, roughness=0.8)
    return gltf.GLTFScene(meshes=[[prim]], materials=[mat], images=[],
                          nodes=[{"mesh": 0}], roots=[0])


def load_scene(path: str, use_cache: bool = False,
               tex_dim: int = DEFAULT_TEX_DIM,
               verbose: bool = True, device=rdevice.DEFAULT) -> HostScene:
    """Load a GLB — or any raw mesh format the importers read — into a
    HostScene (bindings + TLAS).

    use_cache: reuse/produce `<path>.cache` (the serialized TLAS with
    embedded BLAS blobs), skipping the SAH build like the reference's
    LOAD_FROM_CACHE path (sceneBuilder.cpp:222-263).
    device: where the resources are made; the TLAS makes its device
    scene lazily (HostScene.device_scene).
    """
    if path.lower().endswith(_MESH_EXTS):
        scene = _mesh_as_gltf_scene(path)
    else:
        scene = gltf.parse_glb(path)
    textures = _decode_textures(scene.images, tex_dim, path)

    # flatten primitives: each becomes a "mesh" (assimp flattens the same
    # way; mesh index mapping below mirrors it)
    flat_prims = []
    prim_of_mesh: List[List[int]] = []
    for prims in scene.meshes:
        ids = []
        for p in prims:
            ids.append(len(flat_prims))
            flat_prims.append(p)
        prim_of_mesh.append(ids)

    mesh_infos = []
    all_v, all_t, all_n, all_uv = [], [], [], []
    v_off = t_off = 0
    for p in flat_prims:
        nrm = p.normals if p.normals is not None else smooth_normals(
            p.positions, p.indices)
        uv3 = np.zeros((len(p.positions), 3), np.float32)
        if p.uvs is not None:
            uv3[:, :2] = p.uvs
        mesh_infos.append(types.MeshInfo(
            vertex_offset=v_off * 3, index_offset=t_off * 3,
            uv_offset=v_off * 3, normal_offset=v_off * 3,
            material_index=max(p.material, 0)))
        all_v.append(p.positions)
        all_t.append(p.indices)
        all_n.append(nrm)
        all_uv.append(uv3)
        v_off += len(p.positions)
        t_off += len(p.indices)

    materials = []
    for m in scene.materials:
        materials.append(types.Material(
            albedo=m.base_color,
            metallic=m.metallic if m.metallic_roughness_tex == -1 else 0.0,
            roughness=m.roughness,
            transmission=m.transmission,
            ior=m.ior,
            albedo_tex=m.base_color_tex,
            metallic_tex=m.metallic_roughness_tex,
            roughness_tex=m.metallic_roughness_tex,
            normal_tex=m.normal_tex))
    if not materials:
        materials = [types.Material()]

    # instance creation order (node-tree traversal), reproducible with or
    # without the AS cache.  The reference indexes meshInfoData by
    # gl_InstanceID and silently relies on one-instance-per-mesh in mesh
    # order (SURVEY.md quirks; shader.cl:310); we make the contract explicit
    # by binding an *instance-ordered* MeshInfo table, which also makes
    # shared/multiply-instanced meshes correct.
    inst_prims = [pid for mesh_idx, _ in scene.instances()
                  for pid in prim_of_mesh[mesh_idx]]
    inst_tfs = [tf for mesh_idx, tf in scene.instances()
                for _ in prim_of_mesh[mesh_idx]]
    if not inst_prims:  # no node tree: one identity instance per primitive
        inst_prims = list(range(len(flat_prims)))
        inst_tfs = [np.eye(4, dtype=np.float32)] * len(flat_prims)
    instance_mesh_infos = [mesh_infos[pid] for pid in inst_prims]

    # --- acceleration structures (with cache) ---
    cache_path = path + ".cache"
    instances = []
    if use_cache and os.path.exists(cache_path):
        tlas = accel.FileToTopAccelStruct(cache_path)
        if verbose:
            print(f"Loaded AS cache: {cache_path}")
    else:
        t0 = time.time()
        blas_list = [
            accel.BuildBottomAccelStruct(types.Mesh(p.positions, p.indices))
            for p in flat_prims
        ]
        total_tris = sum(len(p.indices) for p in flat_prims)
        instances = [
            types.Instance(
                transform=tf, sbt_offset=0,
                custom_instance_id=mesh_infos[pid].material_index,
                bottom_accel_struct=blas_list[pid])
            for pid, tf in zip(inst_prims, inst_tfs)
        ]
        tlas = accel.BuildTopAccelStruct(instances)
        if use_cache:
            accel.TopAccelStructToFile(tlas, cache_path)
        if verbose:
            print(f"\nBVH build report:\n"
                  f"\tNumber of meshes: {len(flat_prims)}\n"
                  f"\tNumber of vertices: {v_off}\n"
                  f"\tNumber of triangles: {total_tris}\n"
                  f"\tBuild time cost: {time.time() - t0:.3f} (sec)")

    props = types.SceneProperties(lights=[types.DirLight(
        direction=(0.3, -1.0, -0.4, 0.0), color=(3.0, 3.0, 3.0, 1.0))])
    res = bindings.make_scene_bindings(
        instance_mesh_infos,
        np.concatenate(all_v) if all_v else np.zeros((0, 3), np.float32),
        np.concatenate(all_t) if all_t else np.zeros((0, 3), np.uint32),
        np.concatenate(all_uv) if all_uv else np.zeros((0, 3), np.float32),
        np.concatenate(all_n) if all_n else np.zeros((0, 3), np.float32),
        materials, props, textures=textures, device=device)
    return HostScene(instances=instances, mesh_infos=instance_mesh_infos,
                     materials=materials, resources=res, tlas=tlas)
