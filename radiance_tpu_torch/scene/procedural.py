"""Procedural scenes: the Cornell-style box.

Port of radiance_tpu/scene/procedural.py's assemble_scene and
cornell_box (the loader's conventions: one instance per mesh,
customInstanceID = material index, SBTOffset = 0;
tools/sceneBuilder.cpp:287-315).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from radiance_tpu_torch.api import accel
from radiance_tpu_torch.core import device as rdevice
from radiance_tpu_torch.core import types
from radiance_tpu_torch.scene import bindings


@dataclasses.dataclass
class HostScene:
    """Everything a sample needs: bindings + acceleration structure."""
    instances: list
    mesh_infos: list
    materials: list
    resources: dict              # shader bindings (without the camera)
    tlas: accel.TopAccelStruct

    def device_scene(self, device=rdevice.DEFAULT):
        return self.tlas.device_scene(device)


def _quad(p0, p1, p2, p3):
    """Two-triangle quad; normal from winding."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)
    n = np.cross(verts[1] - verts[0], verts[2] - verts[0])
    n = n / np.linalg.norm(n)
    normals = np.tile(n, (4, 1)).astype(np.float32)
    uvs = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    return verts, tris, normals, uvs


def _box(center, size):
    """Axis-aligned box with outward normals."""
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32) / 2
    x0, x1 = c[0] - s[0], c[0] + s[0]
    y0, y1 = c[1] - s[1], c[1] + s[1]
    z0, z1 = c[2] - s[2], c[2] + s[2]
    faces = [  # +x, -x, +y, -y, +z, -z
        _quad([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]),
        _quad([x0, y0, z1], [x0, y1, z1], [x0, y1, z0], [x0, y0, z0]),
        _quad([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0]),
        _quad([x0, y0, z1], [x0, y0, z0], [x1, y0, z0], [x1, y0, z1]),
        _quad([x1, y0, z1], [x1, y1, z1], [x0, y1, z1], [x0, y0, z1]),
        _quad([x0, y0, z0], [x0, y1, z0], [x1, y1, z0], [x1, y0, z0]),
    ]
    verts = np.concatenate([f[0] for f in faces])
    tris = np.concatenate([f[1] + 4 * i for i, f in enumerate(faces)])
    normals = np.concatenate([f[2] for f in faces])
    uvs = np.concatenate([f[3] for f in faces])
    return verts, tris.astype(np.uint32), normals, uvs


def assemble_scene(meshes, materials, scene_props: types.SceneProperties,
                   textures=None,
                   sampler: bindings.Sampler = bindings.Sampler(),
                   transforms=None, verbose: bool = False,
                   device=rdevice.DEFAULT) -> HostScene:
    """meshes: list of (verts, tris, normals, uvs, material_index).

    Concatenated attribute arrays + MeshInfo offsets like the reference
    loader (sceneBuilder.cpp:69-101), one BLAS per mesh and one identity
    (or given) instance per mesh (:287-315).  Resources live on `device`.
    """
    mesh_infos: List[types.MeshInfo] = []
    all_v, all_t, all_n, all_uv = [], [], [], []
    instances = []
    v_off = 0
    t_off = 0
    for i, (verts, tris, normals, uvs, mat_idx) in enumerate(meshes):
        mesh_infos.append(types.MeshInfo(
            vertex_offset=v_off * 3, index_offset=t_off * 3,
            uv_offset=v_off * 3, normal_offset=v_off * 3,
            material_index=mat_idx))
        all_v.append(verts)
        all_t.append(tris)
        all_n.append(normals)
        all_uv.append(uvs)
        blas = accel.BuildBottomAccelStruct(types.Mesh(verts, tris),
                                            verbose=verbose)
        tf = np.eye(4, dtype=np.float32) if transforms is None else transforms[i]
        instances.append(types.Instance(
            transform=tf, sbt_offset=0, custom_instance_id=mat_idx,
            bottom_accel_struct=blas))
        v_off += len(verts)
        t_off += len(tris)

    tlas = accel.BuildTopAccelStruct(instances, verbose=verbose)
    res = bindings.make_scene_bindings(
        mesh_infos, np.concatenate(all_v), np.concatenate(all_t),
        np.concatenate(all_uv), np.concatenate(all_n),
        materials, scene_props, textures=textures, sampler=sampler,
        device=device)
    return HostScene(instances=instances, mesh_infos=mesh_infos,
                     materials=list(materials), resources=res, tlas=tlas)


def cornell_box(light_dir=(0.3, -1.0, 0.4), light_intensity=3.0,
                verbose: bool = False, device=rdevice.DEFAULT) -> HostScene:
    """Cornell-style box: 5 walls + 2 boxes, distinct PBR materials.

    The box spans x,y in [-5, 5], z in [-10, 0]; its open side faces +z.
    """
    white = types.Material(albedo=(0.73, 0.73, 0.73, 1.0), roughness=0.9)
    red = types.Material(albedo=(0.65, 0.05, 0.05, 1.0), roughness=0.9)
    green = types.Material(albedo=(0.12, 0.45, 0.15, 1.0), roughness=0.9)
    metal = types.Material(albedo=(0.9, 0.9, 0.9, 1.0), metallic=1.0,
                           roughness=0.15)
    diffuse_box = types.Material(albedo=(0.85, 0.75, 0.45, 1.0), roughness=0.7)
    materials = [white, red, green, metal, diffuse_box]

    meshes = [
        _quad([-5, -5, 0], [5, -5, 0], [5, -5, -10], [-5, -5, -10]) + (0,),
        _quad([-5, 5, -10], [5, 5, -10], [5, 5, 0], [-5, 5, 0]) + (0,),
        _quad([-5, -5, -10], [5, -5, -10], [5, 5, -10], [-5, 5, -10]) + (0,),
        _quad([-5, -5, 0], [-5, -5, -10], [-5, 5, -10], [-5, 5, 0]) + (1,),
        _quad([5, -5, -10], [5, -5, 0], [5, 5, 0], [5, 5, -10]) + (2,),
        _box([-2.0, -3.0, -7.0], [2.5, 4.0, 2.5]) + (3,),
        _box([2.2, -4.0, -4.5], [2.0, 2.0, 2.0]) + (4,),
    ]
    props = types.SceneProperties(lights=[
        types.DirLight(direction=(*light_dir, 0.0),
                       color=(light_intensity,) * 3 + (1.0,)),
    ])
    return assemble_scene(meshes, materials, props, verbose=verbose,
                          device=device)
