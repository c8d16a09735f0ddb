"""Scene resource bindings: the descriptor-set payload shaders consume.

Port of radiance_tpu/scene/bindings.py (reference:
samples/sample1.cpp:387-395, tools/sceneBuilder.h:8-28): a dict of
named tensors with the reference's layouts (flat f32 attribute arrays
with element offsets, vec3-strided UVs, material SoA).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from radiance_tpu_torch import config
from radiance_tpu_torch.core import device as rdevice
from radiance_tpu_torch.core import types


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Sampler config (reference: CreateSampler, radiance.cpp:123-131)."""
    addressing: int = config.ADDRESS_REPEAT
    filter: int = config.FILTER_LINEAR


def scene_binding_arrays(
    mesh_infos: Sequence[types.MeshInfo],
    vertices: np.ndarray,      # [V, 3] concatenated across meshes
    indices: np.ndarray,       # [T, 3] uint32, per-mesh-local indices
    uvs: np.ndarray,           # [V, 3] (vec3-strided like the loader)
    normals: np.ndarray,       # [V, 3]
    materials: Sequence[types.Material],
    scene_props: types.SceneProperties,
) -> Dict[str, np.ndarray]:
    """The resource arrays as numpy (the same arrays the JAX package's
    make_scene_bindings puts on its device)."""
    mats = list(materials) or [types.Material()]
    mesh_infos = list(mesh_infos) or [types.MeshInfo()]
    sp = scene_props.to_numpy()

    def ints(vals):
        return np.array(vals, np.int32)

    def floats(vals):
        return np.array(vals, np.float32)

    return dict(
        mesh_vertex_offset=ints([m.vertex_offset for m in mesh_infos]),
        mesh_index_offset=ints([m.index_offset for m in mesh_infos]),
        mesh_uv_offset=ints([m.uv_offset for m in mesh_infos]),
        mesh_normal_offset=ints([m.normal_offset for m in mesh_infos]),
        mesh_material_index=ints([m.material_index for m in mesh_infos]),
        vertex_data=np.ascontiguousarray(vertices, np.float32).reshape(-1),
        index_data=np.ascontiguousarray(indices, np.uint32).reshape(-1)
        .astype(np.int32),
        uv_data=np.ascontiguousarray(uvs, np.float32).reshape(-1),
        normal_data=np.ascontiguousarray(normals, np.float32).reshape(-1),
        mat_albedo=floats([m.albedo for m in mats]),
        mat_metallic=floats([m.metallic for m in mats]),
        mat_roughness=floats([m.roughness for m in mats]),
        mat_transmission=floats([m.transmission for m in mats]),
        mat_ior=floats([m.ior for m in mats]),
        mat_albedo_tex=ints([m.albedo_tex for m in mats]),
        mat_metallic_tex=ints([m.metallic_tex for m in mats]),
        mat_roughness_tex=ints([m.roughness_tex for m in mats]),
        mat_normal_tex=ints([m.normal_tex for m in mats]),
        light_direction=np.ascontiguousarray(sp["lights"]["direction"]),
        light_color=np.ascontiguousarray(sp["lights"]["color"]),
        light_count=np.int32(sp["lightCount"][0]),
    )


def resources_from_numpy(arrays: Mapping, textures: Optional[np.ndarray] = None,
                         sampler: Sampler = Sampler(),
                         device=rdevice.DEFAULT) -> Dict:
    """The shader resource dict with its arrays as tensors on `device`.

    arrays: name -> numpy array, e.g. scene_binding_arrays' output or a
    JAX resource dict's arrays (np.asarray of each); non-array entries
    (camera, sampler, textures) are not read from it.
    """
    device = rdevice.resolve(device)
    res = {k: torch.from_numpy(np.array(v)).to(device)
           for k, v in arrays.items()
           if k not in ("camera", "sampler", "textures")}
    res["textures"] = (None if textures is None
                       else torch.from_numpy(np.ascontiguousarray(
                           textures)).to(device))
    res["sampler"] = sampler
    return res


def make_scene_bindings(mesh_infos, vertices, indices, uvs, normals,
                        materials, scene_props, textures=None,
                        sampler: Sampler = Sampler(),
                        device=rdevice.DEFAULT) -> Dict:
    """Assemble the shader resource dict (tensors on `device`)."""
    arrays = scene_binding_arrays(mesh_infos, vertices, indices, uvs,
                                  normals, materials, scene_props)
    return resources_from_numpy(arrays, textures, sampler, device)
