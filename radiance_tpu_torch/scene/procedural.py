"""Procedural scenes: the Cornell-style box and the stress geometry.

Port of radiance_tpu/scene/procedural.py's assemble_scene and
cornell_box (the loader's conventions: one instance per mesh,
customInstanceID = material index, SBTOffset = 0;
tools/sceneBuilder.cpp:287-315).

interior_hall (bench.py's interior scene, where temporal t-bounds are
measured) and random_triangle_cloud are numpy copies of the JAX
module's generators: the same arrays from the same seeds.
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


def _displaced_grid(origin, eu, ev, nu, nv, bump, rng, skip=None):
    """Tessellated rectangle origin + u*eu + v*ev, displaced along the
    face normal by smoothed noise.  Returns [K,3,3] triangle corners.
    skip: optional [nu,nv] bool mask of quads to omit (window holes)."""
    origin = np.asarray(origin, np.float64)
    eu = np.asarray(eu, np.float64)
    ev = np.asarray(ev, np.float64)
    u = np.linspace(0.0, 1.0, nu + 1)
    v = np.linspace(0.0, 1.0, nv + 1)
    pts = (origin[None, None]
           + u[:, None, None] * eu[None, None]
           + v[None, :, None] * ev[None, None])
    nrm = np.cross(eu, ev)
    nrm = nrm / max(np.linalg.norm(nrm), 1e-12)
    h = rng.normal(scale=bump, size=(nu + 1, nv + 1))
    h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0)
         + np.roll(h, 1, 1) + np.roll(h, -1, 1)) / 5.0
    # zero displacement on the border so adjacent patches stay
    # watertight where they meet (no seam cracks at wall/floor edges)
    h[0, :] = h[-1, :] = 0.0
    h[:, 0] = h[:, -1] = 0.0
    pts = pts + h[:, :, None] * nrm[None, None]
    c00, c10 = pts[:-1, :-1], pts[1:, :-1]
    c01, c11 = pts[:-1, 1:], pts[1:, 1:]
    if skip is not None:
        keep = ~skip
        c00, c10, c01, c11 = (c[keep] for c in (c00, c10, c01, c11))
    else:
        c00, c10, c01, c11 = (c.reshape(-1, 3)
                              for c in (c00, c10, c01, c11))
    t1 = np.stack([c00, c10, c11], axis=1)
    t2 = np.stack([c00, c11, c01], axis=1)
    return np.concatenate([t1, t2]).astype(np.float32)


def _fluted_column(cx, cz, y0, y1, radius, nseg, nz, rng):
    """Tessellated column with carved radius variation: [K,3,3]."""
    th = np.linspace(0.0, 2.0 * np.pi, nseg + 1)
    ys = np.linspace(y0, y1, nz + 1)
    flute = 1.0 + 0.06 * np.cos(th * 8)[None, :]
    swell = 1.0 + 0.10 * np.sin(np.linspace(0, np.pi, nz + 1))[:, None]
    r = radius * flute * swell
    x = cx + r * np.cos(th)[None, :]
    z = cz + r * np.sin(th)[None, :]
    y = np.broadcast_to(ys[:, None], x.shape)
    pts = np.stack([x, y, z], axis=-1)
    c00, c10 = pts[:-1, :-1], pts[1:, :-1]
    c01, c11 = pts[:-1, 1:], pts[1:, 1:]
    c00, c10, c01, c11 = (c.reshape(-1, 3)
                          for c in (c00, c10, c01, c11))
    t1 = np.stack([c00, c10, c11], axis=1)
    t2 = np.stack([c00, c11, c01], axis=1)
    return np.concatenate([t1, t2]).astype(np.float32)


def interior_hall(n_tris: int, seed: int = 11):
    """Reference-shaped interior benchmark geometry: a closed
    cathedral-class hall (the reference's target scenes are interiors
    -- house/cathedral, sample1.cpp:344-360) with a tessellated shell,
    two colonnades, floor clutter, and ceiling window openings so a
    fraction of shadow rays escape.

    Unlike the open triangle-cloud bench scene (primary hit rate
    ~0.18), every primary ray terminates on geometry here, which is
    the regime where traversal occlusion culls and t-ordering pay.

    Returns (verts [V,3] f32, tris [T,3] u32, meta) with meta holding
    the suggested camera origin/target and the (to-light) direction
    aligned with the window openings.
    """
    rng = np.random.default_rng(seed)
    HX, HY, HZ = 20.0, 12.0, 50.0        # half-x, height, half-z
    tris_parts = []

    # --- shell: ~40% of the budget over the interior surface area
    shell_budget = int(n_tris * 0.40)
    areas = {
        "floor": 2 * HX * 2 * HZ, "ceil": 2 * HX * 2 * HZ,
        "wall_l": HY * 2 * HZ, "wall_r": HY * 2 * HZ,
        "end_n": 2 * HX * HY, "end_s": 2 * HX * HY,
    }
    total_area = sum(areas.values())
    quad_area = total_area / max(shell_budget // 2, 1)
    cell = max(np.sqrt(quad_area), 1e-3)

    def grid_n(lu, lv):
        return max(int(round(lu / cell)), 1), max(int(round(lv / cell)), 1)

    nu, nv = grid_n(2 * HX, 2 * HZ)
    tris_parts.append(_displaced_grid(
        [-HX, 0, -HZ], [2 * HX, 0, 0], [0, 0, 2 * HZ], nu, nv, 0.05, rng))
    # ceiling with 3 x 8 window openings (~18% of its area)
    skip = np.zeros((nu, nv), bool)
    iu = (np.arange(nu)[:, None] * 3) // max(nu, 1)       # 3 bands in x
    iv = (np.arange(nv)[None, :] * 8) // max(nv, 1)       # 8 bays in z
    fu = (np.arange(nu)[:, None] * 3) / max(nu, 1) - iu   # in-band frac
    fv = (np.arange(nv)[None, :] * 8) / max(nv, 1) - iv
    skip[((fu > 0.25) & (fu < 0.75) & (fv > 0.3) & (fv < 0.7))
         & ((iu + iv) % 2 == 0)] = True
    tris_parts.append(_displaced_grid(
        [-HX, HY, -HZ], [2 * HX, 0, 0], [0, 0, 2 * HZ], nu, nv, 0.05,
        rng, skip=skip))
    nu, nv = grid_n(HY, 2 * HZ)
    tris_parts.append(_displaced_grid(
        [-HX, 0, -HZ], [0, HY, 0], [0, 0, 2 * HZ], nu, nv, 0.08, rng))
    tris_parts.append(_displaced_grid(
        [HX, 0, -HZ], [0, HY, 0], [0, 0, 2 * HZ], nu, nv, 0.08, rng))
    nu, nv = grid_n(2 * HX, HY)
    tris_parts.append(_displaced_grid(
        [-HX, 0, -HZ], [2 * HX, 0, 0], [0, HY, 0], nu, nv, 0.08, rng))
    tris_parts.append(_displaced_grid(
        [-HX, 0, HZ], [2 * HX, 0, 0], [0, HY, 0], nu, nv, 0.08, rng))

    # --- colonnades: ~24% over two rows of columns
    col_budget = int(n_tris * 0.24)
    n_cols = 20                               # 10 per side
    per_col = max(col_budget // n_cols, 8)
    nseg = max(int(np.sqrt(per_col / 2.0 * (HY / (2 * np.pi * 1.2)))), 6)
    nz = max(per_col // (2 * nseg), 2)
    zs = np.linspace(-HZ * 0.8, HZ * 0.8, n_cols // 2)
    for z in zs:
        for cx in (-HX * 0.6, HX * 0.6):
            tris_parts.append(_fluted_column(
                cx, z, 0.0, HY, 1.2, nseg, nz, rng))

    # --- clutter: the remainder as grounded cluster "statues"
    used = sum(len(t) for t in tris_parts)
    clutter = max(n_tris - used, 0)
    n_clusters = 120
    per = max(clutter // n_clusters, 1)
    for _ in range(n_clusters):
        c = np.array([rng.uniform(-HX * 0.45, HX * 0.45),
                      rng.uniform(0.3, 3.0),
                      rng.uniform(-HZ * 0.9, HZ * 0.9)])
        local = rng.uniform(-1.0, 1.0, size=(per, 3)) \
            * np.array([1.0, 1.4, 1.0])
        offs = rng.normal(scale=0.12, size=(per, 3, 3))
        tris_parts.append(
            ((c + local)[:, None, :] + offs).astype(np.float32))

    corners = np.concatenate(tris_parts)
    verts = corners.reshape(-1, 3).astype(np.float32)
    tris = np.arange(len(verts), dtype=np.uint32).reshape(-1, 3)
    meta = {
        "camera_origin": (0.0, 6.0, HZ * 0.92),
        "camera_forward": (0.0, 0.0, -1.0),
        "light_dir": tuple((np.array([0.15, 1.0, 0.05])
                            / np.linalg.norm([0.15, 1.0, 0.05]))
                           .tolist()),
        "extent": (HX, HY, HZ),
    }
    return verts, tris, meta


def random_triangle_cloud(n_tris: int, seed: int = 0, spread: float = 10.0,
                          n_materials: int = 4,
                          device=rdevice.DEFAULT) -> HostScene:
    """Unstructured stress scene for benchmarks; resources on `device`."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(n_tris, 3)).astype(np.float32)
    offs = rng.normal(scale=0.25, size=(n_tris, 3, 3)).astype(np.float32)
    verts = (centers[:, None, :] + offs).reshape(-1, 3)
    tris = np.arange(n_tris * 3, dtype=np.uint32).reshape(-1, 3)
    normals = np.repeat(
        np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                 verts[tris[:, 2]] - verts[tris[:, 0]]), 3, axis=0)
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-9)
    uvs = np.zeros_like(verts)
    mats = [types.Material(albedo=tuple(rng.uniform(0.2, 1.0, 3)) + (1.0,),
                           roughness=float(rng.uniform(0.1, 1.0)))
            for _ in range(n_materials)]
    props = types.SceneProperties(lights=[types.DirLight(
        direction=(0.2, -1.0, 0.3, 0.0), color=(3.0, 3.0, 3.0, 1.0))])
    return assemble_scene(
        [(verts, tris, normals.astype(np.float32), uvs, 0)], mats, props,
        device=device)
