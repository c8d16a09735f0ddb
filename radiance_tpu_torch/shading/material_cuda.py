"""The fused material wave: csrc/shade_material.cu's two kernels around
the shadow trace.

One closest-hit wave whose shading runs only the built-in `material`
closest-hit shader and `environment` miss shader (engine/shaders.py) --
the engine's context, the SBT dispatch with both shaders' bodies and the
path update of shader.cl:238-252 -- as material_prep, the unchanged
shadow trace, and material_finish (the source's note gives the design
and the byte bound).  engine/pathtracer.py decides when a wave takes it;
the SBT path it replaces is its plain version (the CPU's route, and what
the card tests hold the kernels to).  CUDA tensors only: the wrappers
launch or raise.
"""

from __future__ import annotations

import ctypes

import torch

from radiance_tpu_torch.ops import cuda_build

_PREP_POINTERS = (
    "t", "prim", "slot", "b1", "b2", "o", "d", "alive",
    "inst_inv", "inst_tf", "inst_id",
    "mesh_io", "mesh_no", "mesh_uo", "mesh_mat",
    "index_data", "normal_data", "uv_data",
    "mat_albedo", "mat_metallic", "mat_roughness", "mat_transmission",
    "mat_ior", "albedo_tex", "metallic_tex", "roughness_tex", "normal_tex",
    "tex", "hit_pos", "rec")
_PREP_I64 = ("n", "n_index", "n_normal", "n_uv")
_PREP_I32 = ("n_inst", "n_mesh", "n_mat", "albedo_w", "tex_t", "tex_h",
             "tex_w", "tex_c", "addressing", "filter")


class PrepArgs(ctypes.Structure):
    """shade_material.cu's MaterialPrepArgs, field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _PREP_POINTERS]
                + [(f, ctypes.c_int64) for f in _PREP_I64]
                + [(f, ctypes.c_int32) for f in _PREP_I32])


_P, _U32 = cuda_build.P, ctypes.c_uint32
KERNEL = cuda_build.KernelLib("shade_material", (
    ("rt_material_prep", (ctypes.POINTER(PrepArgs), _P)),
    ("rt_material_finish", (cuda_build.I64, _P, _P, _P, _P, _P, _P, _P, _P,
                            _U32, _U32, _P, _P, _P, _P, _P, _P))),
    ("-fmad=false",))

REC_WIDTH = 16          # the shading record's floats a lane


def load_kernel():
    """Build (once per process, if the .so is missing or stale) and load
    the library."""
    return cuda_build.load(KERNEL)


def _flat(x, dtype):
    return x.to(dtype).contiguous()


def material_prep(scene, res, hits, o, d, alive):
    """Launch rt_material_prep: (hit_pos [n, 3], rec [n, REC_WIDTH]) f32.

    hits: the wave's HitRecord; o, d [n, 3] f32 world rays; alive [n]
    bool.  hit_pos is each shading lane's shadow-ray origin (0 elsewhere);
    rec its shading record, unwritten on other lanes."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError("material_prep needs CUDA tensors")
    n = o.shape[0]
    f32, i32 = torch.float32, torch.int32
    keep = {
        "t": _flat(hits.t, f32), "prim": _flat(hits.prim, i32),
        "slot": _flat(hits.slot, i32), "b1": _flat(hits.b1, f32),
        "b2": _flat(hits.b2, f32), "o": _flat(o, f32), "d": _flat(d, f32),
        "alive": _flat(alive, torch.bool),
        "inst_inv": _flat(scene.inst_inv, f32),
        "inst_tf": _flat(scene.inst_transform, f32),
        "inst_id": _flat(scene.inst_id, i32),
        "mesh_io": _flat(res["mesh_index_offset"], i32),
        "mesh_no": _flat(res["mesh_normal_offset"], i32),
        "mesh_uo": _flat(res["mesh_uv_offset"], i32),
        "mesh_mat": _flat(res["mesh_material_index"], i32),
        "index_data": _flat(res["index_data"], i32),
        "normal_data": _flat(res["normal_data"], f32),
        "uv_data": _flat(res["uv_data"], f32),
        "mat_albedo": _flat(res["mat_albedo"], f32),
        "mat_metallic": _flat(res["mat_metallic"], f32),
        "mat_roughness": _flat(res["mat_roughness"], f32),
        "mat_transmission": _flat(res["mat_transmission"], f32),
        "mat_ior": _flat(res["mat_ior"], f32),
        "albedo_tex": _flat(res["mat_albedo_tex"], i32),
        "metallic_tex": _flat(res["mat_metallic_tex"], i32),
        "roughness_tex": _flat(res["mat_roughness_tex"], i32),
        "normal_tex": _flat(res["mat_normal_tex"], i32),
        "hit_pos": torch.empty(n, 3, dtype=f32, device=dev),
        "rec": torch.empty(n, REC_WIDTH, dtype=f32, device=dev)}
    fn = "material_prep"
    for name in ("t", "prim", "slot", "b1", "b2", "alive"):
        cuda_build.check_tensor(fn, name, keep[name], keep[name].dtype, (n,),
                                dev)
    for name in ("o", "d"):
        cuda_build.check_tensor(fn, name, keep[name], f32, (n, 3), dev)
    n_inst = keep["inst_id"].shape[0]
    for name in ("inst_inv", "inst_tf"):
        cuda_build.check_tensor(fn, name, keep[name], f32, (n_inst, 4, 4),
                                dev)
    n_mesh = keep["mesh_io"].shape[0]
    n_mat = keep["mat_metallic"].shape[0]
    cuda_build.check_tensor(fn, "mat_albedo", keep["mat_albedo"], f32,
                            (n_mat, None), dev)
    for names, count in (
            (("mesh_io", "mesh_no", "mesh_uo", "mesh_mat"), n_mesh),
            (("mat_metallic", "mat_roughness", "mat_transmission", "mat_ior",
              "albedo_tex", "metallic_tex", "roughness_tex", "normal_tex"),
             n_mat)):
        for name in names:
            cuda_build.check_tensor(fn, name, keep[name], keep[name].dtype,
                                    (count,), dev)
    if (min(n_inst, n_mesh, n_mat, keep["index_data"].shape[0],
            keep["normal_data"].shape[0]) < 1
            or keep["mat_albedo"].shape[1] < 3):
        raise ValueError(f"{fn}: an empty instance, mesh, material, index "
                         "or normal table, or albedo rows under 3 wide")
    tex = res.get("textures")
    if tex is not None:
        cuda_build.check_tensor(fn, "textures", tex, torch.uint8,
                                (None, None, None, None), dev)
        if tex.shape[3] < 3 or 0 in tex.shape[:3]:
            raise ValueError(f"{fn}: textures must be [T, H, W, C >= 3], "
                             f"got {tuple(tex.shape)}")
        keep["tex"] = tex
        sampler = res["sampler"]
        dims = dict(tex_t=tex.shape[0], tex_h=tex.shape[1],
                    tex_w=tex.shape[2], tex_c=tex.shape[3],
                    addressing=sampler.addressing, filter=sampler.filter)
    else:
        dims = dict(tex_t=0, tex_h=0, tex_w=0, tex_c=0, addressing=0,
                    filter=0)
    args = PrepArgs(
        **{f: (keep[f].data_ptr() if f in keep else None)
           for f in _PREP_POINTERS},
        n=n, n_index=keep["index_data"].shape[0],
        n_normal=keep["normal_data"].shape[0], n_uv=keep["uv_data"].shape[0],
        n_inst=n_inst, n_mesh=n_mesh, n_mat=n_mat,
        albedo_w=keep["mat_albedo"].shape[1], **dims)
    lib = load_kernel()
    if n:
        with cuda_build.on_device(dev) as stream:
            err = lib.rt_material_prep(ctypes.byref(args), stream)
        cuda_build.check_launch(fn, err)
        cuda_build.count_launch(material_prep)
    return keep["hit_pos"], keep["rec"]


def material_finish(hits_t, occluded, rec, o, d, pixel_index, light_l,
                    light_rgb, frame_id: int, depth: int, color,
                    contribution, alive):
    """Launch rt_material_finish: the wave's next path state (color,
    contribution, alive, next_origin, next_dir).

    color and contribution [n, 3] f32 and alive [n] bool are updated in
    place (and returned) where they are contiguous, else in contiguous
    copies; next_origin and next_dir are new [n, 3] f32 tensors.  hits_t
    [n] f32, occluded [n] bool (the shadow trace's hit), rec from
    material_prep, o, d [n, 3] f32, pixel_index [n] int, light_l and
    light_rgb [3] f32 (the light's unit direction towards it and its
    colour); frame_id and depth seed PCG3D as the material shader does."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError("material_finish needs CUDA tensors")
    n = o.shape[0]
    f32 = torch.float32
    hits_t, occluded = _flat(hits_t, f32), _flat(occluded, torch.bool)
    pixel = _flat(pixel_index, torch.int64)
    o, d = _flat(o, f32), _flat(d, f32)
    light_l, light_rgb = _flat(light_l, f32), _flat(light_rgb, f32)
    color, contribution = _flat(color, f32), _flat(contribution, f32)
    alive = _flat(alive, torch.bool)
    fn = "material_finish"
    for name, x in (("hits_t", hits_t), ("occluded", occluded),
                    ("pixel_index", pixel), ("alive", alive)):
        cuda_build.check_tensor(fn, name, x, x.dtype, (n,), dev)
    for name, x in (("o", o), ("d", d), ("color", color),
                    ("contribution", contribution)):
        cuda_build.check_tensor(fn, name, x, f32, (n, 3), dev)
    cuda_build.check_tensor(fn, "rec", rec, f32, (n, REC_WIDTH), dev)
    for name, x in (("light_l", light_l), ("light_rgb", light_rgb)):
        cuda_build.check_tensor(fn, name, x, f32, (3,), dev)
    next_o = torch.empty(n, 3, dtype=f32, device=dev)
    next_d = torch.empty(n, 3, dtype=f32, device=dev)
    lib = load_kernel()
    if n:
        with cuda_build.on_device(dev) as stream:
            err = lib.rt_material_finish(
                n, hits_t.data_ptr(), occluded.data_ptr(), rec.data_ptr(),
                o.data_ptr(), d.data_ptr(), pixel.data_ptr(),
                light_l.data_ptr(), light_rgb.data_ptr(),
                int(frame_id) & 0xFFFFFFFF, int(depth) & 0xFFFFFFFF,
                color.data_ptr(), contribution.data_ptr(), alive.data_ptr(),
                next_o.data_ptr(), next_d.data_ptr(), stream)
        cuda_build.check_launch(fn, err)
        cuda_build.count_launch(material_finish)
    return color, contribution, alive, next_o, next_d


# launches of each kernel, counted where a launch succeeds
material_prep.launches = 0
material_finish.launches = 0


def shade_wave(scene, res, hits, state, pixel_index, frame_id: int,
               depth: int, light, trace_occlusion):
    """One fused closest-hit wave's shading and path update: the state
    (color, contribution, alive, o, d) after it, as _sample_step's SBT
    path gives it.  light [3] f32 is the unit direction towards the
    light (engine/context.get_light_direction); trace_occlusion is the
    wave's shadow tracer, called as the material shader calls it, on every
    lane alive and hit."""
    color, contribution, alive, o, d = state
    hit_pos, rec = material_prep(scene, res, hits, o, d, alive)
    occluded = trace_occlusion(hit_pos, light.expand(o.shape[0], 3), 0.001,
                               1000.0, active=alive & hits.hit)
    return material_finish(hits.t, occluded, rec, o, d, pixel_index, light,
                           res["light_color"][0, :3], frame_id, depth, color,
                           contribution, alive)
