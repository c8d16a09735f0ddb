"""Pipeline objects + TraceRays dispatch (RD:: C3 component parity).

Port of radiance_tpu/api/pipeline.py (reference: radiance/src/
radiance.cpp:142-267).  The reference compiles OpenCL source and extracts
the kernel named "raygen" (:152-179); here a ShaderModule is a
RaygenProgram -- a WavefrontPathTracer plus a descriptor layout that
tells TraceRays how to interpret the positionally-bound buffers (the
reference encodes that knowledge in the shader's parameter list,
samples/shader.cl:175-190).

TraceRays(platform, raygen, miss, hit, W, H) honors the reference's
contract: it consumes the bound pipeline + descriptor set, runs one frame
(batchSize samples x depth bounces), writes the u8 image and float scratch
buffers, and leaves RTProp.totalSamples for the host loop to advance
(sample1.cpp:479-490).  Unlike the reference (which ignores the three
group indices, radiance.cpp:242-248), the raygen index selects the
pipeline's module.  Descriptor tensors are made on the platform's device
and cached by buffer version; the accumulation image stays there between
frames.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from radiance_tpu_torch.api.platform import Buffer, ImageArray, Platform
from radiance_tpu_torch.core import device as rdevice
from radiance_tpu_torch.core import types
from radiance_tpu_torch.engine.pathtracer import WavefrontPathTracer
from radiance_tpu_torch.scene.bindings import Sampler
from radiance_tpu_torch.shading import camera as camera_mod
from radiance_tpu_torch.utils import profiling

# Descriptor type tags (reference: radiance.h:21-29)
ACCEL_STRUCT_TYPE = "accel_struct"
IMAGE_TYPE = "image"
IMAGE_ARRAY_TYPE = "image_array"
IMAGE_SAMPLER_TYPE = "sampler"
BUFFER_TYPE = "buffer"
TEX_ARRAY_TYPE = "tex_array"


@dataclasses.dataclass
class RaygenProgram:
    """A 'shader module': wavefront tracer + descriptor interpretation.

    descriptor_semantics: names, one per bound descriptor, drawn from
      rtprop, image_scratch, image, camera, scene_props, mesh_info,
      vertex, index, uv, normal, material, tex_array, sampler, top_as,
      extent, raw:<name> (opaque extra buffer exposed to shaders as
      res["raw:<name>"] float32 tensor).
    """
    tracer: WavefrontPathTracer
    descriptor_semantics: List[str]
    name: str = "raygen"


@dataclasses.dataclass
class Pipeline:
    """reference: PipelineCreateInfo (radiance.h:71-80)."""
    max_ray_recursion_depth: int
    layout: List[str]
    modules: List[RaygenProgram]
    groups: List[Any] = dataclasses.field(default_factory=list)


def CreateShaderModule(platform: Platform, code, size: int = 0,
                       name: str = "raygen") -> RaygenProgram:
    """The reference compiles OpenCL source here (radiance.cpp:152-179);
    shader programs are Python in this framework, so `code` must already be
    a RaygenProgram."""
    if isinstance(code, RaygenProgram):
        return code
    raise TypeError(
        "CreateShaderModule expects a RaygenProgram (see "
        "radiance_tpu_torch.engine.programs); runtime OpenCL-source "
        "compilation does not exist here.")


def CreatePipeline(info) -> Pipeline:
    """Identity passthrough like the reference (radiance.cpp:142-145)."""
    if isinstance(info, Pipeline):
        return info
    return Pipeline(
        max_ray_recursion_depth=info.get("maxRayRecursionDepth", 1),
        layout=info.get("layout", []),
        modules=info.get("modules", []),
        groups=info.get("groups", []))


def CreateDescriptorSet(handles: Sequence[Any]) -> List[Any]:
    """reference: radiance.cpp:147-149 (identity)."""
    return list(handles)


def CreatePipelineLayout(descriptor_types: Sequence[str]) -> List[str]:
    """reference: radiance.cpp:181-184 (identity)."""
    return list(descriptor_types)


def BindPipeline(platform: Platform, pipeline: Pipeline) -> None:
    """reference: radiance.cpp:226-229."""
    platform.active_pipeline = pipeline


def BindDescriptorSet(platform: Platform, descriptor_set: Sequence[Any]) -> None:
    """reference: radiance.cpp:231-240 (sets kernel args positionally)."""
    platform.bound_descriptor_set = list(descriptor_set)


# ---------------------------------------------------------------------------
# Descriptor parsing
# ---------------------------------------------------------------------------

def _parse_struct(buf: Buffer, dtype: np.dtype):
    return np.frombuffer(buf.read(), dtype=dtype, count=max(buf.size // dtype.itemsize, 1))


def _on(device, arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr)).to(device)


def _mesh_info_resources(buf: Buffer, device) -> Dict[str, torch.Tensor]:
    def parse(host):
        arr = np.frombuffer(host.tobytes(), dtype=types.MESH_INFO_DTYPE)
        return {f"mesh_{name}": _on(device, arr[field].astype(np.int32))
                for name, field in (("vertex_offset", "vertexOffset"),
                                    ("index_offset", "indexOffset"),
                                    ("uv_offset", "uvOffset"),
                                    ("normal_offset", "normalOffset"),
                                    ("material_index", "materialIndex"))}
    return buf.device("mesh_info", parse)


def _material_resources(buf: Buffer, device) -> Dict[str, torch.Tensor]:
    def parse(host):
        arr = np.frombuffer(host.tobytes(), dtype=types.MATERIAL_DTYPE)
        return {f"mat_{name}": _on(device, arr[field])
                for name, field in (("albedo", "albedo"),
                                    ("metallic", "metallic"),
                                    ("roughness", "roughness"),
                                    ("transmission", "transmission"),
                                    ("ior", "ior"),
                                    ("albedo_tex", "albedoTexIdx"),
                                    ("metallic_tex", "metallicTexIdx"),
                                    ("roughness_tex", "roughnessTexIdx"),
                                    ("normal_tex", "normalTexIdx"))}
    return buf.device("material", parse)


def _scene_props_resources(buf: Buffer, device) -> Dict[str, torch.Tensor]:
    def parse(host):
        arr = np.frombuffer(host.tobytes(),
                            dtype=types.SCENE_PROPERTIES_DTYPE)[0]
        return {
            "light_direction": _on(device, arr["lights"]["direction"]),
            "light_color": _on(device, arr["lights"]["color"]),
            "light_count": _on(device, np.int32(arr["lightCount"][0])),
        }
    return buf.device("scene_props", parse)


def _flat_f32(buf: Buffer, key: str, device) -> torch.Tensor:
    return buf.device(key, lambda host: _on(
        device, np.frombuffer(host.tobytes(), np.float32)))


def _flat_i32(buf: Buffer, key: str, device) -> torch.Tensor:
    # indices are written as uint32 (the reference's buffers) and read by
    # the shaders as int32, as make_scene_bindings gives them
    return buf.device(key, lambda host: _on(
        device, np.frombuffer(host.tobytes(), np.uint32).astype(np.int32)))


def build_resources(program: RaygenProgram, descriptor_set: Sequence[Any],
                    device=rdevice.DEFAULT) -> Dict[str, Any]:
    """Interpret positional descriptors into the shader resource dict, its
    tensors on `device` (the same keys, dtypes and values
    scene.bindings.make_scene_bindings gives for sample1's layout)."""
    device = rdevice.resolve(device)
    res: Dict[str, Any] = {"textures": None, "sampler": Sampler()}
    handles = dict(zip(program.descriptor_semantics, descriptor_set))

    for sem, handle in handles.items():
        if sem in ("rtprop", "image_scratch", "image", "top_as"):
            continue  # handled by TraceRays itself
        elif sem == "camera":
            cam = _parse_struct(handle, types.PHYSICAL_CAMERA_DTYPE)[0]
            res["camera"] = camera_mod.camera_params(cam, device)
        elif sem == "scene_props":
            res.update(_scene_props_resources(handle, device))
        elif sem == "mesh_info":
            res.update(_mesh_info_resources(handle, device))
        elif sem == "material":
            res.update(_material_resources(handle, device))
        elif sem in ("vertex", "uv", "normal"):
            res[f"{sem}_data"] = _flat_f32(handle, sem, device)
        elif sem == "index":
            res["index_data"] = _flat_i32(handle, "index", device)
        elif sem == "tex_array":
            res["textures"] = (handle.device()
                               if isinstance(handle, ImageArray) else handle)
        elif sem == "sampler":
            res["sampler"] = handle
        elif sem == "extent":
            ext = np.frombuffer(handle.read(), np.uint32)
            res["extent"] = (int(ext[0]), int(ext[1]))
        elif sem.startswith("raw:"):
            res[sem] = _flat_f32(handle, sem, device)
        else:
            raise ValueError(f"unknown descriptor semantic {sem!r}")
    return res


def TraceRays(platform: Platform,
              raygen_group_index: int,
              miss_group_index: int,
              hit_group_index: int,
              width: int,
              height: int) -> None:
    """Dispatch one frame (reference: radiance.cpp:242-267).

    Reads RTProp from the bound descriptor set, renders batchSize samples
    at depth bounces, writes the image (u8) and accumulation scratch
    buffers.  totalSamples is left untouched for the host loop.

    Unlike the reference, which accepts but ignores the three group
    indices (radiance.cpp:242-248), they are real here:
      raygen_group_index selects pipeline.modules[i] (the reference can
        only ever run modules[0], radiance.cpp:238);
      hit_group_index / miss_group_index are added to the raygen
        program's configured SBT hit offset / miss index (Vulkan-style
        additive record offsets), so (0, 0, 0) reproduces the
        reference's sample behavior exactly.
    """
    n = width * height
    with profiling.span("rdapi.trace_rays"):
        with profiling.span("rdapi.parse"):
            pipeline: Pipeline = platform.active_pipeline
            if not (0 <= raygen_group_index < len(pipeline.modules)):
                raise IndexError(
                    f"raygen group index {raygen_group_index} out of range "
                    f"for pipeline with {len(pipeline.modules)} module(s)")
            program = pipeline.modules[raygen_group_index]
            ds = platform.bound_descriptor_set
            handles = dict(zip(program.descriptor_semantics, ds))
            device = platform.device

            rtprop = _parse_struct(handles["rtprop"],
                                   types.RAY_TRACE_PROPERTIES_DTYPE)[0]
            batch = int(rtprop["batchSize"])
            depth = int(rtprop["depth"])
            debug = int(rtprop["debug"])
            total_samples = int(rtprop["totalSamples"])

            top = handles["top_as"]
            scene = (top.device_scene(device)
                     if hasattr(top, "device_scene") else top)

            res = build_resources(program, ds, device)

            scratch_buf: Buffer = handles["image_scratch"]
            if (scratch_buf.device_dirty
                    and scratch_buf.device_value is not None):
                accum = scratch_buf.device_value  # last frame's, on device
            else:
                accum = scratch_buf.device("accum", lambda host: _on(
                    device, np.frombuffer(host.tobytes(), np.float32)
                    .reshape(n, 4)[:, :3]))

        accum, image = program.tracer.render(
            scene, res, accum, total_samples, width, height,
            batch=batch, depth=depth, debug=debug,
            hit_group_offset=hit_group_index,
            miss_group_offset=miss_group_index)

        def accum_to_host(a):
            out = np.zeros((n, 4), np.float32)
            out[:, :3] = a
            return out

        scratch_buf.set_device_value(accum, to_host=accum_to_host,
                                     key="accum")
        image_buf: Buffer = handles["image"]
        image_buf.set_device_value(image)
