"""Standard raygen programs: prebuilt pipelines matching the reference samples.

Port of radiance_tpu/engine/programs.py.  The reference's shader.cl /
shader2.cl megakernels define a descriptor layout + camera + shading
set; these factories assemble the equivalent RaygenProgram from the
framework pieces.
"""

from __future__ import annotations

from typing import Callable

import torch

from radiance_tpu_torch.api.pipeline import RaygenProgram
from radiance_tpu_torch.api.sbt import ShaderBindingTable
from radiance_tpu_torch.core import math as rmath
from radiance_tpu_torch.engine import shaders as builtin_shaders
from radiance_tpu_torch.engine.pathtracer import WavefrontPathTracer
from radiance_tpu_torch.ops import tonemap as tonemap_ops
from radiance_tpu_torch.shading import camera as camera_mod

# sample1's 14-descriptor layout (reference: samples/sample1.cpp:387-395,
# shader.cl:175-190)
SAMPLE1_LAYOUT = [
    "rtprop", "image_scratch", "image", "camera", "scene_props",
    "mesh_info", "vertex", "index", "uv", "normal", "material",
    "tex_array", "sampler", "top_as",
]

# sample2's layout (reference: samples/sample2.cpp:509-540, shader2.cl:32-46)
SAMPLE2_LAYOUT = [
    "rtprop", "image_scratch", "image", "extent", "raw:camera",
    "vertex", "normal", "uv", "index", "material", "scene_props",
    "tex_array", "sampler", "top_as",
]


def _program(ray_generator, layout, sbt_records, shader_registry, tonemap,
             tmin, tmax) -> RaygenProgram:
    sbt = ShaderBindingTable.from_json(
        sbt_records or builtin_shaders.DEFAULT_SBT_RECORDS,
        {**builtin_shaders.SHADER_REGISTRY, **(shader_registry or {})})
    tracer = WavefrontPathTracer(
        ray_generator=ray_generator, sbt=sbt, tonemap=tonemap,
        hit_offset=1, miss_index=3, tmin=tmin, tmax=tmax)
    return RaygenProgram(tracer=tracer, descriptor_semantics=layout)


def sample1_program(sbt_records=None, shader_registry=None,
                    tonemap: Callable = tonemap_ops.tonemap_sample1,
                    tmin: float = 0.001, tmax: float = 1000.0) -> RaygenProgram:
    """The sample1 pipeline: physical camera + PBR shader set + ACES."""
    return _program(camera_mod.physical_camera_raygen, SAMPLE1_LAYOUT,
                    sbt_records, shader_registry, tonemap, tmin, tmax)


def _sample2_raygen(resources, pixel_index, rand_input):
    """sample2's rotating pinhole camera (reference: shader2.cl:62-82).

    camData = [x, y, z, theta] floats (res["raw:camera"], f32 [4]); extent
    from the extent buffer.  Everything stays float32.
    """
    w, h = resources["extent"]
    cam = resources["raw:camera"]
    random = rmath.pcg3d(rand_input)
    x = torch.remainder(pixel_index, w).to(torch.float32)
    y = torch.div(pixel_index, w, rounding_mode="floor").to(torch.float32)
    fx = (x + random[..., 0]) / w - 0.5
    fy = 0.5 - (y + random[..., 1]) / h
    d = rmath.normalize(torch.stack(
        [fx, fy, torch.full_like(fx, -2.0)], dim=-1))
    theta = cam[3]
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    c0 = torch.stack([torch.cos(theta), zero, -torch.sin(theta)])
    c1 = torch.stack([zero, one, zero])
    c2 = torch.stack([torch.sin(theta), zero, torch.cos(theta)])
    d = d[..., 0:1] * c0 + d[..., 1:2] * c1 + d[..., 2:3] * c2
    origin = cam[:3].expand(d.shape)
    return origin, d


def sample2_program(sbt_records=None, shader_registry=None,
                    tonemap: Callable = tonemap_ops.tonemap_sample2,
                    tmin: float = 0.01, tmax: float = 1000.0) -> RaygenProgram:
    """The sample2 pipeline: rotating pinhole + simple BRDF shading +
    Reinhard (reference: samples/sample2.cpp + shader2.cl)."""
    return _program(_sample2_raygen, SAMPLE2_LAYOUT, sbt_records,
                    shader_registry, tonemap, tmin, tmax)
