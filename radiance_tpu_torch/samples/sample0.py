"""Sample 0: minimal primary-ray render of a hardcoded triangle scene.

Port of samples/sample0.py (reference: samples/sample0.cpp, never
compiled there, and its bring-up program radiance/src/main.cpp
directGen/triangleHit): a hardcoded triangle, flat-color closest-hit and
miss shaders, one primary ray per pixel, 512x512 PNG out.  Runs on the
CUDA card unless `--cpu` is given:

    python -m radiance_tpu_torch.samples.sample0 [--cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from radiance_tpu_torch.api import accel
from radiance_tpu_torch.api.sbt import ShaderBindingTable
from radiance_tpu_torch.core import device as rdevice
from radiance_tpu_torch.core import types
from radiance_tpu_torch.engine.context import Payload
from radiance_tpu_torch.engine.pathtracer import WavefrontPathTracer
from radiance_tpu_torch.utils import image as image_io


def triangle_hit(ctx, payload: Payload):
    """Barycentric-colored closest hit (main.cpp triangleHit analog)."""
    n = ctx.ray_origin.shape[0]
    return payload.replace(color=ctx.bary, hit=torch.ones(
        n, dtype=torch.bool, device=ctx.ray_origin.device))


def miss_black(ctx, payload: Payload):
    n = ctx.ray_origin.shape[0]
    dev = ctx.ray_origin.device
    return payload.replace(
        color=torch.tensor([0.1, 0.1, 0.1], dtype=torch.float32,
                           device=dev).expand(n, 3),
        hit=torch.zeros(n, dtype=torch.bool, device=dev))


def direct_gen(resources, pixel_index, rand_input):
    """Pinhole rays straight down -z (main.cpp directGen analog)."""
    w, h = resources["extent"]
    x = torch.remainder(pixel_index, w).to(torch.float32)
    y = torch.div(pixel_index, w, rounding_mode="floor").to(torch.float32)
    fx = (x + 0.5) / w - 0.5
    fy = 0.5 - (y + 0.5) / h
    d = torch.stack([fx, fy, torch.full_like(fx, -1.0)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = torch.tensor([0.0, 0.0, 2.0], dtype=torch.float32,
                     device=d.device).expand(d.shape)
    return o, d


def main(size=512, out=None, device=rdevice.DEFAULT):
    """Render the triangle; returns the u8 image [size, size, 4] and
    writes it to `out` (default: sample0_output.png in
    tempfile.gettempdir())."""
    device = rdevice.resolve(device)
    verts = np.asarray([[-0.8, -0.6, 0.0], [0.8, -0.6, 0.0], [0.0, 0.9, 0.0]],
                       np.float32)
    tris = np.asarray([[0, 1, 2]], np.uint32)
    blas = accel.BuildAccelStruct(types.Mesh(verts, tris))
    tlas = accel.BuildAccelStruct([types.Instance(
        np.eye(4, dtype=np.float32), 0, 0, blas)])

    sbt = ShaderBindingTable.from_json([
        {"raygen": "raygen", "closestHit": "", "anyHit": "", "miss": ""},
        {"raygen": "", "closestHit": "triangleHit", "anyHit": "", "miss": ""},
        {"raygen": "", "closestHit": "", "anyHit": "", "miss": ""},
        {"raygen": "", "closestHit": "", "anyHit": "", "miss": "missBlack"},
    ], {"triangleHit": triangle_hit, "missBlack": miss_black})

    tracer = WavefrontPathTracer(
        ray_generator=direct_gen, sbt=sbt, tonemap=lambda x: x,
        hit_offset=1, miss_index=3)

    res = {"extent": (size, size), "sampler": None}
    accum = torch.zeros((size * size, 3), dtype=torch.float32, device=device)
    accum, image = tracer.render(tlas.device_scene(device), res, accum, 0,
                                 size, size, batch=1, depth=1)
    image = image.cpu().numpy()
    out = out or os.path.join(tempfile.gettempdir(), "sample0_output.png")
    image_io.write_image(out, image)
    print(f"sample0 wrote {out}")
    return image


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=(
        "sample0: one primary ray a pixel on a hardcoded triangle."))
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args()
    main(args.size, args.out, "cpu" if args.cpu else rdevice.DEFAULT)
