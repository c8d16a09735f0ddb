"""Sample 1: progressive PBR path tracer through the full RD-style API.

Port of samples/sample1.py (reference: samples/sample1.cpp:363-448
rayTracer() + render()): builds every buffer through the Platform API,
binds the 14-descriptor pipeline, and runs the progressive render loop
with host-side totalSamples accumulation control (sample1.cpp:479-490).

Scene: procedural Cornell box; `--glb <path>` loads a glTF binary scene
(or any mesh format the importers read) through the loader with its
`<path>.cache` TLAS checkpoint.  Runs on the CUDA card unless `--cpu`
is given:

    python -m radiance_tpu_torch.samples.sample1 [--glb f.glb] [--cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from radiance_tpu_torch.api import pipeline, platform
from radiance_tpu_torch.core import types
from radiance_tpu_torch.engine import programs
from radiance_tpu_torch.scene import procedural
from radiance_tpu_torch.utils import image as image_io


def sample1_camera(width: int, height: int) -> types.PhysicalCamera:
    """sample1's pinhole camera (samples/sample1.py)."""
    return types.PhysicalCamera(
        width_pixel=float(width), height_pixel=float(height),
        focal_length=0.035, sensor_width=0.05, focal_distance=8.0,
        f_stop=0.0, x=0.0, y=0.0, z=4.0, wx=0.0, wy=0.0, wz=0.0)


def render_sample1(width: int = 512, height: int = 512, batch: int = 16,
                   depth: int = 4, frames: int = 4, debug: int = 0,
                   scene: procedural.HostScene = None,
                   camera: types.PhysicalCamera = None, out: str = None,
                   device=None) -> np.ndarray:
    """Build sample1's buffers, pipeline and descriptor set, run `frames`
    progressive frames through TraceRays and write the last image to
    `out` (default: a timestamped PNG).  Returns the u8 image [H, W, 4].

    scene: a HostScene (default: the Cornell box); camera: default
    sample1_camera; device: the platform's device (default: the card, or
    the device an earlier GetPlatform call fixed).
    """
    plt = platform.Platform.GetPlatform(device)
    if scene is None:
        scene = procedural.cornell_box(light_dir=(0.3, -1.0, -0.4),
                                       light_intensity=3.0, verbose=True,
                                       device=plt.device)
    cam = camera or sample1_camera(width, height)

    # --- camera + frame properties, written through the buffer API ---
    rtprop = types.RayTraceProperties(
        total_samples=0, batch_size=batch, depth=depth, debug=debug)
    props = types.SceneProperties(lights=[types.DirLight(
        direction=(0.3, -1.0, -0.4, 0.0), color=(3.0, 3.0, 3.0, 1.0))])

    n = width * height
    rd_rtprop = platform.CreateBuffer(plt, 16)
    platform.WriteBuffer(plt, rd_rtprop, 16, rtprop.to_numpy())
    rd_image = platform.CreateImage(plt, width, height)
    rd_scratch = platform.CreateBuffer(plt, n * 4 * 4)
    rd_cam = platform.CreateBuffer(plt, types.PHYSICAL_CAMERA_DTYPE.itemsize)
    platform.WriteBuffer(plt, rd_cam, rd_cam.size, cam.to_numpy())
    rd_props = platform.CreateBuffer(plt, types.SCENE_PROPERTIES_DTYPE.itemsize)
    platform.WriteBuffer(plt, rd_props, rd_props.size, props.to_numpy())

    mesh_infos = np.concatenate([m.to_numpy().reshape(1)
                                 for m in scene.mesh_infos])
    rd_mesh_info = platform.CreateBuffer(plt, mesh_infos.nbytes)
    platform.WriteBuffer(plt, rd_mesh_info, mesh_infos.nbytes, mesh_infos)
    mats = np.concatenate([m.to_numpy().reshape(1) for m in scene.materials])
    rd_mats = platform.CreateBuffer(plt, mats.nbytes)
    platform.WriteBuffer(plt, rd_mats, mats.nbytes, mats)

    def flat_buffer(arr):
        arr = np.ascontiguousarray(arr)
        buf = platform.CreateBuffer(plt, arr.nbytes)
        platform.WriteBuffer(plt, buf, arr.nbytes, arr)
        return buf

    res = scene.resources
    rd_vertex = flat_buffer(res["vertex_data"].cpu().numpy())
    rd_index = flat_buffer(res["index_data"].cpu().numpy().astype(np.uint32))
    rd_uv = flat_buffer(res["uv_data"].cpu().numpy())
    rd_normal = flat_buffer(res["normal_data"].cpu().numpy())
    # the scene's textures, or no image array where it has none: the
    # reference binds a 4x4 placeholder layer here, which drops a GLB's
    # textures and, since no material selects it, only makes the shaders
    # sample it (measured in chip_smoke.py phase [8])
    textures = res.get("textures")
    rd_textures = None
    if textures is not None:
        tex = textures.cpu().numpy()
        rd_textures = platform.CreateImageArray(plt, tex.shape[2],
                                                tex.shape[1], tex.shape[0])
        for i, layer in enumerate(tex):
            platform.WriteImage(plt, rd_textures, tex.shape[2],
                                tex.shape[1], i, layer)
    rd_sampler = platform.CreateSampler(plt, 2, 1)

    # --- pipeline (sample1.cpp:387-407) ---
    shader = pipeline.CreateShaderModule(plt, programs.sample1_program())
    pl = pipeline.CreatePipeline({
        "maxRayRecursionDepth": 1,
        "layout": pipeline.CreatePipelineLayout(
            [pipeline.BUFFER_TYPE] * 11 + [pipeline.TEX_ARRAY_TYPE,
                                           pipeline.IMAGE_SAMPLER_TYPE,
                                           pipeline.ACCEL_STRUCT_TYPE]),
        "modules": [shader],
    })
    desc = pipeline.CreateDescriptorSet([
        rd_rtprop, rd_scratch, rd_image, rd_cam, rd_props,
        rd_mesh_info, rd_vertex, rd_index, rd_uv, rd_normal, rd_mats,
        rd_textures, rd_sampler, scene.tlas])
    pipeline.BindPipeline(plt, pl)
    pipeline.BindDescriptorSet(plt, desc)

    # --- progressive render loop (sample1.cpp:441-490) ---
    img = None
    for frame in range(frames):
        t0 = time.time()
        # the render() callback (sample1.cpp:455-490): trace, read the
        # image, advance totalSamples on the host
        pipeline.TraceRays(plt, 0, 0, 0, width, height)
        img = platform.ReadBuffer(plt, rd_image, rd_image.size).reshape(
            height, width, 4)
        rt = np.frombuffer(platform.ReadBuffer(plt, rd_rtprop, 16),
                           dtype=types.RAY_TRACE_PROPERTIES_DTYPE).copy()
        rt["totalSamples"] += rt["batchSize"]
        platform.WriteBuffer(plt, rd_rtprop, 16, rt)
        dt = time.time() - t0
        rays = n * batch * depth
        print(f"frame {frame}: {dt:.3f}s  (~{rays / dt / 1e6:.2f} Mrays/s "
              f"upper bound), totalSamples={int(rt['totalSamples'][0])}")

    out = out or image_io.timestamped_path("sample1", "png")
    if img is not None:
        image_io.write_image(out, img)
        print(f"Writing image with extent: <{width}, {height}> -> {out}")
    return img


def main(argv=None):
    ap = argparse.ArgumentParser(description=(
        "sample1: progressive PBR path tracer through the RD-style API. "
        "The reference's --interactive and --web viewers need "
        "tools/viewer.py and tools/web_viewer.py, which are not ported; "
        "they are left out."))
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--debug", type=int, default=0)
    ap.add_argument("--glb", type=str, default=None,
                    help="load this scene (with its <path>.cache TLAS "
                         "checkpoint) instead of the Cornell box")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    plt = platform.Platform.GetPlatform("cpu" if args.cpu else None)
    scene = None
    if args.glb:   # Scene::Load equivalent
        from radiance_tpu_torch.scene import loader
        scene = loader.load_scene(args.glb, use_cache=True,
                                  device=plt.device)
    return render_sample1(args.width, args.height, args.batch, args.depth,
                          args.frames, args.debug, scene=scene, out=args.out)


if __name__ == "__main__":
    main()
