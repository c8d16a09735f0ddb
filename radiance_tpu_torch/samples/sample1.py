"""Sample 1: progressive PBR path tracer through the full RD-style API.

Port of samples/sample1.py (reference: samples/sample1.cpp:363-448
rayTracer() + render()): builds every buffer through the Platform API,
binds the 14-descriptor pipeline, and runs the progressive render loop
with host-side totalSamples accumulation control (sample1.cpp:479-490).

Scene: procedural Cornell box; `--glb <path>` loads a glTF binary scene
(or any mesh format the importers read) through the loader with its
`<path>.cache` TLAS checkpoint.  `--interactive` runs the progressive
viewer loop (tools/viewer.py: edits as stdin lines such as `camera.x 1.5`
or in a watched `--controls-file`), `--web` serves it to a browser
(tools/web_viewer.py, on `--web-port`); an edit resets totalSamples, as
the reference's ImGui path does (sample1.cpp:479-548).  Runs on the CUDA
card unless `--cpu` is given:

    python -m radiance_tpu_torch.samples.sample1 [--glb f.glb] [--cpu]
        [--interactive [--controls-file c.json] | --web [--web-port N]]
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
from radiance_tpu_torch.utils import profiling


def sample1_camera(width: int, height: int) -> types.PhysicalCamera:
    """sample1's pinhole camera (samples/sample1.py)."""
    return types.PhysicalCamera(
        width_pixel=float(width), height_pixel=float(height),
        focal_length=0.035, sensor_width=0.05, focal_distance=8.0,
        f_stop=0.0, x=0.0, y=0.0, z=4.0, wx=0.0, wy=0.0, wz=0.0)


class Sample1:
    """sample1's buffers, pipeline and descriptor set, bound on the
    platform, with the reference's render() callback (render_frame) and
    its control edits (apply_controls), so that either viewer loop can
    drive them.

    scene: a HostScene (default: the Cornell box); camera: default
    sample1_camera; device: the platform's device (default: the card, or
    the device an earlier GetPlatform call fixed).
    """

    def __init__(self, width: int = 512, height: int = 512, batch: int = 16,
                 depth: int = 4, debug: int = 0,
                 scene: procedural.HostScene = None,
                 camera: types.PhysicalCamera = None, device=None):
        self.width, self.height = width, height
        (self.plt, self.rd_rtprop, self.rd_image, self.rd_cam,
         self.rd_props) = _bind_sample1(width, height, batch, depth, debug,
                                        scene, camera, device)

    def render_frame(self, _data=None) -> np.ndarray:
        """The render() callback (sample1.cpp:455-490): trace, read the
        image [H, W, 4] u8, advance totalSamples on the host."""
        plt, w, h = self.plt, self.width, self.height
        with profiling.span("rdapi.frame"):
            pipeline.TraceRays(plt, 0, 0, 0, w, h)
            img = platform.ReadBuffer(plt, self.rd_image,
                                      self.rd_image.size).reshape(h, w, 4)
            rt = self._read(self.rd_rtprop, types.RAY_TRACE_PROPERTIES_DTYPE)
            rt["totalSamples"] += rt["batchSize"]
            platform.WriteBuffer(plt, self.rd_rtprop, 16, rt)
        return img

    def _read(self, buf, dtype) -> np.ndarray:
        return np.frombuffer(platform.ReadBuffer(self.plt, buf, buf.size),
                             dtype=dtype).copy()

    def total_samples(self) -> int:
        return int(self._read(self.rd_rtprop,
                              types.RAY_TRACE_PROPERTIES_DTYPE)
                   ["totalSamples"][0])

    def apply_controls(self, updates) -> None:
        """RenderSceneConfigUI analog (sample1.cpp:501-548): write the
        edits (camera.<field>, light.dir, light.color, debug, batch,
        depth) through the camera, scene-properties and ray-trace
        buffers and reset totalSamples, so accumulation restarts
        (sample1.cpp:482)."""
        plt = self.plt
        cam_arr = self._read(self.rd_cam, types.PHYSICAL_CAMERA_DTYPE)
        props_arr = self._read(self.rd_props, types.SCENE_PROPERTIES_DTYPE)
        rt = self._read(self.rd_rtprop, types.RAY_TRACE_PROPERTIES_DTYPE)
        cam_dirty = props_dirty = False
        for key, val in updates.items():
            scope, _, field = key.partition(".")
            if scope == "camera" and field in cam_arr.dtype.names:
                cam_arr[field] = float(val)
                cam_dirty = True
            elif scope == "light" and field == "dir":
                props_arr["lights"]["direction"][0, 0, :3] = val
                props_dirty = True
            elif scope == "light" and field == "color":
                props_arr["lights"]["color"][0, 0, :3] = val
                props_dirty = True
            elif scope in ("debug", "batch", "depth"):
                name = {"debug": "debug", "batch": "batchSize",
                        "depth": "depth"}[scope]
                rt[name] = int(val)
            else:
                print(f"(ignored control {key!r})")
                continue
            print(f"set {key} = {val}")
        if cam_dirty:
            platform.WriteBuffer(plt, self.rd_cam, self.rd_cam.size, cam_arr)
        if props_dirty:
            platform.WriteBuffer(plt, self.rd_props, self.rd_props.size,
                                 props_arr)
        rt["totalSamples"] = 0  # restart accumulation on any edit
        platform.WriteBuffer(plt, self.rd_rtprop, 16, rt)

    def controls(self) -> dict:
        """The web page's control echo: the camera's position and angles
        and the ray-trace properties, as the buffers hold them."""
        cam = self._read(self.rd_cam, types.PHYSICAL_CAMERA_DTYPE)
        rt = self._read(self.rd_rtprop, types.RAY_TRACE_PROPERTIES_DTYPE)
        out = {f"camera.{k}": float(cam[k][0])
               for k in ("x", "y", "z", "wx", "wy", "wz")}
        out.update(debug=int(rt["debug"][0]), batch=int(rt["batchSize"][0]),
                   depth=int(rt["depth"][0]))
        return out


def _bind_sample1(width, height, batch, depth, debug, scene, camera,
                  device):
    """Create and bind sample1's buffers, pipeline and descriptor set
    (sample1.cpp:363-448).  Returns the platform and the buffers the
    callbacks use: (plt, rtprop, image, camera, scene properties)."""
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
    return plt, rd_rtprop, rd_image, rd_cam, rd_props


def render_sample1(width: int = 512, height: int = 512, batch: int = 16,
                   depth: int = 4, frames: int = 4, debug: int = 0,
                   scene: procedural.HostScene = None,
                   camera: types.PhysicalCamera = None, out: str = None,
                   device=None) -> np.ndarray:
    """Build sample1 (Sample1), run `frames` progressive frames through
    TraceRays and write the last image to `out` (default: a timestamped
    PNG).  Returns the u8 image [H, W, 4]."""
    s1 = Sample1(width, height, batch, depth, debug, scene, camera, device)
    n = width * height

    # --- progressive render loop (sample1.cpp:441-490) ---
    img = None
    for frame in range(frames):
        t0 = time.time()
        img = s1.render_frame()
        dt = time.time() - t0
        rays = n * batch * depth
        print(f"frame {frame}: {dt:.3f}s  (~{rays / dt / 1e6:.2f} Mrays/s "
              f"upper bound), totalSamples={s1.total_samples()}")

    out = out or image_io.timestamped_path("sample1", "png")
    if img is not None:
        image_io.write_image(out, img)
        print(f"Writing image with extent: <{width}, {height}> -> {out}")
    return img


def run_viewer(s1: Sample1, *, web: bool, frames: int = 0, out: str = None,
               controls_file: str = None, web_port: int = 8642,
               use_stdin: bool = True, on_start=None):
    """sample1's progressive viewer (sample1.cpp:441-548): its render()
    callback in tools/web_viewer.render_loop_web (web) or
    tools/viewer.render_loop, each edit through apply_controls.  frames
    0 loops until quit.  Returns the last frame."""
    from radiance_tpu_torch.tools import viewer, web_viewer

    out = out or "sample1_progressive.png"
    if web:
        return web_viewer.render_loop_web(
            s1.render_frame, None, frames=frames, out_path=out,
            port=web_port, controls=s1.controls(),
            on_change=s1.apply_controls, on_start=on_start)
    return viewer.render_loop(
        s1.render_frame, None, frames=frames, out_path=out,
        controls=viewer.ControlChannel(use_stdin=use_stdin,
                                       watch_file=controls_file),
        on_change=s1.apply_controls)


def main(argv=None):
    ap = argparse.ArgumentParser(description=(
        "sample1: progressive PBR path tracer through the RD-style API"))
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
    ap.add_argument("--interactive", action="store_true",
                    help="progressive viewer loop (renderLoop analog); "
                         "edit camera/light/debug live via stdin lines "
                         "like 'camera.x 1.5' or a --controls-file")
    ap.add_argument("--controls-file", type=str, default=None,
                    help="JSON file watched for parameter edits")
    ap.add_argument("--web", action="store_true",
                    help="serve the progressive viewer to a browser "
                         "(the windowed-inspector analog: live frame, "
                         "camera/light/debug controls, Save button)")
    ap.add_argument("--web-port", type=int, default=8642)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    plt = platform.Platform.GetPlatform("cpu" if args.cpu else None)
    scene = None
    if args.glb:   # Scene::Load equivalent
        from radiance_tpu_torch.scene import loader
        scene = loader.load_scene(args.glb, use_cache=True,
                                  device=plt.device)
    if args.interactive or args.web:
        s1 = Sample1(args.width, args.height, args.batch, args.depth,
                     args.debug, scene=scene)
        return run_viewer(s1, web=args.web, frames=args.frames or 0,
                          out=args.out, controls_file=args.controls_file,
                          web_port=args.web_port)
    return render_sample1(args.width, args.height, args.batch, args.depth,
                          args.frames, args.debug, scene=scene, out=args.out)


if __name__ == "__main__":
    main()
