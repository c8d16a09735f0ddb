"""sample1's progressive viewer on the configuration's scene: a closed
loop of frames through the RD API (samples/sample1.py Sample1 and its
render callback, sample1.cpp:455-490).

Set-up builds the scene as one mesh (procedural.assemble_scene: the
SAH build, kernel tables, bindings), binds sample1's buffers, pipeline
and descriptor set with the configuration's camera and the mix's batch
and depth, renders `warmup_frames` frames and sets totalSamples back to
0, as a viewer that starts a fresh accumulation.  The window then calls
render_frame (TraceRays, the u8 image read back, totalSamples advanced
by the batch) until --seconds have passed; the accumulation is never
reset.  Each frame's u8 image is kept at `check_pixels` pixels drawn
from the seed; once the window has closed the plain reference traces
every sample of the window's frames at those pixels, `check_lanes` paths
at a time, and every frame's image is compared.  The check stops at the
first `check_frames` frames, which bounds its time in a run whose frames
come far faster than today's (48-s windows of 54-90 frames).
"""

import contextlib
import time

import numpy as np
import torch

from rtbench import check as rcheck
from rtbench import scenes
from rtbench.reference import shade as rshade


def _geometry(run):
    """The configuration's vertices and triangles, and their flat unit
    normals, one per triangle, as bench._engine_setup makes them."""
    verts, tris = scenes.geometry(run)
    t = tris.astype(np.int64)
    fn = np.cross(verts[t[:, 1]] - verts[t[:, 0]],
                  verts[t[:, 2]] - verts[t[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-9)
    return verts, tris, fn.astype(np.float32)


def _pixels(run):
    """The checked pixels, drawn from the seed over the whole image."""
    rng = np.random.default_rng(run.seed)
    n = run.traffic["width"] * run.traffic["height"]
    return rng.choice(n, size=min(run.traffic["check_pixels"], n),
                      replace=False)


def setup(run):
    from radiance_tpu_torch.api import platform
    from radiance_tpu_torch.core import types
    from radiance_tpu_torch.samples import sample1
    from radiance_tpu_torch.scene import procedural

    cfg, tr, dev = run.cfg, run.traffic, run.dev
    verts, tris, fn = _geometry(run)
    mat, light, cam = cfg["material"], cfg["view_light"], cfg["camera"]
    with run.span("bvh.build"):
        host = procedural.assemble_scene(
            [(verts, tris, np.repeat(fn, 3, axis=0), np.zeros_like(verts),
              0)],
            [types.Material(albedo=tuple(mat["albedo"]),
                            metallic=mat["metallic"],
                            roughness=mat["roughness"],
                            transmission=mat["transmission"],
                            ior=mat["ior"])],
            types.SceneProperties(lights=[types.DirLight(
                direction=(*light["direction"], 0.0),
                color=(*light["color"], 1.0))]), device=dev)
        host.tlas.device_scene(dev, leaf_cap=cfg["leaf_cap"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
    w, h = tr["width"], tr["height"]
    camera = types.PhysicalCamera(
        width_pixel=float(w), height_pixel=float(h),
        focal_length=cam["focal_length"], sensor_width=cam["sensor_width"],
        focal_distance=cam["focal_distance"], f_stop=0.0,
        x=cfg["eye"][0], y=cfg["eye"][1], z=cfg["eye"][2])
    platform.Platform._instance = None
    with run.span("rdapi.bind"):
        s1 = sample1.Sample1(w, h, tr["batch"], tr["depth"], scene=host,
                             camera=camera, device=dev)
    with run.span("warmup"):
        for _ in range(tr["warmup_frames"]):
            s1.render_frame()
        rt = s1._read(s1.rd_rtprop, types.RAY_TRACE_PROPERTIES_DTYPE)
        rt["totalSamples"] = 0
        platform.WriteBuffer(s1.plt, s1.rd_rtprop, 16, rt)
    return dict(s1=s1, host=host, verts=verts, tris=tris, fn=fn,
                pixels=_pixels(run))


@contextlib.contextmanager
def _spans(run):
    """In a traced run, host spans around the RD API's TraceRays, the
    engine's render and the image read-back (the harness's own wrappers
    of the calls a frame makes into each layer)."""
    if not run.trace:
        yield
        return
    from radiance_tpu_torch.api import pipeline, platform
    from radiance_tpu_torch.engine import pathtracer

    sites = [(pipeline, "TraceRays", "rdapi.trace_rays"),
             (platform, "ReadBuffer", "rdapi.read_back"),
             (pathtracer.WavefrontPathTracer, "render", "engine.render")]
    orig = [getattr(m, a) for m, a, _ in sites]

    def wrap(fn, name):
        def inner(*a, **k):
            with run.span(name):
                return fn(*a, **k)
        return inner

    try:
        for (m, a, name), fn in zip(sites, orig):
            setattr(m, a, wrap(fn, name))
        yield
    finally:
        for (m, a, _), fn in zip(sites, orig):
            setattr(m, a, fn)


def window(run, st, seconds):
    s1, px = st["s1"], st["pixels"]
    done, st["kept"] = [], []
    with _spans(run):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with run.span("frame"):
                img = s1.render_frame()
            done.append(time.perf_counter())
            st["kept"].append(img.reshape(-1, 4)[px, :3])
    tr = run.traffic
    return dict(window_s=done[-1] - t0, done=len(done), unit="frames",
                t0=t0, completions=done,
                samples=tr["width"] * tr["height"] * tr["batch"] * len(done))


def release(run, st):
    """The program's images at the checked pixels, on the host; then the
    program's state goes."""
    from radiance_tpu_torch.api import platform

    frames = st["s1"].total_samples() // run.traffic["batch"]
    platform.Platform._instance = None
    return dict(u8=np.stack(st["kept"]).astype(np.float32), frames=frames,
                pixels=st["pixels"], verts=st["verts"], tris=st["tris"],
                fn=st["fn"])


def _reference(run, k, frames, dtype):
    cfg, tr = run.cfg, run.traffic
    tree = scenes.reference_tree(run, k["verts"], k["tris"], dtype)
    cam = dict(cfg["camera"], eye=cfg["eye"])
    ref = rshade.Frames(tree, torch.from_numpy(k["fn"]).to(run.dev),
                        tr["width"], tr["height"], cam, cfg["view_light"],
                        cfg["material"], tr["depth"], dtype=dtype)
    return ref.images(torch.from_numpy(k["pixels"]).to(run.dev), frames,
                      tr["batch"], tr["check_lanes"])


def check(run, k, limits):
    if k["frames"] != run.window["done"] or k["frames"] == 0:
        return False, [("frames_accumulated", k["frames"],
                        run.window["done"])]
    f = min(k["frames"], run.traffic["check_frames"])
    u8_r = _reference(run, k, f, torch.float32)
    return rcheck.judge_view(torch.from_numpy(k["u8"][:f]).to(run.dev), u8_r,
                             limits)


def control_setup(run):
    verts, tris, fn = _geometry(run)
    return dict(verts=verts, tris=tris, fn=fn, pixels=_pixels(run))


def control(run, k, limits):
    """The reference one precision lower (bfloat16) in the program's
    place, over control_frames frames, judged against float32."""
    f = run.traffic["control_frames"]
    u8_r = _reference(run, k, f, torch.float32)
    u8_l = _reference(run, k, f, torch.bfloat16)
    correct, numbers = rcheck.judge_view(u8_l, u8_r, limits)
    return correct, numbers, f
