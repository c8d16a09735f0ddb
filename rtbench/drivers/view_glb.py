"""sample1's progressive viewer on a scene that a user loads from a GLB
node tree (samples/sample1.py --glb): the view driver's window, check and
control (rtbench/drivers/view.py) on an instanced scene.

Set-up takes the configuration's generator's scene(): meshes,
translations and each instance's mesh (rtbench/geometry/multi64.py).  It
writes them as a GLB, one mesh each with flat per-triangle normals
repeated per vertex, one node with a translation per instance, and the
configuration's material, into a temporary directory; then, under the
span bvh.build, loads it with scene/loader.load_scene (a BLAS per mesh,
the TLAS over the nodes, the instance-ordered bindings) and builds the
kernel tables at the configuration's leaf cap.  Sample1 binds the loaded
scene with the configuration's camera, as the view driver does.  On a
scene of MULTI_SCAN_MIN_INSTANCES or more instances every engine wave,
primary, bounce and shadow, then goes through the instance scan
(ops/stream3_multi.trace_rows_multi).

The plain reference gets the scene as one world-space mesh: every
instance's triangles moved by its translation, in instance order, with
their flat normals, under one tree of its own and no TLAS.  release
removes the GLB.

A window that closes with fewer than the mix's `min_frames` frames gives
no result: the run exits with an error before the check.  Frames here
take seconds, and a frame's time varies by about a tenth within a run,
so a rate from fewer frames spreads from run to run by more than half
its bound (a program that takes 12-18 s a frame gets 3-5 a window).
"""

import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from rtbench import harness
from rtbench.drivers import view
from rtbench.drivers.view import check, control  # noqa: F401


def _scene(run):
    """The generator's (meshes, translations, mesh_of), from the
    configuration's fixed seed; host clock under scene.generate."""
    gen = harness.load_module("geometry", run.cfg["generator"])
    with run.span("scene.generate"):
        return gen, gen.scene(run.cfg["n_tris"], run.cfg["seed"],
                              **run.cfg.get("generator_args", {}))


def write_glb(path, gen, scene, mat):
    """The scene as a GLB at `path`: one mesh each of `gen`'s meshes, with
    its flat normals repeated per vertex; one node with its translation
    per instance; the one material `mat` (a configuration's)."""
    from radiance_tpu_torch.scene import glb_writer

    meshes, translations, mesh_of = scene
    glb_writer.write_glb(
        path,
        [dict(positions=m, normals=np.repeat(gen.flat_normals(m), 3, axis=0),
              indices=np.arange(len(m), dtype=np.uint32).reshape(-1, 3),
              material=0) for m in meshes],
        [dict(baseColorFactor=mat["albedo"], metallicFactor=mat["metallic"],
              roughnessFactor=mat["roughness"],
              transmission=mat["transmission"], ior=mat["ior"])],
        nodes=[dict(mesh=int(m), translation=translations[i].tolist())
               for i, m in enumerate(mesh_of)])


def setup(run):
    from radiance_tpu_torch.api import platform
    from radiance_tpu_torch.core import types
    from radiance_tpu_torch.samples import sample1
    from radiance_tpu_torch.scene import loader

    cfg, tr, dev = run.cfg, run.traffic, run.dev
    gen, scene = _scene(run)
    folder = tempfile.mkdtemp(prefix="rtbench_glb_")
    path = os.path.join(folder, cfg["name"] + ".glb")
    with run.span("scene.write_glb"):
        write_glb(path, gen, scene, cfg["material"])
    with run.span("bvh.build"):
        host = loader.load_scene(path, verbose=False, device=dev)
        host.tlas.device_scene(dev, leaf_cap=cfg["leaf_cap"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
    w, h = tr["width"], tr["height"]
    cam = cfg["camera"]
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
    return dict(s1=s1, host=host, gen=gen, scene=scene, folder=folder,
                pixels=view._pixels(run))


def window(run, st, seconds):
    """The view driver's window, refused below min_frames frames."""
    w = view.window(run, st, seconds)
    least = run.traffic["min_frames"]
    if w["done"] < least:
        sys.exit(f"rtbench: {run.cell}: the window held {w['done']} "
                 f"frames, fewer than the mix's min_frames ({least}): too "
                 f"few for a rate within its bound; no result")
    return w


def _world(gen, scene):
    verts, tris, fn = gen.world(*scene)
    return dict(verts=verts, tris=tris, fn=fn)


def release(run, st):
    """The GLB removed, the window's frame intervals logged (a frame takes
    seconds here); then the view driver's release, with the world mesh for
    the reference."""
    shutil.rmtree(st["folder"], ignore_errors=True)
    w = run.window
    print("frame intervals (s): " + ", ".join(
        f"{x:.3f}" for x in harness.frame_intervals(w["t0"],
                                                    w["completions"])),
          file=sys.stderr, flush=True)
    st.update(_world(st["gen"], st["scene"]))
    return view.release(run, st)


def control_setup(run):
    gen, scene = _scene(run)
    return dict(_world(gen, scene), pixels=view._pixels(run))
