"""radiance_tpu_torch's RD-style API vs radiance_tpu's.

The port's Platform, buffers, pipeline and TraceRays on the CPU: the
four buffer-level contracts of tests/test_api.py (image filled, scratch
progressive with totalSamples left to the host, a camera write changes
the image, the raygen group index selects the module) at 32x32, batch
2, depth 2; build_resources against make_scene_bindings (keys, dtypes,
values); the TLAS file round trip in both directions between the
packages; the cache-loaded device scene against the built one; the
RD-route sample1 image against the JAX package's RD route (u8 RMSE <
3.0 at depth 2, the tests/test_golden.py bar); gen_sbt's generated
module; the platform's device rule (refit: test_torch_refit.py).
"""

import dataclasses
import importlib.util
import types as pytypes

import numpy as np
import pytest
import torch

from radiance_tpu.api import accel as jaccel
from radiance_tpu.api import pipeline as jpipeline
from radiance_tpu.api import platform as jplatform
from radiance_tpu.bvh import serialize as jserialize
from radiance_tpu.core import types as jtypes
from radiance_tpu.engine import programs as jprograms
from radiance_tpu.scene import procedural as jproc

from radiance_tpu_torch.api import accel as taccel
from radiance_tpu_torch.api import pipeline as tpipeline
from radiance_tpu_torch.api import platform as tplatform
from radiance_tpu_torch.bvh import device as tdevice
from radiance_tpu_torch.bvh import serialize as tserialize
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.engine import programs as tprograms
from radiance_tpu_torch.samples import sample1 as tsample1
from radiance_tpu_torch.scene import loader as tloader
from radiance_tpu_torch.scene import procedural as tproc
from radiance_tpu_torch.shading import camera as tcamera
from radiance_tpu_torch.tools import gen_sbt
from radiance_tpu_torch.utils.image import rmse

from test_loader import two_mesh_glb
from test_torch_scene_io import assert_same

W = H = 32
JAX = pytypes.SimpleNamespace(platform=jplatform, pipeline=jpipeline,
                              programs=jprograms, types=jtypes)
TORCH = pytypes.SimpleNamespace(platform=tplatform, pipeline=tpipeline,
                                programs=tprograms, types=ttypes)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernel versions run thousands of tiny ops a wave; with
    the parallel test runner's processes sharing the cores, torch's
    intra-op thread pool only adds contention.  One thread, restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_platform(monkeypatch):
    """Each test makes its own port Platform singleton."""
    monkeypatch.setattr(tplatform.Platform, "_instance", None)


def camera(pkg, **kw):
    return pkg.types.PhysicalCamera(
        width_pixel=float(W), height_pixel=float(H), focal_length=0.035,
        sensor_width=0.05, focal_distance=8.0, f_stop=0.0, z=4.0, **kw)


def wire(pkg, plt, scene, batch=2, depth=2):
    """sample1's buffers, pipeline and descriptor set, through either
    package's API (the wiring of tests/test_api.py)."""
    P, T = pkg.platform, pkg.types
    n = W * H
    rd = {}

    def buf(name, size, data=None):
        rd[name] = P.CreateBuffer(plt, size)
        if data is not None:
            P.WriteBuffer(plt, rd[name], size, data)
        return rd[name]

    def flat(name, arr):
        arr = np.ascontiguousarray(arr)
        return buf(name, arr.nbytes, arr)

    buf("rtprop", 16, T.RayTraceProperties(0, batch, depth, 0).to_numpy())
    rd["image"] = P.CreateImage(plt, W, H)
    buf("scratch", n * 16)
    buf("cam", T.PHYSICAL_CAMERA_DTYPE.itemsize,
        camera(pkg).to_numpy())
    props = T.SceneProperties(lights=[T.DirLight(
        direction=(0.3, -1.0, -0.4, 0.0), color=(3.0, 3.0, 3.0, 1.0))])
    buf("props", T.SCENE_PROPERTIES_DTYPE.itemsize, props.to_numpy())
    flat("mesh_info", np.concatenate([m.to_numpy().reshape(1)
                                      for m in scene.mesh_infos]))
    flat("mats", np.concatenate([m.to_numpy().reshape(1)
                                 for m in scene.materials]))
    res = scene.resources
    flat("vertex", np.asarray(res["vertex_data"]))
    flat("index", np.asarray(res["index_data"]).astype(np.uint32))
    flat("uv", np.asarray(res["uv_data"]))
    flat("normal", np.asarray(res["normal_data"]))
    tex = P.CreateImageArray(plt, 4, 4, 1)
    sampler = P.CreateSampler(plt, 2, 1)
    shader = pkg.pipeline.CreateShaderModule(plt,
                                             pkg.programs.sample1_program())
    pl = pkg.pipeline.CreatePipeline({"maxRayRecursionDepth": 1,
                                      "layout": [], "modules": [shader]})
    desc = pkg.pipeline.CreateDescriptorSet([
        rd["rtprop"], rd["scratch"], rd["image"], rd["cam"], rd["props"],
        rd["mesh_info"], rd["vertex"], rd["index"], rd["uv"], rd["normal"],
        rd["mats"], tex, sampler, scene.tlas])
    pkg.pipeline.BindPipeline(plt, pl)
    pkg.pipeline.BindDescriptorSet(plt, desc)
    return dict(rd, plt=plt, desc=desc, program=shader)


def read_image(pkg, w):
    return pkg.platform.ReadBuffer(w["plt"], w["image"],
                                   w["image"].size).reshape(H, W, 4).copy()


def set_total_samples(pkg, w, value=None):
    """Advance totalSamples by batchSize (value None) or set it."""
    P, T = pkg.platform, pkg.types
    rt = np.frombuffer(P.ReadBuffer(w["plt"], w["rtprop"], 16),
                       dtype=T.RAY_TRACE_PROPERTIES_DTYPE).copy()
    rt["totalSamples"] = (rt["totalSamples"] + rt["batchSize"]
                          if value is None else value)
    P.WriteBuffer(w["plt"], w["rtprop"], 16, rt)
    return int(rt["totalSamples"][0])


@pytest.fixture(scope="module")
def wired():
    saved = tplatform.Platform._instance
    tplatform.Platform._instance = None
    try:
        plt = tplatform.Platform.GetPlatform("cpu")
        yield wire(TORCH, plt, tproc.cornell_box(device="cpu"))
    finally:
        tplatform.Platform._instance = saved


def test_trace_rays_fills_image(wired):
    tpipeline.TraceRays(wired["plt"], 0, 0, 0, W, H)
    img = read_image(TORCH, wired)
    assert img[..., 3].min() == 255
    assert img[..., :3].std() > 3  # actual content


def test_scratch_progressive_and_total_samples_contract(wired):
    plt, scratch = wired["plt"], wired["scratch"]
    rt = np.frombuffer(tplatform.ReadBuffer(plt, wired["rtprop"], 16),
                       dtype=ttypes.RAY_TRACE_PROPERTIES_DTYPE)
    assert int(rt["totalSamples"][0]) == 0  # TraceRays must NOT touch it
    # the accumulator stays on the device until a read syncs it
    assert scratch.device_dirty and scratch.device_value.shape == (W * H, 3)
    scratch1 = np.frombuffer(tplatform.ReadBuffer(plt, scratch, scratch.size),
                             np.float32).reshape(-1, 4).copy()
    assert not scratch.device_dirty
    assert np.abs(scratch1[:, :3]).max() > 0  # accumulation written back
    np.testing.assert_array_equal(scratch1[:, :3],
                                  scratch.device_value.numpy())

    set_total_samples(TORCH, wired)
    tpipeline.TraceRays(plt, 0, 0, 0, W, H)
    scratch2 = np.frombuffer(tplatform.ReadBuffer(plt, scratch, scratch.size),
                             np.float32).reshape(-1, 4).copy()
    assert not np.allclose(scratch1[:, :3], scratch2[:, :3])


def test_camera_update_changes_image(wired):
    plt = wired["plt"]
    img1 = read_image(TORCH, wired)
    tplatform.WriteBuffer(plt, wired["cam"], wired["cam"].size,
                          camera(TORCH, wy=np.pi).to_numpy())
    set_total_samples(TORCH, wired, 0)  # the UI resets on edits
    tpipeline.TraceRays(plt, 0, 0, 0, W, H)
    assert not np.array_equal(img1, read_image(TORCH, wired))


def test_raygen_group_index_selects_module(wired):
    plt = wired["plt"]

    def far_raygen(resources, pixel_index, rand_input):
        n = pixel_index.shape[0]
        o = torch.full((n, 3), 1e6)  # far outside the scene
        d = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
        return o, d

    tplatform.WriteBuffer(plt, wired["cam"], wired["cam"].size,
                          camera(TORCH).to_numpy())
    alt = tprograms.sample1_program()
    alt.tracer.ray_generator = far_raygen
    tpipeline.BindPipeline(plt, tpipeline.CreatePipeline({
        "maxRayRecursionDepth": 1, "layout": [],
        "modules": [wired["program"], alt]}))
    try:
        set_total_samples(TORCH, wired, 0)
        tpipeline.TraceRays(plt, 0, 0, 0, W, H)
        img0 = read_image(TORCH, wired)
        set_total_samples(TORCH, wired, 0)
        tpipeline.TraceRays(plt, 1, 0, 0, W, H)
        img1 = read_image(TORCH, wired)
        assert not np.array_equal(img0, img1)
        rgb1 = img1.reshape(-1, 4)[:, :3]
        assert (rgb1 == rgb1[0]).all()  # every ray of module 1 misses
        with pytest.raises(IndexError):
            tpipeline.TraceRays(plt, 2, 0, 0, W, H)
    finally:
        tpipeline.BindPipeline(plt, tpipeline.CreatePipeline({
            "maxRayRecursionDepth": 1, "layout": [],
            "modules": [wired["program"]]}))


def _assert_res_equal(direct, rd):
    """make_scene_bindings' dict against build_resources': every key of
    the direct dict (the RD dict adds the camera), same dtypes and
    values."""
    assert set(rd) - set(direct) == {"camera"}
    for k, v in direct.items():
        if k == "sampler":
            assert rd[k] == v
        else:
            assert_same(v, rd[k], k)


@pytest.mark.parametrize("kind", ["cornell", "textured_glb"])
def test_build_resources_equals_make_scene_bindings(tmp_path, kind,
                                                    fresh_platform):
    if kind == "cornell":   # sample1's light
        scene = tproc.cornell_box(light_dir=(0.3, -1.0, -0.4), device="cpu")
    else:
        scene = tloader.load_scene(two_mesh_glb(tmp_path), tex_dim=16,
                                   verbose=False, device="cpu")
    captured = {}
    orig = tpipeline.build_resources

    def capture(*a, **k):
        captured["res"] = orig(*a, **k)
        return captured["res"]

    tpipeline.build_resources = capture
    try:
        tsample1.render_sample1(W, H, 1, 1, 1, scene=scene,
                                out=str(tmp_path / "s1.png"), device="cpu")
    finally:
        tpipeline.build_resources = orig
    res = captured["res"]
    _assert_res_equal(scene.resources, res)
    # the camera parsed from its buffer as the dataclass gives it
    cam = tsample1.sample1_camera(W, H)
    for k, v in tcamera.camera_params(cam, "cpu").items():
        assert_same(v, res["camera"][k], f"camera.{k}")


def _random_instances(types_mod, accel_mod):
    """Three instances of two random BLASes, with distinct transforms,
    SBT offsets and custom ids."""
    rng = np.random.default_rng(5)
    out, blases = [], []
    for b in range(2):
        c = rng.uniform(-3, 3, (40, 3)).astype(np.float32)
        v = (c[:, None, :] + rng.normal(scale=0.3, size=(40, 3, 3))
             .astype(np.float32)).reshape(-1, 3)
        t = np.arange(120, dtype=np.uint32).reshape(-1, 3)
        blases.append(accel_mod.BuildBottomAccelStruct(types_mod.Mesh(v, t)))
    for i in range(3):
        tf = np.eye(4, dtype=np.float32)
        tf[:3, 3] = [4.0 * i, 0.5 * i, 0.0]
        out.append(types_mod.Instance(tf, i % 2, 7 + i, blases[i % 2]))
    return out


def _parsed_equal(a, b):
    assert a.blob == b.blob
    assert_same(a.nodes, b.nodes, "nodes")
    assert_same(a.instances, b.instances, "instances")
    assert a.blas.keys() == b.blas.keys()
    for k in a.blas:
        assert_same(a.blas[k], b.blas[k], f"blas[{k}]")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tlas_file_round_trip_between_packages(tmp_path, writer):
    """A TLAS file written by one package loads in the other, with equal
    parsed arrays and an equal device scene."""
    jt = jaccel.BuildTopAccelStruct(_random_instances(jtypes, jaccel))
    tt = taccel.BuildTopAccelStruct(_random_instances(ttypes, taccel))
    assert jt.blob == tt.blob
    path = str(tmp_path / "tlas.bin")
    if writer == "jax":
        jaccel.TopAccelStructToFile(jt, path)
    else:
        taccel.TopAccelStructToFile(tt, path)
    _parsed_equal(jserialize.tlas_from_file(path),
                  tserialize.tlas_from_file(path))
    jl = jaccel.FileToTopAccelStruct(path)
    tl = taccel.FileToTopAccelStruct(path)
    assert jl.blob == tl.blob == tt.blob
    assert tl.tlas_capacity == jl.tlas_capacity == tt.tlas_capacity
    js = jl.device_scene()
    ts = tl.device_scene("cpu")
    for f in ("node_packed", "bundle_packed", "inst_transform", "inst_inv",
              "inst_id", "inst_custom", "inst_sbt", "inst_blas_root"):
        assert_same(np.asarray(getattr(js, f)), getattr(ts, f), f)
    for jk, tk in zip(js.kblas, ts.kblas):
        for a, b in zip(jk, tk):
            assert_same(np.asarray(a), b, "kblas")
    assert tuple(js.inst_kblas) == ts.inst_kblas


def _scene_fields(scene):
    return {f.name: getattr(scene, f.name)
            for f in dataclasses.fields(scene) if f.name != "multi"}


@pytest.mark.parametrize("stable", [True, False])
def test_file_loaded_device_scene_equals_built(tmp_path, stable):
    """FileToTopAccelStruct makes its device scene lazily, padded to the
    same capacity, equal to the built TLAS's tensor for tensor; the two
    entry points of bvh/device agree with them."""
    insts = _random_instances(ttypes, taccel)
    built = taccel.BuildTopAccelStruct(insts)
    path = str(tmp_path / "tlas.bin")
    taccel.TopAccelStructToFile(built, path)
    loaded = taccel.FileToTopAccelStruct(path)
    assert not loaded._scenes           # nothing made before it is asked
    a = built.device_scene("cpu", stable_frames=stable)
    b = loaded.device_scene("cpu", stable_frames=stable)
    assert a.node_packed.shape[0] >= built.tlas_capacity
    assert_same(_scene_fields(a), _scene_fields(b), "device scene")
    # the entry points build without the TLAS padding
    c = tdevice.device_scene_from_instances(insts, device="cpu")
    d = tdevice.device_scene_from_tlas_blob(built.blob, device="cpu")
    assert_same(_scene_fields(c), _scene_fields(d), "entry points")


def test_rd_sample1_matches_jax_rd_route(tmp_path, fresh_platform):
    """render_sample1 (the port's RD route) against the JAX package's RD
    route on the same Cornell box and camera: 32x32, batch 2, depth 2,
    two frames."""
    timg = tsample1.render_sample1(W, H, batch=2, depth=2, frames=2,
                                   out=str(tmp_path / "t.png"), device="cpu")
    w = wire(JAX, jplatform.Platform.GetPlatform(),
             jproc.cornell_box(light_dir=(0.3, -1.0, -0.4)))
    for _ in range(2):
        jpipeline.TraceRays(w["plt"], 0, 0, 0, W, H)
        set_total_samples(JAX, w)
    jimg = read_image(JAX, w)
    err = rmse(timg[..., :3], jimg[..., :3])
    assert err < 3.0, f"RD route u8 RMSE {err:.3f}"


def test_gen_sbt_module_builds_an_sbt(tmp_path):
    import json

    with open("samples/sbt.json") as f:
        records = json.load(f)
    path = tmp_path / "sbt_generated.py"
    path.write_text(gen_sbt.generate(records))
    spec = importlib.util.spec_from_file_location("sbt_generated", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.RECORDS == records
    from radiance_tpu_torch.engine import shaders
    sbt = mod.build(shaders.SHADER_REGISTRY)
    assert [(r.raygen, r.closest_hit, r.any_hit, r.miss)
            for r in sbt.records] == [
        (r.get("raygen", ""), r.get("closestHit", ""), r.get("anyHit", ""),
         r.get("miss", "")) for r in records]
    with pytest.raises(KeyError):
        mod.build({})


def test_platform_device_rule(fresh_platform, monkeypatch):
    """GetPlatform() defaults to the card and raises without one; the
    first call fixes the device and a later call naming another raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplatform.Platform.GetPlatform()
    plt = tplatform.Platform.GetPlatform("cpu")
    assert plt.device == torch.device("cpu")
    assert tplatform.Platform.GetPlatform() is plt
    assert tplatform.Platform.GetPlatform("cpu") is plt
    with pytest.raises(RuntimeError):
        tplatform.Platform.GetPlatform("cuda")
    arr = tplatform.CreateImageArray(plt, 4, 4, 2)
    assert arr.device().device == torch.device("cpu")
