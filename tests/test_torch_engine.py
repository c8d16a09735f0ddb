"""The whole slice: radiance_tpu_torch's render vs radiance_tpu's.

The port's WavefrontPathTracer.render (on CPU tensors: the plain
versions of the packet kernel and of the stream3 kernels) against the
JAX engine's staged scheduler (RADIANCE_ENGINE_STAGED=1) at the same
seeds, batch=2, depth 1 and 2.  Here the Cornell box at 32x32 (7
instances: per-instance sweeps); test_torch_engine_city.py runs a
20k-triangle cut of the bench's city (single instance: the port's
primary wave through stream3, its shadows live-masked, argsorted
bounces) at 64x64 with the same check.  Each package builds its own scene from
the same geometry.  The bar is the golden tests' (tests/test_golden.py
:384, :396): u8 RMSE < 2.0 at depth 1 and < 3.0 at depth 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.api import accel as jaccel
from radiance_tpu.api.sbt import ShaderBindingTable as JSBT
from radiance_tpu.core import types as jtypes
from radiance_tpu.engine import shaders as jshaders
from radiance_tpu.engine.pathtracer import WavefrontPathTracer as JTracer
from radiance_tpu.scene import bindings as jbind
from radiance_tpu.scene import procedural as jproc
from radiance_tpu.shading import camera as jcam

from radiance_tpu_torch.api import accel as taccel
from radiance_tpu_torch.api.sbt import ShaderBindingTable as TSBT
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.engine import shaders as tshaders
from radiance_tpu_torch.engine.pathtracer import WavefrontPathTracer as TTracer
from radiance_tpu_torch.scene import bindings as tbind
from radiance_tpu_torch.scene import procedural as tproc
from radiance_tpu_torch.shading import camera as tcam

import bench

RMSE_BAR = {1: 2.0, 2: 3.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version runs thousands of tiny ops per wave; with the
    parallel test runner's processes sharing the cores, torch's
    intra-op thread pool only adds contention.  One thread, restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tracers():
    jt = JTracer(ray_generator=jcam.physical_camera_raygen,
                 sbt=JSBT.from_json(jshaders.DEFAULT_SBT_RECORDS,
                                    jshaders.SHADER_REGISTRY))
    tt = TTracer(ray_generator=tcam.physical_camera_raygen,
                 sbt=TSBT.from_json(tshaders.DEFAULT_SBT_RECORDS,
                                    tshaders.SHADER_REGISTRY))
    return jt, tt


def _camera(w, h, z, focal_distance):
    return dict(width_pixel=float(w), height_pixel=float(h),
                focal_length=0.035, sensor_width=0.05,
                focal_distance=focal_distance, f_stop=0.0,
                x=0.0, y=0.0, z=z, wx=0.0, wy=0.0, wz=0.0)


def _cornell(w, h):
    cam = _camera(w, h, 4.0, 8.0)
    jhost = jproc.cornell_box()
    jres = dict(jhost.resources)
    jres["camera"] = jcam.camera_params(jtypes.PhysicalCamera(**cam))
    thost = tproc.cornell_box(device="cpu")
    tres = dict(thost.resources)
    tres["camera"] = tcam.camera_params(ttypes.PhysicalCamera(**cam), "cpu")
    return (jhost.device_scene(), jres), (thost.device_scene("cpu"), tres)


def _city(w, h):
    """bench._engine_setup's bindings on a 20k-triangle city cut."""
    verts, tris = bench.scene_geometry("city", n_tris=20_000)
    tris = tris.astype(np.uint32)
    fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                  verts[tris[:, 2]] - verts[tris[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-9)
    normals = np.repeat(fn, 3, axis=0).astype(np.float32)
    uvs = np.zeros_like(verts)
    cam = _camera(w, h, 140.0, 80.0)
    out = []
    # the JAX package places arrays itself; the port is asked for the CPU
    for accel, types, bind, camera, dev in (
            (jaccel, jtypes, jbind, jcam, {}),
            (taccel, ttypes, tbind, tcam, {"device": "cpu"})):
        blas = accel.BuildBottomAccelStruct(types.Mesh(verts, tris))
        inst = types.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)
        ds = accel.BuildTopAccelStruct([inst]).device_scene(**dev)
        mats = [types.Material(albedo=(0.7, 0.7, 0.7, 1.0), roughness=0.6)]
        props = types.SceneProperties(lights=[types.DirLight(
            direction=(0.26726124, 0.8017837, 0.5345225, 0.0),
            color=(3.0, 3.0, 3.0, 1.0))])
        res = bind.make_scene_bindings([types.MeshInfo()], verts, tris, uvs,
                                       normals, mats, props, **dev)
        res["camera"] = camera.camera_params(types.PhysicalCamera(**cam),
                                             **dev)
        out.append((ds, res))
    return out


def check_render(monkeypatch, tracers, inputs, w, depth):
    """Render both packages' scenes and hold the port to the JAX image."""
    monkeypatch.setenv("RADIANCE_ENGINE_STAGED", "1")
    (jds, jres), (tds, tres) = inputs
    jt, tt = tracers
    n = w * w
    jacc, jimg = jt.render(jds, jres, jnp.zeros((n, 3), jnp.float32), 0,
                           w, w, batch=2, depth=depth)
    tacc, timg = tt.render(tds, tres, torch.zeros(n, 3), 0, w, w,
                           batch=2, depth=depth)
    assert timg.shape == (w, w, 4) and timg.dtype == torch.uint8
    assert torch.isfinite(tacc).all()
    ref = np.asarray(jimg)[..., :3].astype(np.float64)
    got = timg.numpy()[..., :3].astype(np.float64)
    assert got.std() > 1.0                      # not a constant image
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    assert rmse < RMSE_BAR[depth], rmse
    np.testing.assert_allclose(float(tacc.mean()), float(jnp.mean(jacc)),
                               rtol=0.05)


@pytest.mark.parametrize("depth", [1, 2])
def test_cornell_render_matches_jax(monkeypatch, tracers, depth):
    check_render(monkeypatch, tracers, _cornell(32, 32), 32, depth)
