"""radiance_tpu_torch's bounded progressive frames vs radiance_tpu's.

The port of tests/test_engine.py:207-390 on WavefrontPathTracer(tbound=
True): the bounded render equals the unbounded one across two render
calls (the per-tracer store carries the bounds, total_samples == 0 resets
them), every slot == -2 ray that _traced_wavefront receives is re-traced
exactly before the slot clamp (one instance: the packet kernel; many
instances: the packet sweeps), two tracers keep their own bounds, the
store evicts its oldest entry, a sample stops bouncing once no path is
alive, and the bounded image of the closed box holds the JAX engine's
RADIANCE_ENGINE_TBOUND=1 image (its monolithic frame, the stream3 primary
in interpret mode) to tests/test_golden.py's bar: u8 RMSE < 3.0 at
depth 2.  Each package builds its own scene from the same numpy
geometry; the port runs the plain versions of its kernels on the CPU.

Bars: bounded against unbounded accumulations to tests/test_engine.py's
rtol 1e-4 atol 1e-5 (the bounds are exact, so the port's are equal), u8
images equal; traces against an exact tracer on hits exactly and t to
rtol 2e-3 atol 1e-4 (tests/test_engine.py:317's).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.api.sbt import ShaderBindingTable as JSBT
from radiance_tpu.core import types as jtypes
from radiance_tpu.engine import shaders as jshaders
from radiance_tpu.engine.pathtracer import WavefrontPathTracer as JTracer
from radiance_tpu.ops import traversal
from radiance_tpu.scene import procedural as jproc
from radiance_tpu.shading import camera as jcam

from radiance_tpu_torch.api.sbt import ShaderBindingTable as TSBT
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.engine import pathtracer as tpath
from radiance_tpu_torch.engine import shaders as tshaders
from radiance_tpu_torch.ops import packet_trace as tpk
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops import stream3_multi as tsm
from radiance_tpu_torch.ops.intersect import FLT_MAX
from radiance_tpu_torch.scene import procedural as tproc
from radiance_tpu_torch.shading import camera as tcam

from test_torch_stream3 import _one_torch_thread  # noqa: F401
from test_torch_stream3_multi import _render_inputs, scene_pair
from test_torch_stream3_tlas import tlas_geometry

TMIN, TMAX = 1e-3, 1e3
FMAX32 = np.float32(FLT_MAX)


def box_meshes(proc):
    """tests/test_engine.py:220-236: the Cornell walls merged into one
    mesh (one instance, so stream3.supports holds)."""
    quads = [
        proc._quad([-5, -5, 0], [5, -5, 0], [5, -5, -10], [-5, -5, -10]),
        proc._quad([-5, 5, -10], [5, 5, -10], [5, 5, 0], [-5, 5, 0]),
        proc._quad([-5, -5, -10], [5, -5, -10], [5, 5, -10], [-5, 5, -10]),
        proc._quad([-5, -5, 0], [-5, -5, -10], [-5, 5, -10], [-5, 5, 0]),
        proc._quad([5, -5, -10], [5, -5, 0], [5, 5, 0], [5, 5, -10]),
    ]
    vs, ts_, ns, uvs = [], [], [], []
    off = 0
    for v, t, nrm, uv in quads:
        vs.append(v)
        ts_.append(t + off)
        ns.append(nrm)
        uvs.append(uv)
        off += len(v)
    return [(np.concatenate(vs), np.concatenate(ts_).astype(np.uint32),
             np.concatenate(ns), np.concatenate(uvs), 0)]


def camera(w, z=4.0):
    return dict(width_pixel=float(w), height_pixel=float(w),
                focal_length=0.035, sensor_width=0.05, focal_distance=8.0,
                f_stop=0.0, x=0.0, y=0.0, z=z, wx=0.0, wy=0.0, wz=0.0)


def port_box(meshes=None, w=32, z=4.0):
    """(DeviceScene, resources) of the port on the CPU."""
    mat = ttypes.Material(albedo=(0.7, 0.7, 0.7, 1.0), roughness=0.8)
    props = ttypes.SceneProperties(lights=[ttypes.DirLight(
        direction=(0.3, -1.0, 0.4, 0.0), color=(3.0, 3.0, 3.0, 1.0))])
    host = tproc.assemble_scene(meshes or box_meshes(tproc), [mat], props,
                                device="cpu")
    res = dict(host.resources)
    res["camera"] = tcam.camera_params(ttypes.PhysicalCamera(**camera(w, z)),
                                       "cpu")
    return host.device_scene("cpu"), res


def port_tracer(**kw):
    return tpath.WavefrontPathTracer(
        ray_generator=tcam.physical_camera_raygen,
        sbt=TSBT.from_json(tshaders.DEFAULT_SBT_RECORDS,
                           tshaders.SHADER_REGISTRY), **kw)


def two_frames(tracer, ds, res, w, batch=2, depth=2):
    acc = torch.zeros(w * w, 3)
    acc, _ = tracer.render(ds, res, acc, 0, w, w, batch=batch, depth=depth)
    return tracer.render(ds, res, acc, batch, w, w, batch=batch, depth=depth)


def rmse(a, b):
    a = np.asarray(a)[..., :3].astype(np.float64)
    b = np.asarray(b)[..., :3].astype(np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def test_bounded_render_matches_unbounded_and_jax(monkeypatch):
    """tests/test_engine.py:207-268: two frames of 2 samples, bounded and
    unbounded, the same accumulation; the bounded image against the JAX
    engine's bounded image (RADIANCE_ENGINE_TBOUND=1, its stream3 primary
    forced in interpret mode, bounces and shadows on its walk)."""
    w = 32
    ds, res = port_box(w=w)
    acc0, img0 = two_frames(port_tracer(), ds, res, w)
    assert float(acc0.std()) > 0.01             # a real image
    acc1, img1 = two_frames(port_tracer(tbound=True), ds, res, w)
    np.testing.assert_allclose(acc1.numpy(), acc0.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(img1, img0)

    monkeypatch.setenv("RADIANCE_ENGINE_TBOUND", "1")
    monkeypatch.setenv("RADIANCE_ENGINE_STREAM3", "force")
    monkeypatch.setenv("RADIANCE_ENGINE_BOUNCE", "xla")
    monkeypatch.setenv("RADIANCE_ENGINE_SHADOW", "xla")
    mat = jtypes.Material(albedo=(0.7, 0.7, 0.7, 1.0), roughness=0.8)
    props = jtypes.SceneProperties(lights=[jtypes.DirLight(
        direction=(0.3, -1.0, 0.4, 0.0), color=(3.0, 3.0, 3.0, 1.0))])
    host = jproc.assemble_scene(box_meshes(jproc), [mat], props)
    jres = dict(host.resources)
    jres["camera"] = jcam.camera_params(jtypes.PhysicalCamera(**camera(w)))
    jt = JTracer(ray_generator=jcam.physical_camera_raygen,
                 sbt=JSBT.from_json(jshaders.DEFAULT_SBT_RECORDS,
                                    jshaders.SHADER_REGISTRY))
    jds = host.device_scene()
    jacc = jnp.zeros((w * w, 3), jnp.float32)
    jacc, _ = jt.render(jds, jres, jacc, 0, w, w, batch=2, depth=2)
    jacc, jimg = jt.render(jds, jres, jacc, 2, w, w, batch=2, depth=2)
    assert rmse(img1.numpy(), jimg) < 3.0
    np.testing.assert_allclose(float(acc1.mean()), float(jnp.mean(jacc)),
                               rtol=0.05)


def test_bounds_carry_across_renders_and_reset(monkeypatch):
    """Sample 0 of a frame with total_samples == 0 is unbounded (FLT_MAX);
    each later sample takes block_bound_from_t of the previous one's
    primary t, also across render calls through the tracer's store; a
    frame at total_samples 0 resets them."""
    w = 16
    ds, res = port_box(w=w)
    seen = []
    real = ts3.trace_rows_stream3

    def spy(*a, blk_bound=None, **kw):
        rec = real(*a, blk_bound=blk_bound, **kw)
        seen.append((blk_bound.clone(), rec.t.clone()))
        return rec

    monkeypatch.setattr(ts3, "trace_rows_stream3", spy)
    tr = port_tracer(tbound=True)
    acc = torch.zeros(w * w, 3)
    acc, _ = tr.render(ds, res, acc, 0, w, w, batch=2, depth=1)
    acc, _ = tr.render(ds, res, acc, 2, w, w, batch=1, depth=1)
    tr.render(ds, res, acc, 0, w, w, batch=1, depth=1)
    assert len(seen) == 4
    nb = w * w // 128
    assert (seen[0][0] == FLT_MAX).all() and seen[0][0].shape == (nb,)
    for (_, t_prev), (bound, _) in zip(seen[:2], seen[1:3]):
        assert torch.equal(bound, ts3.block_bound_from_t(t_prev))
        assert (bound < FLT_MAX).all()          # a closed box: all hits
    assert (seen[3][0] == FLT_MAX).all()
    assert list(tr._tb_store) == [(id(ds), nb)]
    assert tr._tb_store[(id(ds), nb)][0] is ds


def test_tbound_store_is_per_tracer_and_bounded():
    """tests/test_engine.py:325-390: two tracers on the same scene and
    resolution with different cameras keep their own bounds (each
    bounded accumulation equals its own unbounded one); and the store
    keeps at most _TB_CAP scenes, the oldest evicted."""
    w = 16
    v, t, nrm, uv = tproc._quad([-6, -6, -8], [6, -6, -8], [6, 6, -8],
                                [-6, 6, -8])
    meshes = [(v, t.astype(np.uint32), nrm, uv, 0)]
    ds, res_a = port_box(meshes, w, 4.0)
    res_b = dict(res_a)
    res_b["camera"] = tcam.camera_params(
        ttypes.PhysicalCamera(**camera(w, -1.0)), "cpu")
    ref_a = two_frames(port_tracer(), ds, res_a, w)[0]
    ref_b = two_frames(port_tracer(), ds, res_b, w)[0]
    assert float((ref_a - ref_b).abs().max()) > 1e-3
    tr_a, tr_b = port_tracer(tbound=True), port_tracer(tbound=True)
    acc_a = acc_b = torch.zeros(w * w, 3)
    # interleaved, so each render would see the other's bounds if shared
    for ts in (0, 2):
        acc_a, _ = tr_a.render(ds, res_a, acc_a, ts, w, w, batch=2, depth=2)
        acc_b, _ = tr_b.render(ds, res_b, acc_b, ts, w, w, batch=2, depth=2)
    np.testing.assert_allclose(acc_a.numpy(), ref_a.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(acc_b.numpy(), ref_b.numpy(), rtol=1e-4,
                               atol=1e-5)

    scenes = [port_box(meshes, 8)[0] for _ in range(tpath.WavefrontPathTracer
                                                    ._TB_CAP + 1)]
    for s in scenes:
        tr_a.render(s, res_a, torch.zeros(64, 3), 0, 8, 8, batch=1, depth=1)
    assert len(tr_a._tb_store) == tr_a._TB_CAP
    assert [v[0] for v in tr_a._tb_store.values()] == scenes[1:]


def quad_wave():
    """tests/test_engine.py:282-304: a quad at z = -6 and 1024 rays from
    the origin aimed at it."""
    v, t, nrm, uv = tproc._quad([-5, -5, -6], [5, -5, -6], [5, 5, -6],
                                [-5, 5, -6])
    n = 1024
    rng = np.random.default_rng(3)
    o = np.zeros((n, 3), np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [(v, t.astype(np.uint32), nrm, uv, 0)], o, d


def test_residual_overflow_retraced_in_traced_wavefront(monkeypatch):
    """tests/test_engine.py:271-322: a bound of 0.5 on every block (far
    below the true t ~6) with TB_RES_RAYS at 8: trace_rows_stream3 marks
    all but 8 rays slot == -2, and _traced_wavefront re-traces them
    exactly before its slot clamp: the hits of the JAX walk, no slot
    below -1."""
    monkeypatch.setattr(ts3, "TB_RES_RAYS", 8)
    meshes, o, d = quad_wave()
    ds, _ = port_box(meshes)
    jmat = jtypes.Material(albedo=(0.7, 0.7, 0.7, 1.0), roughness=0.8)
    jds = jproc.assemble_scene(
        [(meshes[0][0], meshes[0][1], meshes[0][2], meshes[0][3], 0)],
        [jmat], jtypes.SceneProperties()).device_scene()
    ref = traversal.trace_rays(jds, jnp.asarray(o), jnp.asarray(d), TMIN, TMAX)
    bad = torch.full((1024 // 128,), 0.5)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    alive = torch.ones(1024, dtype=torch.bool)
    raw = ts3.trace_rows_stream3(ds, ts3.rows_from_aos(to, td), TMIN, TMAX,
                                 live=alive, blk_bound=bad)
    assert (raw.slot == -2).sum() > 100         # the cap really overflowed
    got = tpath._traced_wavefront(ds, to, td, TMIN, TMAX, alive,
                                  route="stream3", blk_bound=bad)
    t_ref = np.asarray(ref.t)
    hr = t_ref < FMAX32
    assert hr.sum() > 100
    t_got = got.t.numpy()
    np.testing.assert_array_equal(t_got < FMAX32, hr)
    np.testing.assert_allclose(t_got[hr], t_ref[hr], rtol=2e-3, atol=1e-4)
    assert (got.slot >= -1).all()
    np.testing.assert_array_equal(got.prim.numpy()[hr],
                                  np.asarray(ref.prim)[hr])


@pytest.mark.parametrize("route", ["scan", "native"])
def test_many_instance_residual_overflow_retraced(monkeypatch, route):
    """The same on a 9-instance scene: _traced_wavefront with a bound
    traces the wave in pixel order through trace_rows_multi (on either
    multi_route), and every ray past the residual's cap comes back with
    the packet sweeps' hit; dead lanes (NaN) miss."""
    monkeypatch.setattr(ts3, "TB_RES_RAYS", 8)
    _, tds = scene_pair(tlas_geometry())
    n = 1024
    ij = np.arange(n)
    d = np.stack([((ij % 32) / 32.0 - 0.5) * 1.4,
                  ((ij // 32) / 32.0 - 0.5) * 1.4, np.full(n, -1.0)],
                 -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.float32([[0.0, 0.0, 20.0]]), (n, 1))
    alive = np.random.default_rng(4).random(n) > 0.2
    o_in = o.copy()
    o_in[~alive] = np.nan
    to, td = torch.from_numpy(o_in), torch.from_numpy(d)
    ta = torch.from_numpy(alive)
    bad = torch.full((n // 128,), 0.5)
    raw = tsm.trace_rows_multi(tds, tsm.multi_tables(tds),
                               ts3.rows_from_aos(to, td), TMIN, TMAX,
                               live=ta, native=route == "native",
                               blk_bound=bad)
    assert (raw.slot == -2).sum() > 100
    got = tpath._traced_wavefront(tds, to, td, TMIN, TMAX, ta,
                                  route="argsort", multi_route=route,
                                  blk_bound=bad)
    ref = tpk.trace_rays_packet_multi(tds, torch.from_numpy(o), td, TMIN,
                                      TMAX)
    assert (got.slot >= -1).all()
    assert (got.t.numpy()[~alive] == FMAX32).all()
    hr = ref.hit.numpy() & alive
    assert hr.sum() > 100
    np.testing.assert_array_equal(got.hit.numpy()[alive],
                                  ref.hit.numpy()[alive])
    np.testing.assert_allclose(got.t.numpy()[hr], ref.t.numpy()[hr],
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got.slot[torch.from_numpy(hr)],
                       ref.slot[torch.from_numpy(hr)])


def test_bounce_loop_stops_once_no_path_is_alive(monkeypatch):
    """frame_fn's early exit (reference :572-575): a camera that sees no
    geometry kills every path on the primary wave, so a bounded frame
    traces one wave a sample, the unbounded staged frame depth waves, and
    both give the same image."""
    w = 16
    ds, res = port_box(w=w, z=-20.0)             # behind the box, facing away
    calls = []
    real = tpath._sample_step

    def spy(*a, **kw):
        calls.append(a[5])                       # the bounce index
        return real(*a, **kw)

    monkeypatch.setattr(tpath, "_sample_step", spy)
    out = {}
    for tb in (False, True):
        calls.clear()
        out[tb] = port_tracer(tbound=tb).render(
            ds, res, torch.zeros(w * w, 3), 0, w, w, batch=2, depth=3)
        out[tb] = out[tb] + (list(calls),)
    assert out[False][2] == [0, 1, 2, 0, 1, 2]
    assert out[True][2] == [0, 0]
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])


def test_many_instance_bounded_render_matches_unbounded():
    """A 9-instance scene under tbound: its primaries go through the
    bounded scan in pixel order, and give the accumulation of the
    unbounded frames (primaries argsorted) to the bars above, the images
    to u8 RMSE < 0.5."""
    w = 32
    _, (tds, tres) = _render_inputs(9, 80, 5, w)
    acc0, img0 = two_frames(port_tracer(), tds, tres, w)
    acc1, img1 = two_frames(port_tracer(tbound=True), tds, tres, w)
    assert float(acc0.std()) > 0.01
    np.testing.assert_allclose(acc1.numpy(), acc0.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert rmse(img1.numpy(), img0.numpy()) < 0.5
