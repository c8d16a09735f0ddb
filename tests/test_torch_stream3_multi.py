"""radiance_tpu_torch's many-instance stream path vs radiance_tpu's.

MultiTables, the TLAS-level block cull and trace_rows_multi of the port
(the plain versions of the stream3 kernels on the CPU) against the JAX
module (ops/stream3_multi.py), against the JAX two-level traversal walk
(an exact oracle), and the port engine's route and images against the JAX
engine's.  Each package builds its own scene from the same numpy geometry
(tests/test_stream3_multi.py's scenes, made from the same seeds).

Bars (tests/test_stream3_multi.py's own, :47-58): hit/miss equal on every
ray not poisoned (slot != -2), t rtol 2e-3 atol 1e-4 where both hit (the
instance transforms round differently in the two walks), poisoned share
< 0.05.  The JAX instance scan itself, in interpret mode, is held on one
small case: hit agreement >= 0.999 and the same poisoned rays.  Images:
the golden tests' bars, u8 RMSE < 2.0 (depth 1) and < 3.0 (depth 2).
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
from radiance_tpu.ops import stream3 as js3
from radiance_tpu.ops import stream3_multi as jsm
from radiance_tpu.ops import traversal
from radiance_tpu.ops.intersect import FLT_MAX
from radiance_tpu.scene import procedural as jproc
from radiance_tpu.shading import camera as jcam

from radiance_tpu_torch.api import accel as taccel
from radiance_tpu_torch.api.sbt import ShaderBindingTable as TSBT
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.engine import pathtracer as tpath
from radiance_tpu_torch.engine import shaders as tshaders
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops import stream3_multi as tsm
from radiance_tpu_torch.scene import procedural as tproc
from radiance_tpu_torch.shading import camera as tcam

from test_torch_stream3 import _one_torch_thread  # noqa: F401

TMIN, TMAX = 1e-3, 1e3
RMSE_BAR = {1: 2.0, 2: 3.0}


def multi_geometry(n_inst=5, tris_per=120, seed=4):
    """tests/test_stream3_multi.py::_multi_scene's meshes and transforms
    (one mesh per instance), from the same seed."""
    rng = np.random.default_rng(seed)
    meshes, tfs = [], []
    for _ in range(n_inst):
        centers = rng.uniform(-2, 2, size=(tris_per, 3)).astype(np.float32)
        offs = rng.normal(scale=0.3, size=(tris_per, 3, 3)).astype(np.float32)
        meshes.append((centers[:, None, :] + offs).reshape(-1, 3))
        tf = np.eye(4, dtype=np.float32)
        tf[:3, 3] = rng.uniform(-8, 8, 3)
        tfs.append(tf)
    return meshes, tfs, list(range(n_inst))


def two_copies_geometry():
    """tests/test_stream3_multi.py:136-154: two instances of one BLAS and
    one of another."""
    def verts_of(seed, tris=90):
        r = np.random.default_rng(seed)
        centers = r.uniform(-2, 2, size=(tris, 3)).astype(np.float32)
        offs = r.normal(scale=0.3, size=(tris, 3, 3)).astype(np.float32)
        return (centers[:, None, :] + offs).reshape(-1, 3)

    tfs = []
    for x in (-6.0, 6.0, 0.0):
        tf = np.eye(4, dtype=np.float32)
        tf[0, 3] = x
        tfs.append(tf)
    return [verts_of(1), verts_of(2)], tfs, [0, 0, 1]


def scene_pair(geom):
    """(JAX DeviceScene, port DeviceScene on the CPU) of one geometry."""
    meshes, tfs, which = geom
    out = []
    for accel, types, kw in ((jaccel, jtypes, {}),
                             (taccel, ttypes, {"device": "cpu"})):
        blases = [accel.BuildBottomAccelStruct(types.Mesh(
            v, np.arange(len(v), dtype=np.uint32).reshape(-1, 3)))
            for v in meshes]
        insts = [types.Instance(tf, 0, i, blases[w])
                 for i, (tf, w) in enumerate(zip(tfs, which))]
        out.append(accel.BuildTopAccelStruct(insts).device_scene(**kw))
    return tuple(out)


@pytest.fixture(scope="module")
def five():
    return scene_pair(multi_geometry())


def random_wave(seed, n):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def camera_wave(n, w, z):
    """n rays from (0, 0, z) through a w-wide grid, looking down -z."""
    ij = np.arange(n)
    d = np.stack([(ij % w) / w - 0.5, (ij // w) / (n / w) - 0.5,
                  np.full(n, -1.0)], -1).astype(np.float32)
    o = np.tile(np.float32([[0.0, 0.0, z]]), (n, 1))
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def aimed_wave(seed, n, tfs):
    """n rays from random origins toward points near random instances'
    centres (most of them hit)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    c = np.stack(tfs)[rng.integers(0, len(tfs), n), :3, 3]
    d = (c + rng.uniform(-2, 2, (n, 3)) - o).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def trows(o, d):
    return ts3.rows_from_aos(torch.from_numpy(o), torch.from_numpy(d))


def hold_multi(rec, ref_t, ref_slot, live=None):
    """The JAX tests' bars; returns the poisoned share."""
    t, slot = rec.t.numpy(), rec.slot.numpy()
    ok = slot != -2
    if live is not None:
        ok &= live
    hr, hg = np.asarray(ref_t) < FLT_MAX, t < FLT_MAX
    assert (hr[ok] == hg[ok]).all()
    both = hr & hg & ok
    assert both.sum() >= 20
    np.testing.assert_allclose(t[both], np.asarray(ref_t)[both], rtol=2e-3,
                               atol=1e-4)
    close = both & (np.abs(t - np.asarray(ref_t)) < 1e-5)
    assert (slot[close] == np.asarray(ref_slot)[close]).mean() > 0.98
    return 1.0 - (slot != -2).mean()


# ----------------------------------------------------------- tables

@pytest.mark.parametrize("geom", ["five", "two_copies"])
def test_multi_tables_match_jax(geom):
    jds, tds = scene_pair(multi_geometry() if geom == "five"
                          else two_copies_geometry())
    ref, got = jsm.MultiTables(jds), tsm.MultiTables(tds)
    assert len(got.uniq) == ref.nodef.shape[0] == (5 if geom == "five"
                                                   else 2)
    np.testing.assert_array_equal(got.inst_idx, np.asarray(ref.inst_idx))
    assert got.aabb_w.tobytes() == np.asarray(ref.aabb_w).tobytes()
    assert torch.equal(got.aabb_dev, torch.from_numpy(got.aabb_w))
    assert tsm.supports(tds) and got.ninst == ref.ninst
    # one build per scene object, kept on the scene
    assert tds.multi is None
    assert tsm.multi_tables(tds) is tsm.multi_tables(tds) is tds.multi


@pytest.mark.parametrize("masked", [False, True])
def test_block_overlap_matches_jax(five, masked):
    jds, tds = five
    # a coherent camera packet (its blocks overlap some instances) and a
    # random one (every block overlaps every instance)
    o, d = random_wave(2, 2 * js3.PKT)
    o[:js3.PKT], d[:js3.PKT] = camera_wave(js3.PKT, 32, 30.0)
    live = (np.random.default_rng(3).uniform(size=len(o)) < 0.4
            if masked else None)
    ref = jsm._block_overlap(js3.rows_from_aos(jnp.asarray(o),
                                               jnp.asarray(d)),
                             jsm.MultiTables(jds).aabb_w, TMIN, TMAX,
                             live=None if live is None
                             else jnp.asarray(live))
    got = tsm._block_overlap(trows(o, d), tsm.MultiTables(tds).aabb_dev,
                             TMIN, TMAX, live=None if live is None
                             else torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.05 < got.float().mean() < 0.95


# ----------------------------------------------------------- traces

@pytest.mark.parametrize("occl", [False, True])
@pytest.mark.parametrize("case", ["random", "live"])
def test_trace_rows_multi_matches_traversal(five, case, occl):
    """test_stream3_multi.py's oracle cases (:30-58, and :88-124 with a
    30% dead live mask whose dead lanes hold NaN origins)."""
    jds, tds = five
    n = 1024 if case == "random" else 2 * js3.PKT
    o, d = random_wave(1 if case == "random" else 8, n)
    live = None
    o_in = o
    if case == "live":
        live = np.random.default_rng(8).random(n) > 0.3
        o_in = o.copy()
        o_in[~live] = np.nan
    ref = traversal.trace_rays(jds, jnp.asarray(o), jnp.asarray(d), TMIN,
                               TMAX, any_hit_terminate=occl)
    rec, diag = tsm.trace_rows_multi(
        tds, tsm.MultiTables(tds), trows(o_in, d), TMIN, TMAX, occl=occl,
        live=None if live is None else torch.from_numpy(live),
        with_diag=True)
    if occl:
        assert np.isin(rec.t.numpy(), [0.0, np.float32(FLT_MAX)]).all()
        ok = rec.slot.numpy() != -2
        if live is not None:
            ok &= live
        hr = np.asarray(ref.t) < FLT_MAX
        assert ((rec.t.numpy() < FLT_MAX) == hr)[ok].all() and hr[ok].any()
        poisoned = 1.0 - (rec.slot.numpy() != -2).mean()
    else:
        poisoned = hold_multi(rec, ref.t, ref.slot, live)
    assert poisoned < 0.05 and diag["poisoned"] == round(poisoned * n)
    if live is not None:
        assert (rec.t.numpy()[~live] == np.float32(FLT_MAX)).all()
    assert diag["instances_run"] == 5 and diag["pairs"] > 0


def test_trace_rows_multi_matches_jax_scan():
    """One small scan (3 instances, 1024 rays) against the JAX instance
    scan with its Pallas kernels in interpret mode."""
    geom = multi_geometry(n_inst=3, tris_per=60, seed=12)
    jds, tds = scene_pair(geom)
    o, d = aimed_wave(5, 1024, geom[1])
    ref = jsm.trace_rows_multi(jds, jsm.MultiTables(jds),
                               js3.rows_from_aos(jnp.asarray(o),
                                                 jnp.asarray(d)),
                               TMIN, TMAX, precision="f32", interpret=True)
    got = tsm.trace_rows_multi(tds, tsm.MultiTables(tds), trows(o, d), TMIN,
                               TMAX)
    hr, hg = np.asarray(ref.t) < FLT_MAX, got.t.numpy() < FLT_MAX
    assert (hr == hg).mean() >= 0.999 and hg.sum() >= 20
    np.testing.assert_array_equal(got.slot.numpy() == -2,
                                  np.asarray(ref.slot) == -2)
    both = hr & hg
    assert (got.slot.numpy()[both] == np.asarray(ref.slot)[both]).mean() \
        >= 0.999


def test_overflowed_blocks_are_poisoned(five):
    """A block past an instance's bcap list is poisoned, never a silent
    miss: slot -2 with t FLT_MAX on every ray of it."""
    _, tds = five
    lo, hi = tsm.multi_tables(tds).aabb_w[0].reshape(2, 3)
    o = np.tile(np.float32([[(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2,
                             40.0]]), (3 * 8192, 1))
    d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (3 * 8192, 1))
    rec, diag = tsm.trace_rows_multi(tds, tsm.MultiTables(tds), trows(o, d),
                                     TMIN, TMAX, bcap_blocks=1,
                                     with_diag=True)
    # 192 identical blocks overlap instance 0: the first 64 fit
    bad = rec.slot.numpy() == -2
    assert bad.sum() == diag["poisoned"] == 128 * 128
    assert (rec.t.numpy()[bad] == np.float32(FLT_MAX)).all()
    assert (rec.prim.numpy()[bad] == -1).all()


# ----------------------------------------------------------- engine

def _render_inputs(n_inst, tris_per, seed, w):
    """The same scene, bindings and camera in both packages: one mesh per
    instance (procedural.assemble_scene), three materials."""
    meshes, tfs, _ = multi_geometry(n_inst, tris_per, seed)
    parts = []
    for v in meshes:
        tris = np.arange(len(v), dtype=np.uint32).reshape(-1, 3)
        fn = np.cross(v[tris[:, 1]] - v[tris[:, 0]], v[tris[:, 2]] - v[tris[:, 0]])
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-9)
        parts.append((v, tris, np.repeat(fn, 3, axis=0).astype(np.float32),
                      np.zeros_like(v)))
    cam = dict(width_pixel=float(w), height_pixel=float(w),
               focal_length=0.035, sensor_width=0.05, focal_distance=30.0,
               f_stop=0.0, x=0.0, y=0.0, z=30.0, wx=0.0, wy=0.0, wz=0.0)
    out = []
    for proc, types, camera, kw in ((jproc, jtypes, jcam, {}),
                                    (tproc, ttypes, tcam, {"device": "cpu"})):
        mats = [types.Material(albedo=(0.7, 0.7, 0.7, 1.0), roughness=0.6),
                types.Material(albedo=(0.8, 0.3, 0.2, 1.0), roughness=0.4),
                types.Material(albedo=(0.9, 0.9, 0.9, 1.0), metallic=1.0,
                               roughness=0.2)]
        props = types.SceneProperties(lights=[types.DirLight(
            direction=(0.26726124, 0.8017837, 0.5345225, 0.0),
            color=(3.0, 3.0, 3.0, 1.0))])
        host = proc.assemble_scene(
            [p + (i % 3,) for i, p in enumerate(parts)], mats, props,
            transforms=tfs, **kw)
        res = dict(host.resources)
        res["camera"] = camera.camera_params(types.PhysicalCamera(**cam),
                                             **kw)
        out.append((host.device_scene(**kw), res))
    return out


def test_engine_dispatch_takes_the_scan_above_8_instances(monkeypatch):
    """The port's _trace_dispatch sends closest-hit and shadow traces of a
    9-instance scene through trace_rows_multi (occl for shadows), and
    keeps the per-instance sweeps for the 7-instance Cornell box."""
    calls = []
    real = tsm.trace_rows_multi

    def spy(*a, occl=False, **kw):
        calls.append(occl)
        return real(*a, occl=occl, **kw)

    monkeypatch.setattr(tsm, "trace_rows_multi", spy)
    _, tds = scene_pair(multi_geometry(n_inst=9, tris_per=40, seed=6))
    # rays straight down onto instance 0's box: one sub-wave runs
    lo, hi = tsm.multi_tables(tds).aabb_w[0].reshape(2, 3)
    xy = np.random.default_rng(0).uniform(lo[:2], hi[:2], (256, 2))
    o = torch.from_numpy(np.c_[xy, np.full(256, 40.0)].astype(np.float32))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(256, 3).contiguous()
    hits = {}
    for any_hit in (False, True):
        hits[any_hit] = tpath._trace_dispatch(tds, o, d, TMIN, TMAX,
                                              any_hit_terminate=any_hit).hit
    assert calls == [False, True]
    assert torch.equal(hits[False], hits[True]) and hits[False].any()
    cornell = tproc.cornell_box(device="cpu").device_scene("cpu")
    assert len(cornell.inst_kblas) == 7
    tpath._trace_dispatch(cornell, o, d, TMIN, TMAX)
    tpath._trace_dispatch(cornell, o, d, TMIN, TMAX, any_hit_terminate=True)
    assert calls == [False, True]


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_image_matches_jax_on_9_instances(monkeypatch, depth):
    """The 9-instance scene at 64x64: the port's image (every trace
    through the instance scan: closest hits and shadows) against the JAX
    engine's at the same seeds."""
    monkeypatch.setenv("RADIANCE_ENGINE_STAGED", "1")
    calls = []
    real = tsm.trace_rows_multi

    def spy(*a, occl=False, **kw):
        calls.append(occl)
        return real(*a, occl=occl, **kw)

    monkeypatch.setattr(tsm, "trace_rows_multi", spy)
    w = 64
    (jds, jres), (tds, tres) = _render_inputs(9, 40, 6, w)
    assert len(tds.inst_kblas) == 9 and tsm.supports(tds)
    jt = JTracer(ray_generator=jcam.physical_camera_raygen,
                 sbt=JSBT.from_json(jshaders.DEFAULT_SBT_RECORDS,
                                    jshaders.SHADER_REGISTRY))
    tt = tpath.WavefrontPathTracer(
        ray_generator=tcam.physical_camera_raygen,
        sbt=TSBT.from_json(tshaders.DEFAULT_SBT_RECORDS,
                           tshaders.SHADER_REGISTRY))
    n = w * w
    jacc, jimg = jt.render(jds, jres, jnp.zeros((n, 3), jnp.float32), 0, w,
                           w, batch=1, depth=depth)
    tacc, timg = tt.render(tds, tres, torch.zeros(n, 3), 0, w, w, batch=1,
                           depth=depth)
    # per wave: one closest-hit trace, then the shader's shadow trace
    assert calls == [False, True] * depth
    assert torch.isfinite(tacc).all()
    ref = np.asarray(jimg)[..., :3].astype(np.float64)
    got = timg.numpy()[..., :3].astype(np.float64)
    assert got.std() > 1.0
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    assert rmse < RMSE_BAR[depth], rmse
