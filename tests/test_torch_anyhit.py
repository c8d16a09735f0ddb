"""Custom any-hit programs on radiance_tpu_torch's walk vs radiance_tpu's.

The five cases of tests/test_anyhit.py (alpha test, reject-all, accept
and terminate, the SBT-keyed dispatch of make_any_hit_program, two
instances with different SBT offsets), each any-hit program written once
in jnp for the JAX walk and once in torch for the port's, on the same
scene tables (the JAX scene carried over with scene_from_numpy).  Then
the engine: the Cornell box at 32x32 with an alpha-test shadow program
(odd prims let light through) against the JAX engine's image.

Bars: the hit records of the two walks agree as in
test_torch_traversal.py (hit/miss, prim and slot equal; t, b1, b2 to
rtol 1e-6, atol 1e-5), plus each case's own assertions from
test_anyhit.py.  Images: the golden tests' bars, u8 RMSE < 2.0 (depth 1)
and < 3.0 (depth 2).
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
from radiance_tpu.scene import procedural as jproc
from radiance_tpu.shading import camera as jcam

from radiance_tpu_torch.api.sbt import ShaderBindingTable as TSBT
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.engine import shaders as tshaders
from radiance_tpu_torch.engine.pathtracer import WavefrontPathTracer as TTracer
from radiance_tpu_torch.ops.intersect import FLT_MAX
from radiance_tpu_torch.scene import procedural as tproc
from radiance_tpu_torch.shading import camera as tcam

from test_torch_stream3 import _one_torch_thread  # noqa: F401
from test_torch_traversal import (assert_same_hits, jax_walk, port_scene,
                                  port_walk)

RMSE_BAR = {1: 2.0, 2: 3.0}


def stacked_quads(n=10):
    """test_anyhit.stacked_quads: prim k at z = k + 1 covers the +z axis."""
    verts = []
    for k in range(n):
        z = float(k + 1)
        verts += [[-2, -2, z], [4, -2, z], [-2, 4, z]]
    mesh = jtypes.Mesh(np.asarray(verts, np.float32),
                       np.arange(n * 3, dtype=np.uint32).reshape(-1, 3))
    blas = jaccel.BuildBottomAccelStruct(mesh)
    jds = jaccel.BuildTopAccelStruct([jtypes.Instance(
        np.eye(4, dtype=np.float32), 0, 0, blas)]).device_scene()
    return jds, port_scene(jds)


def axis_rays(m=4):
    return (np.zeros((m, 3), np.float32),
            np.tile([0.0, 0.0, 1.0], (m, 1)).astype(np.float32))


# each program twice: (jnp version, torch version)
def _j_reject_even(cand):
    accept = (cand.prim % 2) == 1
    return accept, jnp.zeros_like(accept)


def _t_reject_even(cand):
    accept = (cand.prim % 2) == 1
    return accept, torch.zeros_like(accept)


def _j_reject_all(cand):
    z = jnp.zeros_like(cand.valid)
    return z, z


def _t_reject_all(cand):
    z = torch.zeros_like(cand.valid)
    return z, z


def _j_term_all(cand):
    a = jnp.ones_like(cand.valid)
    return a, a


def _t_term_all(cand):
    a = torch.ones_like(cand.valid)
    return a, a


def both(jds, tds, o, d, jprog=None, tprog=None, **kw):
    """(JAX record, port record) as numpy dicts, held to each other."""
    ref = jax_walk(jds, o, d, any_hit_program=jprog, **kw)
    got = port_walk(tds, o, d, any_hit_program=tprog, **kw)
    assert_same_hits(ref, got)
    return ref, got


def test_ignore_hit_alpha_test():
    jds, tds = stacked_quads()
    o, d = axis_rays()
    _, plain = both(jds, tds, o, d)
    np.testing.assert_allclose(plain["t"], 1.0, rtol=1e-6)
    assert (plain["prim"] == 0).all()
    _, got = both(jds, tds, o, d, _j_reject_even, _t_reject_even)
    np.testing.assert_allclose(got["t"], 2.0, rtol=1e-6)
    assert (got["prim"] == 1).all()
    np.testing.assert_allclose(got["b1"], plain["b1"], atol=1e-6)


def test_reject_all_is_miss():
    jds, tds = stacked_quads()
    o, d = axis_rays()
    _, got = both(jds, tds, o, d, _j_reject_all, _t_reject_all)
    assert (got["t"] == FLT_MAX).all() and (got["prim"] == -1).all()


def test_terminate_stops_walk_with_valid_hit():
    """Accept-all + terminate stops at the first visited leaf's best hit,
    a real prim; hit/miss equal the built-in occlusion mode's."""
    jds, tds = stacked_quads()
    o, d = axis_rays()
    _, got = both(jds, tds, o, d, _j_term_all, _t_term_all)
    assert (got["t"] < FLT_MAX).all()
    np.testing.assert_allclose(got["t"], got["prim"] + 1.0, rtol=1e-6)
    _, occ = both(jds, tds, o, d, any_hit_terminate=True)
    np.testing.assert_array_equal(got["t"] < FLT_MAX, occ["t"] < FLT_MAX)


def test_sbt_keyed_dispatch():
    """make_any_hit_program routes by instanceSBTOffset + record offset
    (shader.cl:574-583) and returns None for the canonical anyShadow."""
    def j_alpha(cand, res):
        return _j_reject_even(cand)

    def t_alpha(cand, res):
        return _t_reject_even(cand)

    records = [
        {"raygen": "rg", "closestHit": "", "anyHit": "", "miss": ""},
        {"raygen": "", "closestHit": "", "anyHit": "alpha", "miss": ""},
        {"raygen": "", "closestHit": "", "anyHit": "anyShadow", "miss": ""},
    ]
    jprog = JSBT.from_json(records, {
        "alpha": j_alpha, "anyShadow": jshaders.any_shadow,
        "rg": lambda *a: None}).make_any_hit_program(1, {})
    tprog = TSBT.from_json(records, {
        "alpha": t_alpha, "anyShadow": tshaders.any_shadow,
        "rg": lambda *a: None}).make_any_hit_program(1, {})
    assert tprog is not None
    jds, tds = stacked_quads()
    o, d = axis_rays()
    _, got = both(jds, tds, o, d, jprog, tprog)
    np.testing.assert_allclose(got["t"], 2.0, rtol=1e-6)
    canon = [{"raygen": "", "closestHit": "", "anyHit": "anyShadow",
              "miss": ""}]
    assert TSBT.from_json(canon, {"anyShadow": tshaders.any_shadow}
                          ).make_any_hit_program(0, {}) is None
    assert TSBT.from_json(records[:1], {}).make_any_hit_program(0, {}) is None


def test_anyhit_multi_instance_key():
    """Two instances, SBT offsets 0 and 1: the program rejects only where
    the key selects its record."""
    verts = np.asarray([[-2, -2, 1], [4, -2, 1], [-2, 4, 1]], np.float32)
    blas = jaccel.BuildBottomAccelStruct(
        jtypes.Mesh(verts, np.asarray([[0, 1, 2]], np.uint32)))
    m2 = np.eye(4, dtype=np.float32)
    m2[0, 3] = 10.0
    jds = jaccel.BuildTopAccelStruct([
        jtypes.Instance(np.eye(4, dtype=np.float32), 0, 0, blas),
        jtypes.Instance(m2, 1, 1, blas)]).device_scene()
    tds = port_scene(jds)
    records = [{"raygen": "", "closestHit": "", "anyHit": "", "miss": ""},
               {"raygen": "", "closestHit": "", "anyHit": "rej",
                "miss": ""}]
    jprog = JSBT.from_json(records, {
        "rej": lambda c, r: _j_reject_all(c)}).make_any_hit_program(0, {})
    tprog = TSBT.from_json(records, {
        "rej": lambda c, r: _t_reject_all(c)}).make_any_hit_program(0, {})
    o = np.array([[0, 0, 0], [10, 0, 0]], np.float32)
    d = np.tile([0.0, 0.0, 1.0], (2, 1)).astype(np.float32)
    _, got = both(jds, tds, o, d, jprog, tprog)
    hit = got["t"] < FLT_MAX
    assert hit[0] and not hit[1]


# ---- the engine with a custom shadow any-hit program ----

def _j_shadow_alpha(cand, res):
    """Shadow rays pass through odd prims and stop at the first even one."""
    accept = (cand.prim % 2) == 0
    return accept, accept


def _t_shadow_alpha(cand, res):
    accept = (cand.prim % 2) == 0
    return accept, accept


def _records():
    recs = [dict(r) for r in tshaders.DEFAULT_SBT_RECORDS]
    recs[2]["anyHit"] = "alphaShadow"
    return recs


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_shadow_program_matches_jax(monkeypatch, depth):
    """The Cornell box at 32x32, batch 2, with the alpha shadow program at
    the shadow offset.  Both engines walk every wave: make_any_hit_program
    gives a program at every record offset once any record has a custom
    any-hit, so the closest-hit waves carry one too.  The program visibly
    changes the image (against the built-in anyShadow)."""
    monkeypatch.setenv("RADIANCE_ENGINE_STAGED", "1")
    w = 32
    cam = dict(width_pixel=float(w), height_pixel=float(w),
               focal_length=0.035, sensor_width=0.05, focal_distance=8.0,
               f_stop=0.0, x=0.0, y=0.0, z=4.0, wx=0.0, wy=0.0, wz=0.0)
    jhost = jproc.cornell_box()
    jres = dict(jhost.resources,
                camera=jcam.camera_params(jtypes.PhysicalCamera(**cam)))
    thost = tproc.cornell_box(device="cpu")
    tres = dict(thost.resources, camera=tcam.camera_params(
        ttypes.PhysicalCamera(**cam), "cpu"))
    jt = JTracer(ray_generator=jcam.physical_camera_raygen,
                 sbt=JSBT.from_json(_records(), dict(
                     jshaders.SHADER_REGISTRY, alphaShadow=_j_shadow_alpha)))
    tt = TTracer(ray_generator=tcam.physical_camera_raygen,
                 sbt=TSBT.from_json(_records(), dict(
                     tshaders.SHADER_REGISTRY, alphaShadow=_t_shadow_alpha)))
    n = w * w
    _, jimg = jt.render(jhost.device_scene(), jres,
                        jnp.zeros((n, 3), jnp.float32), 0, w, w, batch=2,
                        depth=depth)
    tacc, timg = tt.render(thost.device_scene("cpu"), tres,
                           torch.zeros(n, 3), 0, w, w, batch=2, depth=depth)
    assert torch.isfinite(tacc).all()
    ref = np.asarray(jimg)[..., :3].astype(np.float64)
    got = timg.numpy()[..., :3].astype(np.float64)
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    assert rmse < RMSE_BAR[depth], rmse
    plain = TTracer(ray_generator=tcam.physical_camera_raygen,
                    sbt=TSBT.from_json(tshaders.DEFAULT_SBT_RECORDS,
                                       tshaders.SHADER_REGISTRY))
    _, pimg = plain.render(thost.device_scene("cpu"), tres,
                           torch.zeros(n, 3), 0, w, w, batch=2, depth=depth)
    diff = np.abs(pimg.numpy()[..., :3].astype(np.float64) - got)
    assert diff.mean() > 1.0, diff.mean()
