"""radiance_tpu_torch's two-level walk (ops/traversal.py) vs radiance_tpu's.

The scenes of tests/test_traversal.py, each built by the JAX package and
carried into the port with scene_from_numpy, so both walks read the same
tables; the same numpy rays go through the JAX walk (jit, CPU) and the
port's (CPU tensors), closest hit and any-hit.

Bars: hit/miss equal on every ray; prim and slot equal where both hit;
t, b1 and b2 to f32 rounding of the object-space ray: rtol 1e-6 and
atol 1e-5.  The two walks compute the same expressions, but XLA may fuse
the instance transform's 3-term sums (FMA), and an object-space origin
of |o| ~ 30 carries ~2e-6 of rounding into t and the barycentrics.  The
slab test alone (intersect_aabb) is compared value for value, NaN slabs
included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.api import accel as jaccel
from radiance_tpu.core import types as jtypes
from radiance_tpu.ops import intersect as jintersect
from radiance_tpu.ops import traversal as jtrav

from radiance_tpu_torch.api import accel as taccel
from radiance_tpu_torch.bvh import device as tdevice
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.engine import pathtracer as tpath
from radiance_tpu_torch.ops import intersect as tintersect
from radiance_tpu_torch.ops import traversal as ttrav

from test_bvh import random_mesh
from test_torch_stream3 import _one_torch_thread  # noqa: F401

TMIN, TMAX = 1e-3, 1e3
FIELDS = ("t", "prim", "slot", "b1", "b2")


def port_scene(jds):
    """The JAX DeviceScene's state as a port DeviceScene on the CPU."""
    arrays = {f.name: getattr(jds, f.name) for f in dataclasses.fields(jds)}
    return tdevice.scene_from_numpy(arrays, jds.stable_frames, "cpu")


def gen_rays(rng, n, spread=12.0):
    o = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def jax_walk(jds, o, d, **kw):
    rec = jtrav.trace_rays(jds, jnp.asarray(o), jnp.asarray(d), TMIN, TMAX,
                           **kw)
    return {k: np.asarray(getattr(rec, k)) for k in FIELDS}


def port_walk(tds, o, d, **kw):
    rec = ttrav.trace_rays(tds, torch.from_numpy(o), torch.from_numpy(d),
                           TMIN, TMAX, **kw)
    return {k: getattr(rec, k).numpy() for k in FIELDS}


def assert_same_hits(ref, got):
    hit_r = ref["t"] < tintersect.FLT_MAX
    hit_g = got["t"] < tintersect.FLT_MAX
    np.testing.assert_array_equal(hit_r, hit_g)
    both = hit_r & hit_g
    np.testing.assert_array_equal(ref["prim"][both], got["prim"][both])
    np.testing.assert_array_equal(ref["slot"], got["slot"])
    for k in ("t", "b1", "b2"):
        np.testing.assert_allclose(got[k][both], ref[k][both], rtol=1e-6,
                                   atol=1e-5, err_msg=k)
    assert (got["prim"][~hit_g] == -1).all()


def _tf(tx, ty, tz, ry=0.0, s=1.0):
    c, si = np.cos(ry), np.sin(ry)
    return np.array([[c * s, 0, si * s, tx], [0, s, 0, ty],
                     [-si * s, 0, c * s, tz], [0, 0, 0, 1]], np.float32)


def _single(rng):
    blas = jaccel.BuildBottomAccelStruct(random_mesh(rng, 300, spread=5.0))
    return [jtypes.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)], None


def _multi(rng):
    b1 = jaccel.BuildBottomAccelStruct(random_mesh(rng, 120, spread=2.0))
    b2 = jaccel.BuildBottomAccelStruct(random_mesh(rng, 80, spread=2.0))
    return [jtypes.Instance(_tf(0, 0, 0), 0, 0, b1),
            jtypes.Instance(_tf(6, 1, -2, ry=0.7), 0, 1, b2),
            jtypes.Instance(_tf(-6, -1, 3, ry=1.9, s=1.5), 0, 2, b1),
            jtypes.Instance(_tf(0, 7, 0, ry=0.3, s=0.5), 0, 3, b2)], None


def _deep(rng):
    blas = jaccel.BuildBottomAccelStruct(random_mesh(rng, 40, spread=1.0))
    out = []
    for i in range(25):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = rng.uniform(-20, 20, 3)
        out.append(jtypes.Instance(m, 0, i, blas))
    return out, None


def _occlusion(rng):
    blas = jaccel.BuildBottomAccelStruct(random_mesh(rng, 200, spread=4.0))
    return [jtypes.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)], None


def _oversized(rng):
    v = np.asarray([[0, 0, 1], [4, 0, 1], [0, 4, 1]], np.float32)
    mesh = jtypes.Mesh(np.tile(v, (32, 1)),
                       np.arange(96, dtype=np.uint32).reshape(-1, 3))
    blas = jaccel.BuildBottomAccelStruct(mesh)
    probe = (np.array([[1, 1, 0]], np.float32),
             np.array([[0, 0, 1]], np.float32))
    return [jtypes.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)], probe


def _miss(rng):
    blas = jaccel.BuildBottomAccelStruct(random_mesh(rng, 50, spread=1.0))
    probe = (np.array([[100, 100, 100]], np.float32),
             np.array([[0, 0, 1]], np.float32))
    return [jtypes.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)], probe


# tests/test_traversal.py's six scenes: (builder, its rng seed, ray spread)
SCENES = {
    "single_identity_instance": (_single, 10, 12.0),
    "multi_instance_transformed": (_multi, 11, 12.0),
    "many_instances_deep_tlas": (_deep, 12, 12.0),
    "any_hit_occlusion": (_occlusion, 13, 6.0),
    "oversized_leaf_normalization": (_oversized, 0, 3.0),
    "miss_everything": (_miss, 14, 12.0),
}


@pytest.fixture(scope="module")
def built():
    """name -> (JAX DeviceScene, port DeviceScene, rays o, d)."""
    out = {}
    for name, (make, seed, spread) in SCENES.items():
        rng = np.random.default_rng(seed)
        insts, probe = make(rng)
        jds = jaccel.BuildTopAccelStruct(insts).device_scene()
        o, d = gen_rays(rng, 256, spread)
        if probe is not None:
            o, d = np.concatenate([o, probe[0]]), np.concatenate([d, probe[1]])
        out[name] = (jds, port_scene(jds), o, d)
    return out


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", list(SCENES))
def test_walk_matches_jax(built, name, any_hit):
    jds, tds, o, d = built[name]
    ref = jax_walk(jds, o, d, any_hit_terminate=any_hit)
    got = port_walk(tds, o, d, any_hit_terminate=any_hit)
    assert_same_hits(ref, got)
    if name == "oversized_leaf_normalization":
        assert got["t"][-1] == pytest.approx(1.0)
    if name == "miss_everything":
        assert got["slot"][-1] == -1 and got["prim"][-1] == -1


def test_walk_chunked_with_pad(built):
    """chunk_size < n with a padded last chunk: the same hits as one chunk
    and as the JAX walk's own chunked lax.map."""
    jds, tds, o, d = built["multi_instance_transformed"]
    whole = port_walk(tds, o, d)
    chunked = port_walk(tds, o, d, chunk_size=100)      # 256 = 3 x 100 - 44
    ref = jax_walk(jds, o, d, chunk_size=100)
    for k in FIELDS:
        np.testing.assert_array_equal(whole[k], chunked[k], err_msg=k)
    assert_same_hits(ref, chunked)


def test_dispatch_routes_many_instances_to_the_walk():
    """65 instances: no kernel tables, so the port engine's _trace_dispatch
    takes the walk; its hits equal the JAX walk's on the JAX scene."""
    rng = np.random.default_rng(21)
    mesh = random_mesh(rng, 30, spread=1.0)
    tfs = []
    for i in range(65):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = rng.uniform(-20, 20, 3)
        tfs.append(m)
    jb = jaccel.BuildBottomAccelStruct(mesh)
    tb = taccel.BuildBottomAccelStruct(ttypes.Mesh(mesh.vertices,
                                                   mesh.triangles))
    jds = jaccel.BuildTopAccelStruct(
        [jtypes.Instance(m, 0, i, jb) for i, m in enumerate(tfs)]
    ).device_scene()
    tds = taccel.BuildTopAccelStruct(
        [ttypes.Instance(m, 0, i, tb) for i, m in enumerate(tfs)]
    ).device_scene("cpu")
    assert tds.kblas is None and tds.knode_f is None
    o, d = gen_rays(rng, 256, spread=22.0)
    for any_hit in (False, True):
        rec = tpath._trace_dispatch(tds, torch.from_numpy(o),
                                    torch.from_numpy(d), TMIN, TMAX,
                                    any_hit_terminate=any_hit)
        got = {k: getattr(rec, k).numpy() for k in FIELDS}
        ref = jax_walk(jds, o, d, any_hit_terminate=any_hit)
        assert_same_hits(ref, got)
        assert (got["t"] < tintersect.FLT_MAX).sum() > 10


def test_hitrecord_reexported_from_packet_trace():
    from radiance_tpu_torch.ops import packet_trace
    assert packet_trace.HitRecord is ttrav.HitRecord


def test_intersect_aabb_matches_jax():
    """The slab test, value for value, with axis-parallel rays lying on
    slab planes (0 * inf = NaN must miss) and a clip."""
    rng = np.random.default_rng(3)
    n = 512
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::4, 1:] = 0.0                       # axis-parallel rays
    o[::8, 1] = 1.0                        # on the box's max-y plane
    lo = np.full((n, 3), -1.0, np.float32)
    hi = np.full((n, 3), 1.0, np.float32)
    clip = rng.uniform(0.0, 3.0, n).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    for c in (None, clip):
        ref = np.asarray(jintersect.intersect_aabb(
            jnp.asarray(o), jnp.asarray(inv), jnp.asarray(lo),
            jnp.asarray(hi), t_clip=None if c is None else jnp.asarray(c)))
        got = tintersect.intersect_aabb(
            torch.from_numpy(o), torch.from_numpy(inv), torch.from_numpy(lo),
            torch.from_numpy(hi),
            t_clip=None if c is None else torch.from_numpy(c)).numpy()
        np.testing.assert_array_equal(ref, got)
    assert not got[::8][(d[::8, 1:] == 0).all(1)].all()
