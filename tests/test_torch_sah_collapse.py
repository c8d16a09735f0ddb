"""The SAH-driven leaf collapse in radiance_tpu_torch vs radiance_tpu.

The JAX package cuts its kernel leaves by the SAH model where
RADIANCE_COLLAPSE=sah, at RADIANCE_COLLAPSE_RHO (both read when the
tables are built); the port takes collapse= and rho= beside leaf_cap
(kernel_pack.build_kernel_tables, every scene builder,
TopAccelStruct.device_scene).  The JAX cap is fixed at import
(KERNEL_MAX_TRIS, RADIANCE_LEAF_CAP), so its cap-64 build here patches
that module constant and its leaf width for the test.

Bars: the tables byte-identical (the same numpy build); the port's
stream3 wave (its plain versions) and its TLAS-native route on SAH tables
against the JAX two-level walk at tests/test_stream3.py's and
tests/test_stream3_multi.py's tolerances (hit/miss equal, t rtol 2e-3
atol 1e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.api import accel as jaccel
from radiance_tpu.bvh import kernel_pack as jkp
from radiance_tpu.core import types as jtypes
from radiance_tpu.ops import traversal
from radiance_tpu.ops.intersect import FLT_MAX

from radiance_tpu_torch.api import accel as taccel
from radiance_tpu_torch.bvh import device as tdevice
from radiance_tpu_torch.bvh import kernel_pack as tkp
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops import stream3_multi as tsm

from test_bvh import random_mesh
from test_torch_leaf_cap import MULTI, TABLES
from test_torch_stream3 import _one_torch_thread, trows  # noqa: F401
from test_torch_stream3_tlas import tlas_geometry
from test_traversal import gen_rays

TMIN, TMAX = 1e-3, 1e3


def jax_env(monkeypatch, cap, rho):
    """The JAX build's SAH collapse at cap and rho."""
    monkeypatch.setenv("RADIANCE_COLLAPSE", "sah")
    monkeypatch.setenv("RADIANCE_COLLAPSE_RHO", repr(rho))
    monkeypatch.setattr(jkp, "KERNEL_MAX_TRIS", cap)
    monkeypatch.setattr(jkp, "KERNEL_LEAF_LANES", 4 * cap)


def build(pkg, insts_of, **kw):
    """A DeviceScene of (mesh, transform) pairs in one package: the JAX
    one (pkg "jax") or the port's on the CPU with keywords kw."""
    accel, types = (jaccel, jtypes) if pkg == "jax" else (taccel, ttypes)
    blases = {}
    insts = []
    for i, (key, verts, tris, tf) in enumerate(insts_of):
        if key not in blases:
            blases[key] = accel.BuildBottomAccelStruct(types.Mesh(verts,
                                                                  tris))
        insts.append(types.Instance(tf, 0, i, blases[key]))
    top = accel.BuildTopAccelStruct(insts)
    return top.device_scene() if pkg == "jax" else top.device_scene(
        "cpu", **kw)


def single(n_tris, seed):
    """tests/test_packet_trace.py::_single_instance_scene's instance."""
    m = random_mesh(np.random.default_rng(seed), n_tris, spread=5.0)
    return [(0, m.vertices, m.triangles, np.eye(4, dtype=np.float32))]


def mini_city():
    """tests/test_stream3.py:1066-1082's clustered mini city (64 clusters
    of 60 triangles), where the SAH cut differs from the greedy one."""
    rng = np.random.default_rng(7)
    centers = rng.uniform(-20, 20, size=(64, 3)).astype(np.float32)
    local = rng.uniform(-1.5, 1.5, size=(64, 60, 3)).astype(np.float32)
    offs = rng.normal(scale=0.08, size=(64, 60, 3, 3)).astype(np.float32)
    verts = ((centers[:, None, :] + local)[:, :, None, :]
             + offs).reshape(-1, 3)
    return [(0, verts, np.arange(len(verts), dtype=np.uint32).reshape(-1, 3),
             np.eye(4, dtype=np.float32))]


def multi():
    """tests/test_torch_leaf_cap.py's 3-BLAS scene."""
    out = []
    for i, (n, seed) in enumerate(MULTI):
        m = random_mesh(np.random.default_rng(seed), n, spread=5.0)
        tf = np.eye(4, dtype=np.float32)
        tf[0, 3] = 12.0 * i
        out.append((i, m.vertices, m.triangles, tf))
    return out


def tlas(n_inst, seed):
    """tests/test_stream3_multi.py::_tlas_scene's instances."""
    meshes, tfs, which = tlas_geometry(n_inst=n_inst, seed=seed)
    return [(w, meshes[w], np.arange(len(meshes[w]), dtype=np.uint32)
             .reshape(-1, 3), tf) for tf, w in zip(tfs, which)]


def leaves_of(knode_f):
    """(tri_start, ntri) of the leaves of octant 0's threading."""
    one = knode_f[:knode_f.shape[0] // 8]
    return one[one[:, 10] > 0][:, [11, 10]].astype(np.int64)


@pytest.mark.parametrize("cap", [128, 64])
@pytest.mark.parametrize("rho", [0.15, 0.6])
def test_tables_byte_identical(monkeypatch, cap, rho):
    """The mini city's single-instance tables and every BLAS's kblas
    tables of the 3-BLAS scene, byte for byte against the JAX build under
    RADIANCE_COLLAPSE=sah at the cap and rho; the collapse and rho
    recorded on the port's scene; the city's cut has more leaves than the
    greedy one."""
    jax_env(monkeypatch, cap, rho)
    jds = build("jax", mini_city())
    tds = build("torch", mini_city(), leaf_cap=cap, collapse="sah",
                rho=rho)
    assert (tds.collapse, tds.rho, tds.leaf_cap) == ("sah", rho, cap)
    for k in TABLES:
        a, b = np.asarray(getattr(jds, k)), getattr(tds, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    jm = build("jax", multi())
    tm = build("torch", multi(), leaf_cap=cap, collapse="sah", rho=rho)
    assert tuple(jm.inst_kblas) == tm.inst_kblas
    for je, te in zip(jm.kblas, tm.kblas):
        for a, b in zip(je, te):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
    greedy = build("torch", mini_city(), leaf_cap=cap)
    assert greedy.collapse == "greedy"
    assert (len(leaves_of(greedy.knode_f.numpy()))
            < len(leaves_of(tds.knode_f.numpy())))


def test_cut_partitions_the_face_slab():
    """tests/test_stream3.py::test_stream3_sah_collapse_vs_oracle's
    partition check on its 900-triangle scene: the SAH leaves' face
    ranges, sorted by start, are contiguous and cover every face, each at
    most the cap."""
    for cap in (128, 64):
        tds = build("torch", single(900, 3), leaf_cap=cap, collapse="sah")
        span = leaves_of(tds.knode_f.numpy())
        span = span[np.argsort(span[:, 0])]
        assert (span[:-1, 0] + span[:-1, 1] == span[1:, 0]).all()
        assert span[0, 0] == 0 and span[-1].sum() == 900
        assert (span[:, 1] <= cap).all()


@pytest.mark.parametrize("scene", ["soup", "city"])
def test_stream3_on_sah_tables_matches_the_walk(monkeypatch, scene):
    """test_stream3_sah_collapse_vs_oracle's scene and 2048 rays (where
    the SAH cut is the greedy one), and 2048 rays at the mini city's
    triangles (where it is not): the port's stream3 wave on SAH tables against
    the JAX traversal walk (which walks the BVH, not the tables), and the
    hits of the port's wave on greedy tables equal."""
    monkeypatch.setenv("RADIANCE_COLLAPSE", "sah")
    if scene == "soup":
        geo = single(900, 3)
        o, d = gen_rays(np.random.default_rng(11), 2048, spread=8.0)
    else:
        geo = mini_city()
        # rays from 30 units out at points near the city's triangles
        rng = np.random.default_rng(11)
        verts = geo[0][1]
        aim = verts[rng.integers(0, len(verts), 2048)] + rng.normal(
            scale=0.5, size=(2048, 3))
        d = rng.normal(size=(2048, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = (aim - 30.0 * d).astype(np.float32)
        d = d.astype(np.float32)
    jds = build("jax", geo)
    tds = build("torch", geo, collapse="sah")
    assert ts3.supports(tds)
    ref = traversal.trace_rays(jds, jnp.asarray(o), jnp.asarray(d), TMIN,
                               TMAX)
    got = ts3.trace_rows_stream3(tds, trows(o, d), TMIN, TMAX)
    t_ref, t_got = np.asarray(ref.t), got.t.numpy()
    hr = t_ref < FLT_MAX
    assert hr.sum() > 50
    np.testing.assert_array_equal(t_got < FLT_MAX, hr)
    np.testing.assert_allclose(t_got[hr], t_ref[hr], rtol=2e-3, atol=1e-4)
    greedy = ts3.trace_rows_stream3(build("torch", geo), trows(o, d), TMIN,
                                    TMAX)
    np.testing.assert_array_equal(greedy.t.numpy() < FLT_MAX, hr)


def test_native_route_on_sah_tables_matches_the_walk(monkeypatch):
    """tests/test_stream3_multi.py::test_tlas_native_sah_collapse's
    6-instance scene and 1024 rays: the concatenated tables carry every
    BLAS's SAH cut, and the port's native route matches the JAX walk."""
    monkeypatch.setenv("RADIANCE_COLLAPSE", "sah")
    jds = build("jax", tlas(6, 13))
    tds = build("torch", tlas(6, 13), collapse="sah")
    mt = tsm.MultiTables(tds)
    assert tsm.supports_native(mt)
    for je, te in zip(jds.kblas, tds.kblas):
        assert np.asarray(je[0]).tobytes() == te[0].numpy().tobytes()
    rng = np.random.default_rng(5)
    o = rng.uniform(-14, 14, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = traversal.trace_rays(jds, jnp.asarray(o), jnp.asarray(d), TMIN,
                               TMAX)
    got = tsm.trace_rows_tlas(tds, mt, trows(o, d), TMIN, TMAX)
    assert (got.slot.numpy() != -2).all()
    t_ref, t_got = np.asarray(ref.t), got.t.numpy()
    hr = t_ref < FLT_MAX
    assert hr.sum() > 50
    np.testing.assert_array_equal(t_got < FLT_MAX, hr)
    np.testing.assert_allclose(t_got[hr], t_ref[hr], rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("collapse, rho", [
    ("SAH", 0.15), ("none", 0.15), ("", 0.15), (None, 0.15),
    ("sah", -0.01), ("sah", float("nan")), ("sah", float("inf")),
    ("sah", "0.15"), ("greedy", True)])
def test_bad_collapse_refused(collapse, rho):
    """An unknown collapse or a rho that is not a finite number >= 0 is
    refused by the table build and every scene builder, naming the JAX
    variable."""
    var = "RADIANCE_COLLAPSE" if collapse not in tkp.COLLAPSES \
        else "RADIANCE_COLLAPSE_RHO"
    with pytest.raises(ValueError, match=var):
        tkp.check_collapse(collapse, rho)
    m = single(60, 1)
    with pytest.raises(ValueError, match=var):
        build("torch", m, collapse=collapse, rho=rho)
    blas = taccel.BuildBottomAccelStruct(ttypes.Mesh(m[0][1], m[0][2]))
    top = taccel.BuildTopAccelStruct([ttypes.Instance(
        np.eye(4, dtype=np.float32), 0, 0, blas)])
    for fn in (lambda: tdevice.device_scene_from_instances(
                   top.source_instances, collapse=collapse, rho=rho,
                   device="cpu"),
               lambda: tdevice.device_scene_from_tlas_blob(
                   top.blob, collapse=collapse, rho=rho, device="cpu")):
        with pytest.raises(ValueError, match=var):
            fn()


def test_collapse_reaches_every_builder():
    """device_scene_from_instances, device_scene_from_tlas_blob and
    TopAccelStruct.device_scene give the same SAH tables and record the
    collapse and rho; the accel caches one scene per (collapse, rho)."""
    m = single(500, 8)
    blas = taccel.BuildBottomAccelStruct(ttypes.Mesh(m[0][1], m[0][2]))
    top = taccel.BuildTopAccelStruct([ttypes.Instance(
        np.eye(4, dtype=np.float32), 0, 0, blas)])
    a = top.device_scene("cpu", collapse="sah", rho=0.3)
    assert top.device_scene("cpu", collapse="sah", rho=0.3) is a
    assert top.device_scene("cpu", collapse="sah") is not a
    assert top.device_scene("cpu").collapse == "greedy"
    for s in (tdevice.device_scene_from_instances(
                  top.source_instances, collapse="sah", rho=0.3,
                  device="cpu"),
              tdevice.device_scene_from_tlas_blob(
                  top.blob, collapse="sah", rho=0.3, device="cpu")):
        assert (s.collapse, s.rho) == ("sah", 0.3)
        for k in ("knode_f", "kleaf", "kprim", "ktri_geo"):
            assert torch.equal(getattr(s, k), getattr(a, k)), k
