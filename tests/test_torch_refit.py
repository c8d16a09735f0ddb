"""radiance_tpu_torch's animated-transform refit vs radiance_tpu's.

TopAccelStruct.refit rebuilds the small TLAS over the same BLASes and
rewrites the TLAS block and instance arrays of the device scene in place
(bvh/device.update_tlas).  Here: the two cases of tests/test_refit.py on
the port's walk, beside the JAX walk on the JAX refit; update_tlas's
TLAS block and instance arrays equal to the JAX package's; a refit that
moves instances of different BLASes to other slots, traced by the port's
per-instance sweeps, its instance scan and its engine dispatch against
its walk and the JAX walk; the blob after a refit.

The port derives each slot's kernel-table entry (inst_kblas) anew from
its BLAS root and refreshes the scan's cached tables (scene.multi).  The
JAX update_tlas keeps inst_kblas as it was, which its TPU sweeps and
scan read: test_reference_refit_keeps_stale_inst_kblas records that
(ROADMAP.md queue 3).

Bars: hit records as in test_torch_traversal.py (hit/miss, prim and slot
equal; t, b1, b2 rtol 1e-6, atol 1e-5); the sweeps and the scan against
the walk: hit/miss equal, prim and instance equal, t rtol 1e-5 (three
different tracers of the same triangles).
"""

import numpy as np
import pytest
import torch

from radiance_tpu.api import accel as jaccel
from radiance_tpu.core import types as jtypes

from radiance_tpu_torch.api import accel as taccel
from radiance_tpu_torch.bvh import device as tdevice
from radiance_tpu_torch.bvh import serialize as tserialize
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.engine import pathtracer as tpath
from radiance_tpu_torch.ops import packet_trace as tpk
from radiance_tpu_torch.ops import stream3_multi as tsm
from radiance_tpu_torch.ops.intersect import FLT_MAX

from test_bvh import random_mesh
from test_torch_stream3 import _one_torch_thread  # noqa: F401
from test_torch_traversal import (FIELDS, assert_same_hits, gen_rays,
                                  jax_walk, port_scene, port_walk)

TMIN, TMAX = 1e-3, 1e3
ARRAYS = ("node_packed", "inst_transform", "inst_inv", "inst_id",
          "inst_custom", "inst_sbt", "inst_blas_root")


def tlas_pair(meshes, tfs, which):
    """The same instances built by both packages: (JAX TLAS, port TLAS)."""
    out = []
    for accel, types in ((jaccel, jtypes), (taccel, ttypes)):
        blases = [accel.BuildBottomAccelStruct(types.Mesh(m.vertices,
                                                          m.triangles))
                  for m in meshes]
        out.append(accel.BuildTopAccelStruct(
            [types.Instance(tf.copy(), 0, i, blases[w])
             for i, (tf, w) in enumerate(zip(tfs, which))]))
    return tuple(out)


def _t(x=0.0, y=0.0, z=0.0):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [x, y, z]
    return m


def test_refit_moves_instances():
    """tests/test_refit.py's first case on the port, beside the JAX flow."""
    mesh = random_mesh(np.random.default_rng(0), 120, spread=1.5)
    jt, tt = tlas_pair([mesh], [_t(), _t(10.0)], [0, 0])
    scene = tt.device_scene("cpu")
    o = np.array([[0, 0, 30]], np.float32)
    d = np.array([[0, 0, -1.0]], np.float32)
    assert port_walk(scene, o, d)["t"][0] < FLT_MAX

    m1, m2 = _t(50.0, 50.0), _t()
    scene2 = tt.refit(np.stack([m1, m2]), "cpu")
    assert scene2 is scene                   # updated in place
    got = port_walk(scene2, o, d)
    assert got["t"][0] < FLT_MAX
    assert int(scene2.inst_id[got["slot"][0]]) == 1
    o2 = np.array([[10, 0, 30]], np.float32)
    assert port_walk(scene2, o2, d)["t"][0] == FLT_MAX

    fresh = taccel.BuildTopAccelStruct([
        ttypes.Instance(m1, 0, 0, tt.source_instances[0].bottom_accel_struct),
        ttypes.Instance(m2, 0, 1, tt.source_instances[1].bottom_accel_struct)])
    hf = port_walk(fresh.device_scene("cpu"), o, d)
    np.testing.assert_allclose(got["t"], hf["t"], rtol=1e-6)

    jt.device_scene()
    jscene = jt.refit(np.stack([m1, m2]))
    both = np.concatenate([o, o2])
    assert_same_hits(jax_walk(jscene, both, np.concatenate([d, d])),
                     port_walk(scene2, both, np.concatenate([d, d])))


def test_refit_many_frames_consistent():
    """tests/test_refit.py's second case: 5 instances marching for 3
    frames, each frame's hits equal to the JAX refit's on 64 rays."""
    mesh = random_mesh(np.random.default_rng(1), 60, spread=1.0)
    tfs = [_t(4.0 * i) for i in range(5)]
    jt, tt = tlas_pair([mesh], tfs, [0] * 5)
    rows = tt.device_scene("cpu").node_packed.shape[0]
    jt.device_scene()
    rng = np.random.default_rng(2)
    for frame in range(3):
        new = np.stack([_t(4.0 * i, float(frame)) for i in range(5)])
        scene = tt.refit(new, "cpu")
        jscene = jt.refit(new)
        o = np.array([[8.0, frame, 30.0]], np.float32)
        d = np.array([[0, 0, -1.0]], np.float32)
        assert port_walk(scene, o, d)["t"][0] < FLT_MAX, frame
        assert scene.node_packed.shape[0] == rows
        ro, rd = gen_rays(rng, 64, spread=10.0)
        assert_same_hits(jax_walk(jscene, ro, rd), port_walk(scene, ro, rd))


def _three_blas_scene():
    """9 instances of 3 different meshes on a 3x3 grid."""
    rng = np.random.default_rng(7)
    meshes = [random_mesh(rng, 40 + 10 * k, spread=1.2) for k in range(3)]
    tfs = [_t(4.0 * (i % 3) - 4.0, 4.0 * (i // 3) - 4.0) for i in range(9)]
    return meshes, tfs, [i % 3 for i in range(9)]


def _rolled(tfs, k=1):
    """Each instance takes the position of the next one: the same boxes,
    so the TLAS's shape stays, but another BLAS sits in each leaf slot."""
    return np.stack([tfs[(i + k) % len(tfs)] for i in range(len(tfs))])


def test_update_tlas_matches_jax():
    meshes, tfs, which = _three_blas_scene()
    jt, tt = tlas_pair(meshes, tfs, which)
    jt.device_scene()
    scene = tt.device_scene("cpu")
    new = _rolled(tfs)
    new[:, 1, 3] += 0.5
    jscene = jt.refit(new)
    tt.refit(new, "cpu")
    for k in ARRAYS:
        a, b = np.asarray(getattr(jscene, k)), getattr(scene, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    # the refit scene equals a fresh build of the refitted TLAS
    fresh = tdevice.build_device_scene(
        tt.nodes, tt.instances, {off: (b.nodes, b.faces, b.vertices)
                                 for off, b in tt.blas_offsets},
        tlas_capacity=tt.tlas_capacity, device="cpu")
    assert fresh.node_packed[:tt.tlas_capacity].numpy().tobytes() == \
        scene.node_packed[:tt.tlas_capacity].numpy().tobytes()


def test_refit_updates_every_cached_scene():
    """refit rewrites each device scene the TLAS has made, in both frame
    modes; each equals a fresh build of the refitted TLAS in its mode."""
    meshes, tfs, which = _three_blas_scene()
    _, tt = tlas_pair(meshes, tfs, which)
    scenes = {m: tt.device_scene("cpu", stable_frames=m)
              for m in (True, False)}
    new = _rolled(tfs)
    new[:, 0, 3] -= 0.25
    assert tt.refit(new, "cpu") is scenes[True]
    blas = {off: (b.nodes, b.faces, b.vertices) for off, b in tt.blas_offsets}
    for mode, scene in scenes.items():
        assert tt.device_scene("cpu", stable_frames=mode) is scene
        fresh = tdevice.build_device_scene(
            tt.nodes, tt.instances, blas, tlas_capacity=tt.tlas_capacity,
            stable_frames=mode, device="cpu")
        for k in ARRAYS:
            if k == "node_packed":
                got = getattr(scene, k)[:tt.tlas_capacity]
                ref = getattr(fresh, k)[:tt.tlas_capacity]
            else:
                got, ref = getattr(scene, k), getattr(fresh, k)
            assert got.numpy().tobytes() == ref.numpy().tobytes(), (mode, k)
        assert scene.inst_kblas == fresh.inst_kblas, mode


def _roots_kblas(scene):
    roots = sorted(set(np.asarray(scene.inst_blas_root).tolist()))
    return tuple(roots.index(int(r)) for r in np.asarray(scene.inst_blas_root))


@pytest.fixture(scope="module")
def reordered():
    """(JAX scene, port scene) after a refit that changes which BLAS each
    slot holds; the port scene had its scan tables made before."""
    meshes, tfs, which = _three_blas_scene()
    jt, tt = tlas_pair(meshes, tfs, which)
    jt.device_scene()
    scene = tt.device_scene("cpu")
    before = scene.inst_kblas
    tsm.multi_tables(scene)
    new = _rolled(tfs)
    jscene = jt.refit(new)
    tt.refit(new, "cpu")
    assert scene.inst_kblas != before       # the slots hold other BLASes
    rng = np.random.default_rng(5)
    o = rng.uniform(-7, 7, (2048, 3)).astype(np.float32)
    o[:, 2] = 20.0
    d = rng.normal(size=(2048, 3)).astype(np.float32) * 0.2
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jscene, scene, o, d


def _hold(got, ref, scene):
    hit_r, hit_g = ref["t"] < FLT_MAX, got["t"] < FLT_MAX
    np.testing.assert_array_equal(hit_r, hit_g)
    both = hit_r & hit_g
    assert both.sum() > 200
    np.testing.assert_array_equal(got["prim"][both], ref["prim"][both])
    inst = scene.inst_id.numpy()
    np.testing.assert_array_equal(inst[got["slot"][both]],
                                  inst[ref["slot"][both]])
    np.testing.assert_allclose(got["t"][both], ref["t"][both], rtol=1e-5)


def _rec(rec):
    return {k: getattr(rec, k).numpy() for k in FIELDS}


def test_refit_reorder_walk_matches_jax(reordered):
    jscene, scene, o, d = reordered
    assert scene.inst_kblas == _roots_kblas(scene)
    assert_same_hits(jax_walk(jscene, o, d), port_walk(scene, o, d))


def test_refit_reorder_sweeps_match_walk(reordered):
    jscene, scene, o, d = reordered
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = _rec(tpk.trace_rays_packet_multi(scene, ot, dt, TMIN, TMAX))
    _hold(got, port_walk(scene, o, d), scene)
    _hold(got, jax_walk(jscene, o, d), scene)


def test_refit_reorder_scan_matches_walk(reordered):
    """The instance scan through the engine's dispatch (9 instances) on the
    scan tables cached before the refit, now refreshed."""
    jscene, scene, o, d = reordered
    mt = scene.multi
    rec = tpath._trace_dispatch(scene, torch.from_numpy(o),
                                torch.from_numpy(d), TMIN, TMAX)
    assert scene.multi is mt
    np.testing.assert_array_equal(
        mt.inst_idx, [mt.uniq.index(b) for b in scene.inst_kblas])
    got = _rec(rec)
    assert (got["slot"] != -2).all()
    _hold(got, port_walk(scene, o, d), scene)
    _hold(got, jax_walk(jscene, o, d), scene)


def test_reference_refit_keeps_stale_inst_kblas(reordered):
    """The JAX update_tlas rewrites inst_blas_root but keeps inst_kblas, so
    its kernel-table routes (the TPU sweeps and scan) read another slot's
    BLAS after this refit.  Carried into the port as it is, the JAX
    scene's stale map makes the sweeps disagree with the walk."""
    jscene, _, o, d = reordered
    assert jscene.inst_kblas != _roots_kblas(jscene)
    stale = port_scene(jscene)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = _rec(tpk.trace_rays_packet_multi(stale, ot, dt, TMIN, TMAX))
    ref = jax_walk(jscene, o, d)
    assert ((got["t"] < FLT_MAX) != (ref["t"] < FLT_MAX)).mean() > 0.01


def test_blob_after_refit_parses_to_new_transforms():
    meshes, tfs, which = _three_blas_scene()
    _, tt = tlas_pair(meshes, tfs, which)
    tt.device_scene("cpu")
    new = _rolled(tfs, 2)
    tt.refit(new, "cpu")
    parsed = tserialize.parse_tlas(tt.blob)
    by_id = {int(r["instanceID"]): r for r in parsed.instances}
    for i in range(len(new)):
        np.testing.assert_array_equal(by_id[i]["transform"], new[i])


def test_refit_of_a_file_loaded_tlas_raises(tmp_path):
    meshes, tfs, which = _three_blas_scene()
    _, tt = tlas_pair(meshes, tfs, which)
    path = str(tmp_path / "t.bin")
    taccel.TopAccelStructToFile(tt, path)
    with pytest.raises(ValueError, match="source instances"):
        taccel.FileToTopAccelStruct(path).refit(np.stack(tfs), "cpu")
