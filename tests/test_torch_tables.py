"""radiance_tpu_torch scene tables vs radiance_tpu's.

The port carries its own copies of the numpy host build (the card's
machine has no JAX), so the tables it assembles must stay bit-identical
to the JAX package's: knode_f, kleaf, kprim, ktri_geo, node_packed,
inst_inv and the frame mode, for a random mesh, the Cornell box and a
20k-triangle cut of the bench's city scene, in both frame modes.
scene_from_numpy must carry a JAX DeviceScene's state over unchanged.
"""

import numpy as np
import pytest

from radiance_tpu.api import accel as jaccel
from radiance_tpu.core import types as jtypes
from radiance_tpu.scene import procedural as jproc

from radiance_tpu_torch.api import accel as taccel
from radiance_tpu_torch.bvh import device as tdevice
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.scene import procedural as tproc

import bench
from test_bvh import random_mesh

SINGLE = ("knode_f", "kleaf", "kprim", "ktri_geo", "node_packed",
          "bundle_packed", "inst_inv", "inst_transform", "inst_id",
          "inst_custom", "inst_sbt", "inst_blas_root")


def _build_pair(meshes):
    """Build the same instances with both packages: one identity instance
    per (verts, tris) mesh."""
    jinst, tinst = [], []
    for i, (v, t) in enumerate(meshes):
        jb = jaccel.BuildBottomAccelStruct(jtypes.Mesh(v, t))
        tb = taccel.BuildBottomAccelStruct(ttypes.Mesh(v, t))
        assert jb.data == tb.data
        eye = np.eye(4, dtype=np.float32)
        jinst.append(jtypes.Instance(eye, 0, i, jb))
        tinst.append(ttypes.Instance(eye, 0, i, tb))
    return (jaccel.BuildTopAccelStruct(jinst),
            taccel.BuildTopAccelStruct(tinst))


def _assert_same(jds, tds):
    for k in SINGLE:
        a, b = getattr(jds, k), getattr(tds, k)
        if a is None:
            assert b is None, k
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert jds.stable_frames == tds.stable_frames
    assert jds.inst_kblas == tds.inst_kblas
    if jds.kblas is None:
        assert tds.kblas is None
    else:
        for je, te in zip(jds.kblas, tds.kblas, strict=True):
            for a, b in zip(je, te, strict=True):
                assert np.asarray(a).tobytes() == b.numpy().tobytes()


def _city_cut():
    return bench.scene_geometry("city", n_tris=20_000)


def _mesh_random():
    m = random_mesh(np.random.default_rng(3), 2000, spread=10.0)
    return [(m.vertices, m.triangles)]


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("scene", ["random", "city"])
def test_single_instance_tables_bit_identical(monkeypatch, scene, stable):
    monkeypatch.setenv("RADIANCE_STABLE_FRAMES", "1" if stable else "0")
    meshes = _mesh_random() if scene == "random" else [_city_cut()]
    jt, tt = _build_pair(meshes)
    assert jt.blob == tt.blob
    jds = jt.device_scene()
    tds = tt.device_scene("cpu", stable_frames=stable)
    assert tds.knode_f is not None and tds.stable_frames == stable
    _assert_same(jds, tds)


@pytest.mark.parametrize("stable", [True, False])
def test_cornell_tables_bit_identical(monkeypatch, stable):
    monkeypatch.setenv("RADIANCE_STABLE_FRAMES", "1" if stable else "0")
    jds = jproc.cornell_box().device_scene()
    tds = tproc.cornell_box(device="cpu").tlas.device_scene(
        "cpu", stable_frames=stable)
    assert tds.knode_f is None and len(tds.kblas) == 7
    _assert_same(jds, tds)


def test_scene_from_numpy_round_trip():
    jds = jproc.cornell_box().device_scene()
    arrays = {k: getattr(jds, k) for k in SINGLE}
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in arrays.items()}
    arrays["node_min"] = np.asarray(jds.node_min)      # extra: ignored
    arrays["kblas"] = tuple(tuple(np.asarray(x) for x in e)
                            for e in jds.kblas)
    arrays["inst_kblas"] = jds.inst_kblas
    tds = tdevice.scene_from_numpy(arrays, jds.stable_frames, "cpu")
    _assert_same(jds, tds)
    own = tproc.cornell_box(device="cpu").device_scene("cpu")
    _assert_same(jds, own)


def test_leaf_cap_argument():
    from radiance_tpu_torch.bvh import kernel_pack
    with pytest.raises(ValueError):
        kernel_pack.build_kernel_tables([0], [0], [0], np.zeros((1, 3)),
                                        np.zeros((1, 3)), None, None,
                                        leaf_cap=100)
