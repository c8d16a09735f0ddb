"""The kernel-leaf collapse cap in radiance_tpu_torch vs radiance_tpu.

The JAX package fixes its cap at import (RADIANCE_LEAF_CAP, a multiple of
32 in [32, 512]), so its side runs in a subprocess with the variable set,
as tests/test_leaf_cap.py does, and writes its tables, rays and hits to
an .npz under tmp_path.  The port takes the cap as an argument
(build_device_scene / TopAccelStruct.device_scene(leaf_cap=)).

Bars: the tables byte-identical (the same numpy build); the port's
stream3 wave and packet-kernel plain version against the JAX subprocess's
two-level walk and interpret-mode stream3 at tests/test_leaf_cap.py's
tolerances (hit/miss equal, t rtol 2e-3 atol 1e-4, prim equal where both
hit); every cap the JAX check refuses, the port refuses, with the same
variable named in the message.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radiance_tpu.bvh import kernel_pack as jkp

from radiance_tpu_torch.api import accel as taccel
from radiance_tpu_torch.bvh import device as tdevice
from radiance_tpu_torch.bvh import kernel_pack as tkp
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.ops import packet_trace as tpk
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops import stream3_multi as tsm
from radiance_tpu_torch.ops.intersect import FLT_MAX

from test_bvh import random_mesh
from test_torch_stream3 import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TMIN, TMAX = 1e-3, 1e3
TABLES = ("knode_f", "kleaf", "kprim", "ktri_geo", "node_packed",
          "bundle_packed")
MULTI = ((200, 31), (150, 32), (260, 33))   # (triangles, seed) a BLAS

_SUBPROC = r"""
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp

from radiance_tpu.api import accel
from radiance_tpu.bvh import kernel_pack
from radiance_tpu.core import types
assert kernel_pack.KERNEL_MAX_TRIS == {cap}, kernel_pack.KERNEL_MAX_TRIS

from radiance_tpu.ops import stream3, traversal
from test_bvh import random_mesh
from test_packet_trace import _single_instance_scene
from test_traversal import gen_rays

out = {{}}
ds = _single_instance_scene(n_tris=700, seed=4)
for k in {tables!r}:
    out["single/" + k] = np.asarray(getattr(ds, k))
insts = []
for i, (n, seed) in enumerate({multi!r}):
    blas = accel.BuildBottomAccelStruct(
        random_mesh(np.random.default_rng(seed), n, spread=5.0))
    tf = np.eye(4, dtype=np.float32)
    tf[0, 3] = 12.0 * i
    insts.append(types.Instance(tf, 0, i, blas))
ms = accel.BuildTopAccelStruct(insts).device_scene()
for b, e in enumerate(ms.kblas):
    for k, a in zip(("knode_f", "kleaf", "kprim", "ktri_geo"), e):
        out[f"multi/{{b}}/{{k}}"] = np.asarray(a)
out["multi/inst_kblas"] = np.asarray(ms.inst_kblas)

rng = np.random.default_rng(2)
o, d = gen_rays(rng, 512, spread=8.0)
out["o"], out["d"] = o, d
o, d = jnp.asarray(o), jnp.asarray(d)
ref = traversal.trace_rays(ds, o, d, 1e-3, 1e3)
out["walk_t"], out["walk_prim"] = np.asarray(ref.t), np.asarray(ref.prim)
if {stream3!r}:
    assert stream3.supports(ds)
    got = stream3.trace_rows_stream3(ds, stream3.rows_from_aos(o, d), 1e-3,
                                     1e3, interpret=True)
    out["s3_t"], out["s3_prim"] = np.asarray(got.t), np.asarray(got.prim)
np.savez({path!r}, **out)
print("leaf-cap tables written")
"""


@pytest.fixture(scope="module", params=[64, 256])
def jax_side(request, tmp_path_factory):
    """(cap, arrays) of the JAX package built under RADIANCE_LEAF_CAP=cap
    in a subprocess; interpret-mode stream3 at cap 64 only (the JAX
    test's case)."""
    cap = request.param
    path = str(tmp_path_factory.mktemp(f"cap{cap}") / "jax.npz")
    code = _SUBPROC.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                           cap=cap, tables=TABLES, multi=MULTI,
                           stream3=cap == 64, path=path)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, RADIANCE_LEAF_CAP=str(cap),
                                JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr
    with np.load(path) as z:
        return cap, dict(z)


def port_single(cap):
    mesh = random_mesh(np.random.default_rng(4), 700, spread=5.0)
    blas = taccel.BuildBottomAccelStruct(ttypes.Mesh(mesh.vertices,
                                                     mesh.triangles))
    return taccel.BuildTopAccelStruct([ttypes.Instance(
        np.eye(4, dtype=np.float32), 0, 0, blas)]).device_scene(
            "cpu", leaf_cap=cap)


def port_multi(cap):
    insts = []
    for i, (n, seed) in enumerate(MULTI):
        m = random_mesh(np.random.default_rng(seed), n, spread=5.0)
        blas = taccel.BuildBottomAccelStruct(ttypes.Mesh(m.vertices,
                                                         m.triangles))
        tf = np.eye(4, dtype=np.float32)
        tf[0, 3] = 12.0 * i
        insts.append(ttypes.Instance(tf, 0, i, blas))
    return taccel.BuildTopAccelStruct(insts).device_scene("cpu",
                                                          leaf_cap=cap)


def test_tables_byte_identical_at_the_cap(jax_side):
    """The single-instance tables and every BLAS's kblas tables of a
    3-instance scene, byte for byte; the cap recorded on the scene and on
    the many-instance tables, and inferred from JAX arrays."""
    cap, j = jax_side
    tds = port_single(cap)
    assert tds.leaf_cap == cap and tds.kleaf.shape[2] == 4 * cap
    for k in TABLES:
        a, b = j["single/" + k], getattr(tds, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    mds = port_multi(cap)
    assert mds.leaf_cap == cap
    assert tuple(j["multi/inst_kblas"]) == mds.inst_kblas
    for bi, e in enumerate(mds.kblas):
        for k, b in zip(("knode_f", "kleaf", "kprim", "ktri_geo"), e):
            assert j[f"multi/{bi}/{k}"].tobytes() == b.numpy().tobytes(), k
    mt = tsm.MultiTables(mds)
    assert mt.leaf_cap == cap and mt.kleaf_cat.shape[2] == 4 * cap
    carried = tdevice.scene_from_numpy(
        {k: j["single/" + k] for k in TABLES}
        | {"inst_inv": np.eye(4, dtype=np.float32)[None],
           "inst_transform": np.eye(4, dtype=np.float32)[None]},
        True, "cpu")
    assert carried.leaf_cap == cap


def test_leaf_cap_parity(jax_side):
    """tests/test_leaf_cap.py's case (700 triangles, 512 rays): the
    port's packet-kernel plain version at the cap, and at 64 its stream3
    wave, against the JAX walk and the JAX interpret-mode stream3 built
    at the same cap."""
    cap, j = jax_side
    tds = port_single(cap)
    o, d = torch.from_numpy(j["o"]), torch.from_numpy(j["d"])
    got = {"packet": tpk.trace_rays_packet(tds, o, d, TMIN, TMAX)}
    refs = {"walk": (j["walk_t"], j["walk_prim"])}
    if cap == 64:
        assert ts3.supports(tds)
        got["stream3"] = ts3.trace_rows_stream3(
            tds, ts3.rows_from_aos(o, d), TMIN, TMAX)
        refs["jax_stream3"] = (j["s3_t"], j["s3_prim"])
    for name, rec in got.items():
        t_got, p_got = rec.t.numpy(), rec.prim.numpy()
        for rname, (t_ref, p_ref) in refs.items():
            hit_ref, hit_got = t_ref < FLT_MAX, t_got < FLT_MAX
            np.testing.assert_array_equal(hit_ref, hit_got,
                                          err_msg=f"{name} vs {rname}")
            both = hit_ref & hit_got
            assert both.sum() > 50
            np.testing.assert_allclose(t_got[both], t_ref[both], rtol=2e-3,
                                       atol=1e-4, err_msg=f"{name} {rname}")
            np.testing.assert_array_equal(p_got[both], p_ref[both],
                                          err_msg=f"{name} vs {rname}")


CAPS = [-32, 0, 16, 31, 32, 48, 64, 96, 100, 128, 160, 256, 480, 500, 512,
        513, 544, 1024]


@pytest.mark.parametrize("cap", CAPS)
def test_port_refuses_what_jax_refuses(monkeypatch, cap):
    """The JAX package's import-time check (_leaf_cap_from_env, read here
    with the variable set) and the port's, on every entry that builds
    tables: the same verdict, and the port's message names the
    variable."""
    monkeypatch.setenv("RADIANCE_LEAF_CAP", str(cap))
    try:
        jkp._leaf_cap_from_env()
        jax_ok = True
    except ValueError as e:
        jax_ok = False
        assert "RADIANCE_LEAF_CAP" in str(e)
    mesh = random_mesh(np.random.default_rng(1), 40, spread=3.0)
    tlas = taccel.BuildTopAccelStruct([ttypes.Instance(
        np.eye(4, dtype=np.float32), 0, 0, taccel.BuildBottomAccelStruct(
            ttypes.Mesh(mesh.vertices, mesh.triangles)))])
    builders = (lambda: tkp.check_leaf_cap(cap),
                lambda: tlas.device_scene("cpu", leaf_cap=cap),
                lambda: tdevice.build_device_scene(
                    tlas.nodes, tlas.instances,
                    {off: (b.nodes, b.faces, b.vertices)
                     for off, b in tlas.blas_offsets},
                    leaf_cap=cap, device="cpu"))
    for build in builders:
        if jax_ok:
            build()
        else:
            with pytest.raises(ValueError, match="RADIANCE_LEAF_CAP"):
                build()
    for bad in (64.0, "64", True):
        with pytest.raises(ValueError):
            tkp.check_leaf_cap(bad)
