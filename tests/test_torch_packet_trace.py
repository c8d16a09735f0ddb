"""radiance_tpu_torch packet tracing vs the JAX packet kernel.

The port's plain PyTorch version of the packet kernel (the CPU route of
radiance_tpu_torch.ops.packet_trace) against the Pallas kernel run in
interpret mode, on the shapes of tests/test_packet_trace.py and the
near-origin case of tests/test_stable_frames.py.  Both packages trace
the same tables (the JAX DeviceScene's arrays handed over as numpy) and
the same rays, made from a seed with numpy.

Tolerances: hit/miss agreement >= 0.999 and prim agreement >= 0.999 on
rays both hit (the traversal bars of the port); t rtol 1e-5 (matmul
summation order); barycentrics atol 1e-4.

Besides random rays, the diffuse bounce waves of a small interior hall,
sorted as the engine's argsort route sorts them: packets whose rays fan
out across their octant, the waves the kernel's ray-private walk was
built for (csrc/packet_trace.cu), with the plain version as its yardstick.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.api import accel
from radiance_tpu.core import types
from radiance_tpu.ops import packet_trace as jpk
from radiance_tpu.scene import procedural as jprocedural
from radiance_tpu.ops.intersect import FLT_MAX

from radiance_tpu_torch.bvh import device as tdevice
from radiance_tpu_torch.ops import intersect as tintersect
from radiance_tpu_torch.ops import packet_trace as tpk

from test_bvh import random_mesh
from test_torch_cuda import diffuse_bounces, hall_primary_hits
from test_traversal import gen_rays

TMIN, TMAX = 1e-3, 1e3


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


def torch_scene(ds):
    """The port's DeviceScene holding the JAX scene's arrays."""
    fields = {k: getattr(ds, k) for k in (
        "node_packed", "bundle_packed", "inst_transform", "inst_inv",
        "inst_id", "inst_custom", "inst_sbt", "inst_blas_root", "knode_f",
        "kleaf", "kprim", "ktri_geo")}
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in fields.items()}
    arrays["kblas"] = (None if ds.kblas is None else
                       tuple(tuple(np.asarray(x) for x in e)
                             for e in ds.kblas))
    arrays["inst_kblas"] = ds.inst_kblas
    return tdevice.scene_from_numpy(arrays, ds.stable_frames, "cpu")


def single_scene(n_tris=300, seed=10, transform=None):
    rng = np.random.default_rng(seed)
    blas = accel.BuildBottomAccelStruct(random_mesh(rng, n_tris, spread=5.0))
    tf = np.eye(4, dtype=np.float32) if transform is None else transform
    inst = types.Instance(transform=tf, sbt_offset=0, custom_instance_id=0,
                          bottom_accel_struct=blas)
    return accel.BuildTopAccelStruct([inst]).device_scene()


def compare(ref, got, *, check_bary=True):
    t_ref, t_got = np.asarray(ref.t), got.t.numpy()
    hit_ref, hit_got = t_ref < FLT_MAX, t_got < FLT_MAX
    assert (hit_ref == hit_got).mean() >= 0.999
    both = hit_ref & hit_got
    prim_ref, prim_got = np.asarray(ref.prim), got.prim.numpy()
    if both.any():
        assert (prim_ref[both] == prim_got[both]).mean() >= 0.999
        np.testing.assert_allclose(t_got[both], t_ref[both], rtol=1e-5)
    same = both & (prim_ref == prim_got)
    np.testing.assert_array_equal(got.slot.numpy()[same],
                                  np.asarray(ref.slot)[same])
    if check_bary:
        np.testing.assert_allclose(got.b1.numpy()[same],
                                   np.asarray(ref.b1)[same], atol=1e-4)
        np.testing.assert_allclose(got.b2.numpy()[same],
                                   np.asarray(ref.b2)[same], atol=1e-4)
    assert np.all(prim_got[~hit_got] == -1)
    assert np.all(got.slot.numpy()[~hit_got] == -1)
    return hit_got


def trace_both(ds, o, d, **kw):
    ref = jpk.trace_rays_packet(ds, jnp.asarray(o), jnp.asarray(d),
                                jnp.float32(TMIN), jnp.float32(TMAX),
                                **{k: (jnp.asarray(v) if k == "live" else v)
                                   for k, v in kw.items()})
    got = tpk.trace_rays_packet(torch_scene(ds), torch.from_numpy(o),
                                torch.from_numpy(d), TMIN, TMAX,
                                **{k: (torch.from_numpy(v) if k == "live"
                                       else v) for k, v in kw.items()})
    return ref, got


@pytest.mark.parametrize("case", ["identity", "transformed"])
def test_closest_hit_matches_pallas(case):
    if case == "identity":
        ds = single_scene()
        o, d = gen_rays(np.random.default_rng(1), 600, spread=8.0)
    else:
        c, s = np.cos(0.6), np.sin(0.6)
        tf = np.array([[c * 2, 0, s * 2, 1.0], [0, 2, 0, -2.0],
                       [-s * 2, 0, c * 2, 3.0], [0, 0, 0, 1]], np.float32)
        ds = single_scene(n_tris=150, seed=11, transform=tf)
        o, d = gen_rays(np.random.default_rng(2), 256, spread=10.0)
    assert tpk.supports(torch_scene(ds))
    ref, got = trace_both(ds, o, d)
    hit = compare(ref, got)
    assert hit.mean() > 0.05        # the case is not vacuous


def test_any_hit_matches_pallas():
    ds = single_scene(n_tris=200, seed=12)
    o, d = gen_rays(np.random.default_rng(3), 256, spread=6.0)
    ref, got = trace_both(ds, o, d, any_hit=True)
    occ_ref = np.asarray(ref.t) < FLT_MAX
    occ_got = got.t.numpy() < FLT_MAX
    assert (occ_ref == occ_got).mean() >= 0.999
    assert occ_got.any()
    # occlusion t is a true hit: never nearer than the closest hit
    closest = tpk.build_tracer(torch_scene(ds))(
        torch.from_numpy(o), torch.from_numpy(d), TMIN, TMAX)
    assert np.all(got.t.numpy()[occ_got]
                  >= closest.t.numpy()[occ_got] - 1e-5)


def test_miss_everything():
    ds = single_scene(n_tris=50, seed=13)
    o = np.tile([[100.0, 100.0, 100.0]], (8, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (8, 1)).astype(np.float32)
    ref, got = trace_both(ds, o, d)
    compare(ref, got)
    assert not got.hit.any()
    assert np.all(got.t.numpy() == np.float32(FLT_MAX))


def test_zero_direction_rays_miss():
    ds = single_scene(n_tris=50, seed=13)
    o = np.zeros((4, 3), np.float32)
    d = np.zeros((4, 3), np.float32)
    got = tpk.trace_rays_packet(torch_scene(ds), torch.from_numpy(o),
                                torch.from_numpy(d), TMIN, TMAX)
    assert np.all(got.t.numpy() == np.float32(FLT_MAX))
    assert np.all(got.prim.numpy() == -1)


def test_multi_instance_sweeps_match_pallas():
    rng = np.random.default_rng(31)
    blas1 = accel.BuildBottomAccelStruct(random_mesh(rng, 120, spread=2.0))
    blas2 = accel.BuildBottomAccelStruct(random_mesh(rng, 80, spread=2.0))

    def tf(tx, ty, tz, ry=0.0, s=1.0):
        c, si = np.cos(ry), np.sin(ry)
        return np.array([[c * s, 0, si * s, tx], [0, s, 0, ty],
                         [-si * s, 0, c * s, tz], [0, 0, 0, 1]], np.float32)

    ds = accel.BuildTopAccelStruct([
        types.Instance(tf(0, 0, 0), 0, 0, blas1),
        types.Instance(tf(6, 1, -2, ry=0.7), 0, 1, blas2),
        types.Instance(tf(-6, -1, 3, ry=1.9, s=1.5), 2, 2, blas1),
    ]).device_scene()
    ts = torch_scene(ds)
    assert not tpk.supports(ts) and tpk.supports_multi(ts)
    assert ts.inst_kblas == (0, 1, 0)
    o, d = gen_rays(np.random.default_rng(5), 300, spread=9.0)
    ref = jpk.trace_rays_packet_multi(ds, jnp.asarray(o), jnp.asarray(d),
                                      jnp.float32(TMIN), jnp.float32(TMAX))
    got = tpk.trace_rays_packet_multi(ts, torch.from_numpy(o),
                                      torch.from_numpy(d), TMIN, TMAX)
    hit = compare(ref, got)
    assert len(set(got.slot.numpy()[hit])) == 3


@pytest.fixture(scope="module")
def hall_bounces():
    """A 4000-triangle interior hall (the JAX scene) and a diffuse bounce
    wave off its 48 x 24 pinhole primaries' hits (traced by the plain
    version), sorted as the engine sorts a bounce wave."""
    verts, tris, meta = jprocedural.interior_hall(4000, seed=11)
    blas = accel.BuildBottomAccelStruct(types.Mesh(verts, tris))
    ds = accel.BuildTopAccelStruct([types.Instance(
        np.eye(4, dtype=np.float32), 0, 0, blas)]).device_scene()
    o, d, t, prim = hall_primary_hits(torch_scene(ds), meta, 48, 24)
    assert len(t) > 0.9 * 48 * 24
    return (ds, *diffuse_bounces(verts, tris, o, d, t, prim, 6))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_diffuse_bounces_match_pallas(hall_bounces, any_hit, masked):
    """The hall's diffuse bounce wave, closest and any hit, every ray
    live or a random half: the plain version against the Pallas kernel
    (packets of one octant whose rays still fan out across it: the
    packet's summed direction lies at least 30 degrees off some ray's)."""
    ds, o, d = hall_bounces
    dd = torch.from_numpy(d)
    n = (d.shape[0] // tpk.PACKET_RAYS) * tpk.PACKET_RAYS
    pk_d = dd[:n].view(-1, tpk.PACKET_RAYS, 3)
    s = pk_d.sum(dim=1, keepdim=True)
    cos = (pk_d * s).sum(-1) / s.norm(dim=-1)
    assert float((cos.amin(dim=1) < np.cos(np.pi / 6)).float().mean()) > 0.9
    kw = dict(any_hit=any_hit)
    if masked:
        kw["live"] = np.random.default_rng(7).uniform(size=d.shape[0]) < 0.5
    ref, got = trace_both(ds, o, d, **kw)
    if any_hit:
        occ_ref = np.asarray(ref.t) < FLT_MAX
        occ_got = got.t.numpy() < FLT_MAX
        assert (occ_ref == occ_got).mean() >= 0.999 and occ_got.mean() > 0.3
    else:
        assert compare(ref, got).mean() > 0.3
    if masked:
        assert not (got.t.numpy() < FLT_MAX)[~kw["live"]].any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_live_mask_matches_pallas(any_hit):
    ds = single_scene()
    rng = np.random.default_rng(5)
    o, d = gen_rays(rng, 700, spread=8.0)
    live = rng.uniform(size=700) < 0.3
    ref, got = trace_both(ds, o, d, live=live, any_hit=any_hit)
    if any_hit:
        assert ((np.asarray(ref.t) < FLT_MAX)
                == (got.t.numpy() < FLT_MAX)).mean() >= 0.999
    else:
        compare(ref, got)
    assert np.all(got.t.numpy()[~live] == np.float32(FLT_MAX))
    assert np.all(got.prim.numpy()[~live] == -1)


def test_live_mask_nan_dead_lanes():
    """NaN/Inf in dead lanes must not reach live lanes of the packet."""
    ds = single_scene()
    rng = np.random.default_rng(8)
    o, d = gen_rays(rng, 640, spread=8.0)
    live = rng.uniform(size=640) < 0.3
    o_bad, d_bad = o.copy(), d.copy()
    o_bad[~live] = np.inf
    d_bad[~live] = np.nan
    ref = jpk.trace_rays_packet(ds, jnp.asarray(o), jnp.asarray(d),
                                jnp.float32(TMIN), jnp.float32(TMAX))
    got = tpk.trace_rays_packet(torch_scene(ds), torch.from_numpy(o_bad),
                                torch.from_numpy(d_bad), TMIN, TMAX,
                                live=torch.from_numpy(live))
    np.testing.assert_allclose(got.t.numpy()[live], np.asarray(ref.t)[live],
                               rtol=1e-5)
    np.testing.assert_array_equal(got.prim.numpy()[live],
                                  np.asarray(ref.prim)[live])
    assert np.all(got.t.numpy()[~live] == np.float32(FLT_MAX))


@pytest.mark.parametrize("stable", ["0", "1"])
def test_near_origin_frames_match_pallas(monkeypatch, stable):
    """test_stable_frames.py's near-origin case, both frame modes."""
    monkeypatch.setenv("RADIANCE_STABLE_FRAMES", stable)
    ds = single_scene(n_tris=350, seed=9)
    assert ds.stable_frames == (stable == "1")
    rng = np.random.default_rng(2)
    o = rng.uniform(-6, 6, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref, got = trace_both(ds, o, d)
    assert compare(ref, got).mean() > 0.05


def test_far_grazing_scene_vs_soup():
    """The 400-triangle far-from-origin scene of test_stable_frames.py:
    the plain version on stable tables agrees with the brute-force soup."""
    offset = np.array([600.0, 400.0, 500.0], np.float32)
    rng = np.random.default_rng(5)
    mesh = random_mesh(rng, 400, spread=5.0)
    verts = mesh.vertices + offset
    from radiance_tpu_torch.api import accel as taccel
    from radiance_tpu_torch.core import types as ttypes
    blas = taccel.BuildBottomAccelStruct(ttypes.Mesh(verts, mesh.triangles))
    ts = taccel.BuildTopAccelStruct([ttypes.Instance(
        np.eye(4, dtype=np.float32), 0, 0, blas)]).device_scene("cpu")
    rng = np.random.default_rng(7)
    n = 1024
    o = np.tile((offset + [0, 0, 60.0]).astype(np.float32), (n, 1))
    d = offset + rng.uniform(-5, 5, (n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    got = tpk.trace_rays_packet(ts, o_t, d_t, TMIN, 1e4)
    tri = torch.from_numpy(mesh.triangles.astype(np.int64))
    v = torch.from_numpy(verts)
    t_ref, _, _, _ = tintersect.intersect_triangle_soup(
        o_t, d_t, v[tri[:, 0]], v[tri[:, 1]] - v[tri[:, 0]],
        v[tri[:, 2]] - v[tri[:, 0]], TMIN, 1e4)
    hr = t_ref.numpy() < FLT_MAX
    hg = got.t.numpy() < FLT_MAX
    assert (hr == hg).mean() >= 0.999
    assert hr.mean() > 0.2
    both = hr & hg
    np.testing.assert_allclose(got.t.numpy()[both], t_ref.numpy()[both],
                               rtol=1e-4)


def test_coherence_key_matches_jax():
    rng = np.random.default_rng(4)
    o, d = gen_rays(rng, 500, spread=7.0)
    d[:5] = 0.0
    ref = np.asarray(jpk.coherence_key(jnp.asarray(o), jnp.asarray(d)))
    got = tpk.coherence_key(torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("packet", [32, 64, 128, 1024])
@pytest.mark.parametrize("n", [1, 31, 1025, 5000])
def test_packet_bases_match_plain_form(packet, n):
    """The kernel's per-packet table bases against a loop over packets:
    the octant of each packet's summed direction (exact sums: quarter
    steps), rays past n adding nothing; a zero sum is not negative."""
    rng = np.random.default_rng(n + packet)
    d = (rng.integers(-4, 5, (n, 3)) / 4.0).astype(np.float32)
    d[: n // 3, 2] = 0.0
    nk = 7
    got = tpk.packet_bases(torch.from_numpy(d), packet, nk).numpy()
    ref = []
    for p in range(-(-n // packet)):
        s = d[p * packet:(p + 1) * packet].sum(axis=0)
        ref.append(nk * int((s[0] < 0) + 2 * (s[1] < 0) + 4 * (s[2] < 0)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_kernel_wrapper_refuses_cpu_tensors():
    """packet_trace_cuda never runs on CPU tensors: packet_trace routes
    those to the plain version."""
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tpk.packet_trace_cuda(x, x, None, torch.zeros(8, 16),
                              torch.zeros(1, 16, 512), TMIN, 1e3,
                              any_hit=False, stable=True)
