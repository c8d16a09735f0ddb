"""radiance_tpu_torch's TLAS-native many-instance route vs radiance_tpu's.

The concatenated MultiTables fields, supports_native, _prep_tlas and
_glue_tlas of the port against the JAX functions (ops/stream3_multi.py,
:110-152 and :404-571) array for array; trace_rows_tlas (the plain
versions of the stream3 kernels on the CPU) against the JAX two-level
walk (an exact oracle), the port's instance scan and, on one small wave,
the JAX trace_rows_tlas with its Pallas kernels in interpret mode; its
forced residual, a refit that moves BLASes between slots, the route
selector and the engine's images on the native route against the JAX
engine; and that a temporal bound (blk_bound) gives the unbounded
trace.  Each package builds its own scene from the same numpy geometry:
tests/test_stream3_multi.py::_tlas_scene's 9 instances of 3 shared
BLASes under rotation, scale and placement, from the same seed.

Bars: prep, glue and the tables exact; traces the parity bars of PERF.md
section 2 (hit/miss and prim agreement >= 0.999, instance slot >= 0.999
on rays both hit, p99 relative |dt| <= 1e-5; occlusion on occluded or
not); against the JAX walk, whose instance transform rounds differently,
t to rtol 2e-3 atol 1e-4 as tests/test_stream3_multi.py holds its own
native route (:277-291).  Images: the golden tests' bars, u8 RMSE < 2.0
(depth 1) and < 3.0 (depth 2).
"""

import math
import types as pytypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.api.sbt import ShaderBindingTable as JSBT
from radiance_tpu.engine import shaders as jshaders
from radiance_tpu.engine.pathtracer import WavefrontPathTracer as JTracer
from radiance_tpu.ops import stream3 as js3
from radiance_tpu.ops import stream3_multi as jsm
from radiance_tpu.ops import traversal
from radiance_tpu.shading import camera as jcam

from radiance_tpu_torch.api import accel as taccel
from radiance_tpu_torch.api.sbt import ShaderBindingTable as TSBT
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.engine import pathtracer as tpath
from radiance_tpu_torch.engine import shaders as tshaders
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops import stream3_multi as tsm
from radiance_tpu_torch.ops import stream3_stages as tstg
from radiance_tpu_torch.ops.intersect import FLT_MAX
from radiance_tpu_torch.shading import camera as tcam

from test_torch_stream3 import _one_torch_thread  # noqa: F401
from test_torch_stream3_multi import (_render_inputs, multi_geometry,
                                      random_wave, scene_pair, trows)

TMIN, TMAX = 1e-3, 1e3
BARS = dict(hit=0.999, prim=0.999, slot=0.999, rel_t_p99=1e-5)
RMSE_BAR = {1: 2.0, 2: 3.0}
PREP_OUT = ("feats_t", "scal", "smeta", "bscal", "order", "pkt_of",
            "inst_of", "alive", "pool_of")


def _mat_rot(rng):
    """tests/test_stream3_multi.py::_mat_rot."""
    a, b = rng.uniform(0, 6.28, 2)
    rz = np.array([[math.cos(a), -math.sin(a), 0],
                   [math.sin(a), math.cos(a), 0], [0, 0, 1]])
    ry = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0],
                   [-math.sin(b), 0, math.cos(b)]])
    return (rz @ ry).astype(np.float32)


def tlas_geometry(n_inst=9, n_uniq=3, tris_per=150, seed=7):
    """tests/test_stream3_multi.py::_tlas_scene's meshes and transforms,
    from the same seed: instance i holds mesh i % n_uniq."""
    rng = np.random.default_rng(seed)
    meshes = []
    for _ in range(n_uniq):
        centers = rng.uniform(-2, 2, size=(tris_per, 3)).astype(np.float32)
        offs = rng.normal(scale=0.35, size=(tris_per, 3, 3)).astype(
            np.float32)
        meshes.append((centers[:, None, :] + offs).reshape(-1, 3))
    tfs = []
    for _ in range(n_inst):
        tf = np.eye(4, dtype=np.float32)
        tf[:3, :3] = _mat_rot(rng) * rng.uniform(0.5, 2.0)
        tf[:3, 3] = rng.uniform(-10, 10, 3)
        tfs.append(tf)
    return meshes, tfs, [i % n_uniq for i in range(n_inst)]


@pytest.fixture(scope="module")
def nine():
    """(JAX scene, port scene, JAX MultiTables, port MultiTables)."""
    jds, tds = scene_pair(tlas_geometry())
    return jds, tds, jsm.MultiTables(jds), tsm.MultiTables(tds)


def padded_rows(o, d, live=None):
    """The wave as both routes pad it (whole groups of G packets): (JAX
    rows, JAX live, port rows, port live); the JAX rows' dead lanes
    parked as trace_rows_tlas parks them."""
    n = len(o)
    pad = (-n) % (js3.G * js3.PKT)
    jr = tuple(jnp.concatenate([r, jnp.broadcast_to(r[:1], (pad,))])
               for r in js3.rows_from_aos(jnp.asarray(o), jnp.asarray(d)))
    jl = None
    tr = trows(o, d)
    tl = None
    if live is not None:
        jl = jnp.concatenate([jnp.asarray(live), jnp.zeros(pad, bool)])
        jr = tuple(jnp.where(jl, r, jnp.float32(1e30) if k < 3
                             else jnp.float32(1.0))
                   for k, r in enumerate(jr))
        tl = torch.from_numpy(live)
        tr = ts3.park_dead(tr, tl)
    tr, tl = ts3._pad_wave(tr, tl)
    return jr, jl, tr, tl


def hold_hits(rec, ref_t, ref_prim, ref_slot, live=None):
    """PERF.md section 2's bars of rec against an exact tracer's arrays."""
    t, prim, slot = rec.t.numpy(), rec.prim.numpy(), rec.slot.numpy()
    ref_t, ref_prim = np.asarray(ref_t), np.asarray(ref_prim)
    ref_slot = np.asarray(ref_slot)
    ok = np.ones(len(t), bool) if live is None else live
    hr, hg = ref_t < FLT_MAX, t < FLT_MAX
    assert (hr == hg)[ok].mean() >= BARS["hit"]
    both = hr & hg & ok
    assert both.sum() >= 20
    assert (prim == ref_prim)[both].mean() >= BARS["prim"]
    assert (slot == ref_slot)[both].mean() >= BARS["slot"]
    rel = np.abs(t - ref_t)[both] / np.maximum(ref_t[both], 1e-30)
    assert np.quantile(rel, 0.99) <= BARS["rel_t_p99"]
    assert (slot != -2).all()


# ----------------------------------------------------------- tables

@pytest.mark.parametrize("geom", ["nine", "five"])
def test_concatenated_tables_match_jax(geom):
    jds, tds = scene_pair(tlas_geometry() if geom == "nine"
                          else multi_geometry())
    ref, got = jsm.MultiTables(jds), tsm.MultiTables(tds)
    for f in ("nodef_cat", "kleaf_cat", "aabb8_cat", "inst_node_off",
              "inst_nk"):
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    # leaf rows of nodef_cat hold global leaf ids: at least one BLAS past
    # the first is shifted
    assert (got.inst_node_off > 0).any()
    assert tsm.supports_native(got) and jsm.supports_native(ref)


@pytest.mark.parametrize("rows", [tstg.W_LEAF_MAX - 2, tstg.W_LEAF_MAX - 1])
def test_supports_native_at_the_leaf_limit(rows):
    """Leaf + 1 must stay below W_LEAF_MAX; held as JAX holds it."""
    mt = pytypes.SimpleNamespace(kleaf_cat=torch.empty(rows, 1))
    jmt = pytypes.SimpleNamespace(kleaf_cat=np.empty((rows, 1)))
    assert tstg.W_LEAF_MAX == js3.W_LEAF_MAX
    assert tsm.supports_native(mt) == jsm.supports_native(jmt) \
        == (rows == tstg.W_LEAF_MAX - 2)


def test_native_beyond_the_limit_takes_the_scan(nine, monkeypatch):
    """trace_rows_multi(native=True) on tables past the leaf limit runs the
    scan (its diag), as RADIANCE_MULTI=native does in the reference."""
    _, tds, _, tm = nine
    o, d = random_wave(3, 1024)
    monkeypatch.setattr(tsm, "W_LEAF_MAX", tm.kleaf_cat.shape[0] + 1)
    assert not tsm.supports_native(tm)
    _, diag = tsm.trace_rows_multi(tds, tm, trows(o, d), TMIN, TMAX,
                                   native=True, with_diag=True)
    assert "instances_run" in diag


# ----------------------------------------------------------- prep, glue

@pytest.mark.parametrize("case", ["all", "live", "overflow"])
def test_prep_tlas_matches_jax(nine, case):
    """Every output of _prep_tlas equal to the JAX one: the whole wave,
    a 40% dead live mask (dead lanes NaN), and a pool of 16 slots that
    the wave's pairs overflow."""
    jds, tds, jm, tm = nine
    o, d = random_wave(2, 2048)
    o[:1024] = o[:1024] * 0.2 + np.float32([0.0, 0.0, 20.0])
    d[:1024] = np.float32([0.0, 0.0, -1.0])      # one coherent packet
    live = None
    if case == "live":
        live = np.random.default_rng(4).random(2048) > 0.4
        o[~live] = np.nan
    jr, jl, tr, tl = padded_rows(o, d, live)
    scap = 16 if case == "overflow" else 72
    ref = jsm._prep_tlas(jm, jds.inst_inv[:9], jr, TMIN, TMAX, jl, scap,
                         stable=True)
    ref = ref[:4] + ref[5:]                       # no lim in the port
    got = tsm._prep_tlas(tm, tds.inst_inv[:9], tr, TMIN, TMAX, tl, scap,
                         stable=True)
    for name, a, b in zip(PREP_OUT, ref, got):
        a = np.asarray(a)
        b = b.numpy().astype(a.dtype) if name == "order" else b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    pool = got[-1].numpy()
    assert (pool.any() if case == "overflow" else not pool.any())
    assert got[7].sum() > 4


def test_glue_tlas_matches_jax_with_exact_ties():
    """_glue_tlas on crafted slot results: two packets, 7 slots (two dead),
    exact t ties across instances (the per-field max decides prim, b1,
    b2 and the instance), misses, and a dead slot holding the nearest t."""
    rng = np.random.default_rng(0)
    npk, scap, pkt = 3, 7, js3.PKT
    out = np.zeros((scap, pkt, 4), np.float32)
    out[..., 0] = rng.uniform(1.0, 5.0, (scap, pkt)).astype(np.float32)
    out[..., 1] = rng.integers(0, 50, (scap, pkt))
    out[..., 2:] = rng.uniform(0, 0.5, (scap, pkt, 2))
    miss = rng.random((scap, pkt)) < 0.3
    miss[:4, :200] = False
    out[miss, 0], out[miss, 1], out[miss, 2:] = FLT_MAX, -1.0, 0.0
    out[1, :100, 0] = out[0, :100, 0]             # ties, packet 0
    out[3, 50:150, 0] = out[2, 50:150, 0]         # ties, packet 1
    out[4, :, 0] = 0.5                            # a dead slot's nearer t
    pkt_of = np.int32([0, 0, 1, 1, 1, 3, 2])
    inst_of = np.int32([4, 2, 0, 7, 5, 0, 1])
    alive = np.array([1, 1, 1, 1, 0, 0, 1], bool)
    n = 3 * pkt - 100
    ref = jsm._glue_tlas(jnp.asarray(out), jnp.asarray(pkt_of),
                         jnp.asarray(inst_of), jnp.asarray(alive), npk, n)
    got = tsm._glue_tlas(torch.from_numpy(out), torch.from_numpy(pkt_of),
                         torch.from_numpy(inst_of), torch.from_numpy(alive),
                         npk, n)
    for f in ("t", "prim", "slot", "b1", "b2"):
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    # the ties went to the higher instance
    assert (got.slot[:100] == 4).all() and (got.t[:100] < FLT_MAX).all()
    assert (got.slot[pkt + 50:pkt + 150] == 7).all()


# ----------------------------------------------------------- traces

@pytest.mark.parametrize("occl", [False, True])
@pytest.mark.parametrize("case", ["random", "live"])
def test_trace_rows_tlas_matches_walk_and_scan(nine, case, occl):
    """The native route (plain kernels) against the JAX two-level walk and
    the port's instance scan on the same rays: random rays, and a
    coherent wave with a 35% dead live mask (dead lanes NaN)."""
    jds, tds, _, tm = nine
    n = 2048
    o, d = random_wave(2 if case == "random" else 9, n)
    live = None
    o_in = o
    if case == "live":
        o[:1024] = o[:1024] * 0.3 + np.float32([0.0, 0.0, 18.0])
        d[:1024] = d[:1024] * 0.15 + np.float32([0.0, 0.0, -1.0])
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        live = np.random.default_rng(9).random(n) > 0.35
        o_in = o.copy()
        o_in[~live] = np.nan
    tl = None if live is None else torch.from_numpy(live)
    ref = traversal.trace_rays(jds, jnp.asarray(o), jnp.asarray(d), TMIN,
                               TMAX, any_hit_terminate=occl)
    rec, diag = tsm.trace_rows_tlas(tds, tm, trows(o_in, d), TMIN, TMAX,
                                    live=tl, occl=occl, with_diag=True)
    scan = tsm.trace_rows_multi(tds, tm, trows(o_in, d), TMIN, TMAX,
                                live=tl, occl=occl)
    assert diag["slots_alive"] > 0 and diag["pool_overflow"] == 0
    hr = np.asarray(ref.t) < FLT_MAX
    assert hr.sum() > 50
    if live is not None:
        assert (rec.t.numpy()[~live] == np.float32(FLT_MAX)).all()
        assert (rec.slot.numpy()[~live] == -1).all()
    ok = np.ones(n, bool) if live is None else live
    if occl:
        assert np.isin(rec.t.numpy(), [0.0, np.float32(FLT_MAX)]).all()
        hg = rec.t.numpy() < FLT_MAX
        assert (hg == hr)[ok].all()
        sok = ok & (scan.slot.numpy() != -2)
        assert (hg == (scan.t.numpy() < FLT_MAX))[sok].all()
        return
    t, t_ref = rec.t.numpy(), np.asarray(ref.t)
    assert ((t < FLT_MAX) == hr)[ok].all()
    both = hr & ok
    np.testing.assert_allclose(t[both], t_ref[both], rtol=2e-3, atol=1e-4)
    close = both & (np.abs(t - t_ref) < 1e-5)
    assert (rec.slot.numpy() == np.asarray(ref.slot))[close].all()
    assert (rec.prim.numpy() == np.asarray(ref.prim))[close].all()
    # the scan: the same kernels over each instance's own tables
    sok = scan.slot.numpy() != -2
    assert sok.mean() > 0.95
    hold_hits(rec, scan.t.numpy(), scan.prim.numpy(), scan.slot.numpy(),
              ok & sok)


def test_trace_rows_tlas_matches_jax_native_route(nine):
    """1024 rays against the JAX trace_rows_tlas, its Pallas kernels in
    interpret mode (its lockstep emit): the same hits, prims and
    instances, t to the bars; neither route poisons a ray."""
    jds, tds, jm, tm = nine
    o, d = random_wave(5, 1024)
    ref = jsm.trace_rows_tlas(jds, jm, js3.rows_from_aos(jnp.asarray(o),
                                                         jnp.asarray(d)),
                              TMIN, TMAX, precision="f32", interpret=True,
                              ws=False)
    got = tsm.trace_rows_tlas(tds, tm, trows(o, d), TMIN, TMAX)
    assert (np.asarray(ref.slot) != -2).all()
    hold_hits(got, ref.t, ref.prim, ref.slot)


@pytest.mark.parametrize("occl", [False, True])
def test_forced_residual_gives_the_same_hits(nine, monkeypatch, occl):
    """A pool of 8 slots (most packets' slots do not fit), and then a
    step cap of 0 (every live slot is capped before its first step
    window: these BLASes' octant tables fit in one): every flagged packet
    is re-traced through the packet sweeps, and the hits equal an
    unforced run's."""
    _, tds, _, tm = nine
    o, d = random_wave(6, 3 * 1024)
    rows = trows(o, d)
    base, bd = tsm.trace_rows_tlas(tds, tm, rows, TMIN, TMAX, occl=occl,
                                   with_diag=True)
    assert bd["flagged"] == 0 and bd["residual_rays"] == 0
    small, sd = tsm.trace_rows_tlas(tds, tm, rows, TMIN, TMAX, occl=occl,
                                    scap=8, with_diag=True)
    assert sd["scap"] == 8 and sd["pool_overflow"] >= 3
    monkeypatch.setattr(ts3, "STEP_CAP", 0)
    capped, cd = tsm.trace_rows_tlas(tds, tm, rows, TMIN, TMAX, occl=occl,
                                     with_diag=True)
    assert cd["capped"] > 0
    for rec, dg in ((small, sd), (capped, cd)):
        assert dg["flagged"] >= 3 and dg["residual_rays"] == 3 * 1024
        hb, hg = base.t.numpy() < FLT_MAX, rec.t.numpy() < FLT_MAX
        assert (hb == hg).all() and hb.sum() > 50
        if occl:
            assert np.isin(rec.t.numpy(), [0.0, np.float32(FLT_MAX)]).all()
            continue
        hold_hits(rec, base.t.numpy(), base.prim.numpy(),
                  base.slot.numpy())


def test_refit_that_moves_blases_traces_as_a_fresh_build():
    """After a refit that puts other BLASes in the slots, the cached
    tables' per-slot fields are re-derived, and the native route traces
    bit for bit as on a fresh build of the refitted TLAS."""
    meshes, tfs, which = tlas_geometry()
    blases = [taccel.BuildBottomAccelStruct(ttypes.Mesh(
        v, np.arange(len(v), dtype=np.uint32).reshape(-1, 3)))
        for v in meshes]
    insts = [ttypes.Instance(tf, 0, i, blases[w])
             for i, (tf, w) in enumerate(zip(tfs, which))]
    tlas = taccel.BuildTopAccelStruct(insts)
    scene = tlas.device_scene("cpu")
    mt = tsm.multi_tables(scene)
    before = scene.inst_kblas
    new = np.stack([tfs[(i + 1) % 9] for i in range(9)])
    new[:, :3, 3] += np.float32([0.5, -0.25, 0.0])
    assert tlas.refit(new, "cpu") is scene and scene.multi is mt
    assert scene.inst_kblas != before
    fresh = taccel.BuildTopAccelStruct([
        ttypes.Instance(new[i], 0, i, blases[w])
        for i, w in enumerate(which)]).device_scene("cpu")
    fm = tsm.MultiTables(fresh)
    assert scene.inst_kblas == fresh.inst_kblas
    for f in ("inst_node_off", "inst_nk"):
        assert torch.equal(getattr(mt, f), getattr(fm, f)), f
    o, d = random_wave(7, 2048)
    got = tsm.trace_rows_tlas(scene, mt, trows(o, d), TMIN, TMAX)
    ref = tsm.trace_rows_tlas(fresh, fm, trows(o, d), TMIN, TMAX)
    assert (ref.t < FLT_MAX).sum() > 50
    assert got.t.numpy().tobytes() == ref.t.numpy().tobytes()
    assert torch.equal(got.prim, ref.prim)
    assert torch.equal(scene.inst_id[got.slot.clamp(min=0).long()],
                       fresh.inst_id[ref.slot.clamp(min=0).long()])


def test_blk_bound_matches_unbounded(nine):
    """trace_rows_tlas takes a temporal bound: one from the previous
    identical trace gives the unbounded trace bit for bit, with the cull
    on and no ray residual (tests/test_torch_tbound.py holds the bounds
    further)."""
    _, tds, _, tm = nine
    o, d = random_wave(1, 256)
    base = tsm.trace_rows_tlas(tds, tm, trows(o, d), TMIN, TMAX)
    rec, diag = tsm.trace_rows_tlas(tds, tm, trows(o, d), TMIN, TMAX,
                                    blk_bound=ts3.block_bound_from_t(base.t),
                                    with_diag=True)
    assert (base.t < FLT_MAX).sum() > 10
    assert diag["tb_residual"] == 0 and diag["tb_marked"] == 0
    for f in ("t", "prim", "slot", "b1", "b2"):
        assert torch.equal(getattr(rec, f), getattr(base, f)), f


# ----------------------------------------------------------- routes

def test_route_selector_and_engine_dispatch(monkeypatch):
    """trace_rows_multi(native=True) and the engine's multi_route="native"
    reach trace_rows_tlas, for closest hits and shadows; the default
    stays the scan; an unknown route raises."""
    calls = []
    real = tsm.trace_rows_tlas

    def spy(*a, occl=False, **kw):
        calls.append(occl)
        return real(*a, occl=occl, **kw)

    monkeypatch.setattr(tsm, "trace_rows_tlas", spy)
    _, tds = scene_pair(multi_geometry(n_inst=9, tris_per=40, seed=6))
    mt = tsm.multi_tables(tds)
    lo, hi = mt.aabb_w[0].reshape(2, 3)
    xy = np.random.default_rng(0).uniform(lo[:2], hi[:2], (256, 2))
    o = torch.from_numpy(np.c_[xy, np.full(256, 40.0)].astype(np.float32))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(256, 3).contiguous()
    rec = tsm.trace_rows_multi(tds, mt, ts3.rows_from_aos(o, d), TMIN, TMAX,
                               native=True)
    assert calls == [False] and rec.hit.any()
    scan = tsm.trace_rows_multi(tds, mt, ts3.rows_from_aos(o, d), TMIN,
                                TMAX)
    assert calls == [False] and torch.equal(scan.hit, rec.hit)
    hits = {}
    for any_hit in (False, True):
        hits[any_hit] = tpath._trace_dispatch(
            tds, o, d, TMIN, TMAX, any_hit_terminate=any_hit,
            multi_route="native").hit
    assert calls == [False, False, True]
    assert torch.equal(hits[False], hits[True])
    tpath._trace_dispatch(tds, o, d, TMIN, TMAX)
    assert calls == [False, False, True]
    with pytest.raises(ValueError, match="multi_route"):
        tpath._trace_dispatch(tds, o, d, TMIN, TMAX, multi_route="tlas")
    assert tpath.WavefrontPathTracer(ray_generator=None,
                                     sbt=None).multi_route == "scan"


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_image_on_the_native_route_matches_jax(monkeypatch, depth):
    """The 9-instance scene at 64x64 with multi_route="native": every trace
    (closest hits and shadows) through trace_rows_tlas, the image against
    the JAX engine's at the same seeds."""
    monkeypatch.setenv("RADIANCE_ENGINE_STAGED", "1")
    calls = []
    real = tsm.trace_rows_tlas

    def spy(*a, occl=False, **kw):
        calls.append(occl)
        return real(*a, occl=occl, **kw)

    monkeypatch.setattr(tsm, "trace_rows_tlas", spy)
    w = 64
    (jds, jres), (tds, tres) = _render_inputs(9, 40, 6, w)
    jt = JTracer(ray_generator=jcam.physical_camera_raygen,
                 sbt=JSBT.from_json(jshaders.DEFAULT_SBT_RECORDS,
                                    jshaders.SHADER_REGISTRY))
    tt = tpath.WavefrontPathTracer(
        ray_generator=tcam.physical_camera_raygen,
        sbt=TSBT.from_json(tshaders.DEFAULT_SBT_RECORDS,
                           tshaders.SHADER_REGISTRY), multi_route="native")
    n = w * w
    _, jimg = jt.render(jds, jres, jnp.zeros((n, 3), jnp.float32), 0, w, w,
                        batch=1, depth=depth)
    tacc, timg = tt.render(tds, tres, torch.zeros(n, 3), 0, w, w, batch=1,
                           depth=depth)
    assert calls == [False, True] * depth
    assert torch.isfinite(tacc).all()
    ref = np.asarray(jimg)[..., :3].astype(np.float64)
    got = timg.numpy()[..., :3].astype(np.float64)
    assert got.std() > 1.0
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    assert rmse < RMSE_BAR[depth], rmse
