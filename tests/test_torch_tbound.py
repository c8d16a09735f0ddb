"""radiance_tpu_torch's temporal t-bounds vs radiance_tpu's.

The cull helpers (_apply_block_bound, block_bound_from_t, pad_blk_bound)
of the port's ops/stream3.py bit for bit against the JAX functions;
trace_rows_stream3(blk_bound=...) (the plain versions of the stream3
kernels on the CPU) against the JAX entry with its Pallas kernels in
interpret mode, closest hit and occlusion, with bounds taken from a
previous identical wave (per-block max) and at the tightest (per-block
min), as tests/test_stream3.py:880-1010 does; the residual's cap and its
slot == -2 marker against the JAX _tb_residual; and both many-instance
routes with bounds, as tests/test_stream3_multi.py:422-470 does, against
their unbounded traces and the JAX two-level walk.  Each package builds
its own scene from the same numpy geometry.

Bars: the helpers bit-equal; a bound that culls no true hit gives the
port's unbounded trace bit for bit (the same kernels see the same
winning pairs) and JAX's to PERF.md section 2's parity bars (hit/miss and
prim >= 0.999, t rtol 1e-5 atol 1e-6: the leaf products sum in another
order than the JAX kernel's); a tight bound re-traces its residual
through the packet tracer, so hits and prims equal the unbounded trace
and t holds the same bar; occlusion on occluded-or-not, exactly; against
the JAX walk, whose instance transform rounds differently, t to rtol
2e-3 atol 1e-4 (tests/test_stream3_multi.py's).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.ops import stream3 as js3
from radiance_tpu.ops import traversal
from radiance_tpu.ops.traversal import HitRecord as JHitRecord

from radiance_tpu_torch.ops import packet_trace as tpk
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops import stream3_multi as tsm
from radiance_tpu_torch.ops import stream3_stages as tstg
from radiance_tpu_torch.ops.intersect import FLT_MAX

from test_torch_stream3 import (  # noqa: F401
    _one_torch_thread, hold, jrows, soup_pair, trows)
from test_torch_stream3_multi import scene_pair
from test_torch_stream3_tlas import tlas_geometry

TMIN, TMAX = 1e-3, 1e3
FMAX32 = np.float32(FLT_MAX)
FIELDS = ("t", "prim", "slot", "b1", "b2")


def bit_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


# ------------------------------------------------------------- helpers

def random_words(rng, nslot, pcap):
    """Emit words of the 9-bit format: random leaves, keep masks and tq,
    a fifth of tq zero and a tenth of the words zero."""
    leaf = rng.integers(0, tstg.W_LEAF_MAX - 2, size=(nslot, pcap))
    kmask = rng.integers(0, 256, size=(nslot, pcap))
    tq = rng.integers(0, tstg.W_TQ_MASK + 1, size=(nslot, pcap))
    tq[rng.uniform(size=tq.shape) < 0.2] = 0
    words = ((leaf + 1) << tstg.W_LEAF_SHIFT | kmask << tstg.W_KEEP_SHIFT
             | tq).astype(np.int32)
    words[rng.uniform(size=words.shape) < 0.1] = 0
    return words


@pytest.mark.parametrize("seed,npk", [(0, 5), (1, 13), (2, 1)])
def test_apply_block_bound_bit_equal_jax(seed, npk):
    """Random words against bounds that are finite, +/-inf, negative,
    zero, NaN, FLT_MAX and subnormal: the port's cull word for word."""
    rng = np.random.default_rng(seed)
    nslot = 4 * npk + 3
    words = random_words(rng, nslot, 96)
    slot_pkt = rng.integers(0, npk, size=nslot).astype(np.int32)
    b = rng.uniform(0.0, 300.0, size=npk * 8).astype(np.float32)
    special = np.float32([np.inf, -5.0, np.nan, 0.0, -np.inf, FMAX32,
                          1e-42, -np.nan])
    b[:min(8, b.size)] = special[:min(8, b.size)]
    ref = np.asarray(js3._apply_block_bound(
        jnp.asarray(words), jnp.asarray(slot_pkt), jnp.asarray(b)))
    got = ts3._apply_block_bound(torch.from_numpy(words),
                                 torch.from_numpy(slot_pkt),
                                 torch.from_numpy(b)).numpy()
    assert (ref != words).any()                 # the cull cleared bits
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [77, 1000, 1024, 4099])
def test_block_bound_and_pad_bit_equal_jax(n):
    """block_bound_from_t (misses in some blocks, n not a multiple of
    128) and pad_blk_bound, as bytes."""
    rng = np.random.default_rng(n)
    t = rng.uniform(0.0, 120.0, size=n).astype(np.float32)
    t[rng.uniform(size=n) < 0.02] = FMAX32
    ref = np.asarray(js3.block_bound_from_t(jnp.asarray(t)))
    got = ts3.block_bound_from_t(torch.from_numpy(t)).numpy()
    assert got.shape == (-(-n // 128),)
    assert got.tobytes() == ref.tobytes()
    for nblk in (got.shape[0], got.shape[0] + 5):
        pr = np.asarray(js3.pad_blk_bound(jnp.asarray(ref), nblk))
        pg = ts3.pad_blk_bound(torch.from_numpy(got), nblk).numpy()
        assert pg.tobytes() == pr.tobytes()


# ------------------------------------------------ single-instance waves

N = 2048


def grid_wave():
    """tests/test_stream3.py:890-897's 2048 rays from (0, 0, 12)."""
    ij = np.arange(N)
    xs = (ij % 64) / 64.0 - 0.5
    ys = (ij // 64) / 32.0 - 0.5
    o = np.tile([[0.0, 0.0, 12.0]], (N, 1)).astype(np.float32)
    d = np.stack([xs, ys, np.full(N, -1.0)], -1).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def scatter_wave():
    """tests/test_stream3.py:958-962's occlusion rays."""
    rng = np.random.default_rng(5)
    o = np.tile([[0.0, 0.0, 12.0]], (N, 1)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def loose_bound(t):
    """tests/test_stream3.py:901-904: each block's worst t, slackened."""
    b = np.where(t >= FMAX32, FMAX32, np.where(t < FMAX32, t, 0) * 1.0001
                 + 1e-4).astype(np.float32)
    return b.reshape(-1, 128).max(1)


def tight_bound(t):
    """tests/test_stream3.py:936-938: half of each hit's t, each block's
    smallest: every ray of a block with a hit is residual."""
    b = np.where(t < FMAX32, t * 0.5, FMAX32).astype(np.float32)
    return b.reshape(-1, 128).min(1)


@pytest.fixture(scope="module")
def soup():
    """The scene, both waves, and the port's and JAX's unbounded traces
    (the JAX ones in interpret mode, computed once)."""
    jds, tds = soup_pair(900, 3)
    og, dg = grid_wave()
    os_, ds_ = scatter_wave()
    out = dict(jds=jds, tds=tds, grid=(og, dg), scatter=(os_, ds_))
    out["j_closest"] = js3.trace_rows_stream3(jds, jrows(og, dg), TMIN, TMAX,
                                              interpret=True)
    out["t_closest"] = ts3.trace_rows_stream3(tds, trows(og, dg), TMIN, TMAX)
    out["j_occl"] = js3.trace_rows_stream3(jds, jrows(os_, ds_), TMIN, TMAX,
                                           interpret=True, occl=True)
    out["t_occl"] = ts3.trace_rows_stream3(tds, trows(os_, ds_), TMIN, TMAX,
                                           occl=True)
    return out


def test_stream3_bound_from_previous_wave_matches_jax(soup):
    """blk_bound from the previous identical wave's t: nothing true is
    culled and no ray is residual, so the port's bounded trace is its
    unbounded one bit for bit, and the JAX bounded trace holds the bars
    against it."""
    og, dg = soup["grid"]
    t0 = soup["t_closest"].t.numpy()
    bb = loose_bound(t0)
    rec, diag = ts3.trace_rows_stream3(soup["tds"], trows(og, dg), TMIN,
                                       TMAX, blk_bound=torch.from_numpy(bb),
                                       with_diag=True)
    assert bit_equal(rec, soup["t_closest"])
    assert diag["tb_residual"] == 0 and diag["tb_marked"] == 0
    assert diag["tb_cap"] == N                     # min(n, max(16384, n/128))
    assert 0 < int(diag["block_pairs_bounded"]) <= int(diag["block_pairs"])
    ref = js3.trace_rows_stream3(soup["jds"], jrows(og, dg), TMIN, TMAX,
                                 interpret=True, blk_bound=jnp.asarray(bb))
    np.testing.assert_array_equal(np.asarray(ref.t),
                                  np.asarray(soup["j_closest"].t))
    hold(ref.t, ref.prim, rec.t.numpy(), rec.prim.numpy())


@pytest.mark.parametrize("kind", ["tightest", "from_t"])
def test_stream3_bound_residual_gives_unbounded_hits(soup, kind):
    """The tightest bound (half of each block's nearest hit) culls true
    winners and makes every ray of a hit block residual; the packet
    tracer's exact re-trace restores the unbounded hits.  block_bound_
    from_t's own slack (the engine's) on the same wave.  Both against
    the port's unbounded trace and JAX's."""
    og, dg = soup["grid"]
    base = soup["t_closest"]
    t0 = base.t.numpy()
    bb = (torch.from_numpy(tight_bound(t0)) if kind == "tightest"
          else ts3.block_bound_from_t(base.t))
    rec, diag = ts3.trace_rows_stream3(soup["tds"], trows(og, dg), TMIN,
                                       TMAX, blk_bound=bb, with_diag=True)
    assert diag["tb_marked"] == 0 and (rec.slot >= -1).all()
    if kind == "tightest":
        assert diag["tb_residual"] == N
        assert int(diag["block_pairs_bounded"]) < int(diag["block_pairs"])
    else:
        assert diag["tb_residual"] == 0
        assert bit_equal(rec, base)
    assert torch.equal(rec.hit, base.hit) and torch.equal(rec.prim, base.prim)
    hold(t0, base.prim.numpy(), rec.t.numpy(), rec.prim.numpy())
    ref = soup["j_closest"]
    hold(ref.t, ref.prim, rec.t.numpy(), rec.prim.numpy())


def test_stream3_occlusion_bound_matches_jax(soup):
    """occl waves: a bound from the previous closest hits resolves every
    ray without residual (a block with a finite bound holds only hits);
    the tightest bound leaves unoccluded rays under a finite bound, and
    the culled hits, to the exact any-hit re-trace.  Occluded-or-not
    equals the port's unbounded occlusion wave, JAX's, and JAX's under
    the first bound."""
    os_, ds_ = soup["scatter"]
    closest = ts3.trace_rows_stream3(soup["tds"], trows(os_, ds_), TMIN, TMAX)
    occ0 = soup["t_occl"].t.numpy() < FMAX32
    np.testing.assert_array_equal(occ0, np.asarray(soup["j_occl"].t) < FMAX32)
    bbs = (loose_bound(closest.t.numpy()), tight_bound(closest.t.numpy()))
    for bb, resid in zip(bbs, (False, True)):
        rec, diag = ts3.trace_rows_stream3(soup["tds"], trows(os_, ds_), TMIN,
                                           TMAX, occl=True, with_diag=True,
                                           blk_bound=torch.from_numpy(bb))
        assert np.isin(rec.t.numpy(), [0.0, FMAX32]).all()
        assert (diag["tb_residual"] > 0) == resid
        assert diag["tb_marked"] == 0
        np.testing.assert_array_equal(rec.t.numpy() < FMAX32, occ0)
    ref = js3.trace_rows_stream3(soup["jds"], jrows(os_, ds_), TMIN, TMAX,
                                 interpret=True, occl=True,
                                 blk_bound=jnp.asarray(bbs[0]))
    np.testing.assert_array_equal(np.asarray(ref.t) < FMAX32, occ0)


@pytest.mark.parametrize("occl", [False, True])
def test_residual_cap_marks_the_rays_jax_marks(soup, monkeypatch, occl):
    """TB_RES_RAYS patched to 8 in both packages (cap max(8, 2048 // 128)
    = 16): the port's _tb_residual marks exactly the rays the JAX
    _tb_residual marks slot == -2, t = FLT_MAX, prim -1, b 0, on the same
    record and bound, and re-traces the others to the JAX walk's result;
    trace_rows_stream3 then returns the same markers."""
    monkeypatch.setattr(js3, "TB_RES_RAYS", 8)
    monkeypatch.setattr(ts3, "TB_RES_RAYS", 8)
    og, dg = soup["grid"]
    base = soup["t_occl" if occl else "t_closest"]
    if occl:
        og, dg = soup["scatter"]
    closest = ts3.trace_rows_stream3(soup["tds"], trows(og, dg), TMIN, TMAX)
    bb = tight_bound(closest.t.numpy())
    jrec = JHitRecord(*(jnp.asarray(getattr(base, f).numpy())
                        for f in FIELDS))
    ref = js3._tb_residual(soup["jds"], jrows(og, dg), TMIN, TMAX, jrec,
                           jnp.asarray(bb), occl=occl, live=None, n=N)
    got = ts3.HitRecord(*(getattr(base, f).clone() for f in FIELDS))
    stats = ts3._tb_residual(
        trows(og, dg), got, torch.from_numpy(bb),
        lambda o, d: tpk.trace_rays_packet(soup["tds"], o, d, TMIN, TMAX,
                                           any_hit=occl),
        occl=occl, live=None, n=N)
    late = np.asarray(ref.slot) == -2
    assert stats["tb_cap"] == 16 and stats["tb_residual"] == 16
    assert stats["tb_marked"] == late.sum() > 16
    np.testing.assert_array_equal(got.slot.numpy() == -2, late)
    assert (got.t.numpy()[late] == FMAX32).all()
    assert (got.prim.numpy()[late] == -1).all()
    assert (got.b1.numpy()[late] == 0).all()
    assert (got.b2.numpy()[late] == 0).all()
    keep = ~late
    if occl:
        np.testing.assert_array_equal(got.t.numpy()[keep],
                                      np.asarray(ref.t)[keep])
    else:
        hold(np.asarray(ref.t)[keep], np.asarray(ref.prim)[keep],
             got.t.numpy()[keep], got.prim.numpy()[keep])
    rec, diag = ts3.trace_rows_stream3(soup["tds"], trows(og, dg), TMIN,
                                       TMAX, occl=occl, with_diag=True,
                                       blk_bound=torch.from_numpy(bb))
    marked = rec.slot.numpy() == -2
    assert diag["tb_marked"] == marked.sum()
    assert (rec.t.numpy()[marked] == FMAX32).all()
    if not occl:
        # the bounded record's residual is the unbounded one's: a culled
        # winner leaves t past the bound either way
        np.testing.assert_array_equal(marked, late)
        return
    # on occlusion waves the cull also unoccludes rays (their occluders
    # lay past the bound), so the bounded record's residual is larger
    assert marked.sum() >= late.sum()
    assert (np.repeat(bb, 128)[:N][marked] < FMAX32).all()
    np.testing.assert_array_equal((rec.t.numpy() < FMAX32)[~marked],
                                  (base.t.numpy() < FMAX32)[~marked])


# ------------------------------------------------- many-instance routes

@pytest.fixture(scope="module")
def nine():
    """tests/test_stream3_multi.py::_tlas_scene's 9 instances, both
    packages, and the port's MultiTables."""
    jds, tds = scene_pair(tlas_geometry())
    return jds, tds, tsm.MultiTables(tds)


def multi_wave():
    """tests/test_stream3_multi.py:432-440's tile-ish coherent rays."""
    n = 1024
    ij = np.arange(n)
    xs = (ij % 32) / 32.0 - 0.5
    ys = (ij // 32) / 32.0 - 0.5
    o = np.tile([[0.0, 0.0, 20.0]], (n, 1)).astype(np.float32)
    d = np.stack([xs * 1.4, ys * 1.4, np.full(n, -1.0)], -1).astype(
        np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("occl", [False, True])
@pytest.mark.parametrize("route", ["scan", "native"])
def test_multi_routes_bounded_equal_unbounded(nine, route, occl):
    """Both routes: a bound from the previous identical trace gives the
    unbounded trace bit for bit (no residual); the tightest bound (half
    of each block's nearest hit) culls true winners and the sweeps'
    re-trace restores the unbounded hits, prims and instances; both held
    to the JAX two-level walk."""
    jds, tds, mt = nine
    o, d = multi_wave()
    n = len(o)

    def trace(**kw):
        return tsm.trace_rows_multi(tds, mt, trows(o, d), TMIN, TMAX,
                                    native=route == "native", occl=occl,
                                    with_diag=True, **kw)

    base, _ = trace()
    closest = base if not occl else tsm.trace_rows_multi(
        tds, mt, trows(o, d), TMIN, TMAX, native=route == "native")
    assert (closest.slot != -2).all() and (base.slot != -2).all()
    rec, diag = trace(blk_bound=ts3.block_bound_from_t(closest.t))
    assert bit_equal(rec, base)
    assert diag["tb_residual"] == 0 and diag["tb_marked"] == 0
    assert diag["block_pairs_bounded"] <= diag["block_pairs"]
    ref = traversal.trace_rays(jds, jnp.asarray(o), jnp.asarray(d), TMIN,
                               TMAX, any_hit_terminate=occl)
    hr = np.asarray(ref.t) < FMAX32
    assert hr.sum() > 100

    bb = torch.from_numpy(tight_bound(closest.t.numpy()))
    rec2, diag2 = trace(blk_bound=bb)
    assert diag2["tb_marked"] == 0 and (rec2.slot >= -1).all()
    assert diag2["tb_residual"] > 0
    assert diag2["block_pairs_bounded"] < diag2["block_pairs"]
    if occl:
        np.testing.assert_array_equal(rec2.t.numpy() < FMAX32, hr)
        np.testing.assert_array_equal(rec.t.numpy() < FMAX32, hr)
        return
    assert torch.equal(rec2.hit, base.hit)
    assert torch.equal(rec2.prim, base.prim)
    assert torch.equal(rec2.slot, base.slot)
    np.testing.assert_allclose(rec2.t.numpy(), base.t.numpy(), rtol=1e-5,
                               atol=1e-6)
    t = rec2.t.numpy()
    np.testing.assert_array_equal(t < FMAX32, hr)
    np.testing.assert_allclose(t[hr], np.asarray(ref.t)[hr], rtol=2e-3,
                               atol=1e-4)


@pytest.mark.parametrize("route", ["scan", "native"])
def test_multi_routes_residual_cap_marks(nine, monkeypatch, route):
    """A bound of 0.5 on every block makes every ray residual; with the
    cap at max(8, 1024 // 128) = 8 rays, the rest come back marked
    slot == -2, t = FLT_MAX, in index order after the first 8."""
    monkeypatch.setattr(ts3, "TB_RES_RAYS", 8)
    _, tds, mt = nine
    o, d = multi_wave()
    base = tsm.trace_rows_multi(tds, mt, trows(o, d), TMIN, TMAX,
                                native=route == "native")
    resid = np.flatnonzero(base.t.numpy() > 0.5)
    rec, diag = tsm.trace_rows_multi(
        tds, mt, trows(o, d), TMIN, TMAX, native=route == "native",
        blk_bound=torch.full((8,), 0.5), with_diag=True)
    assert diag["tb_cap"] == 8 and diag["tb_residual"] == 8
    assert diag["tb_marked"] == len(resid) - 8
    late = np.zeros(len(o), bool)
    late[resid[8:]] = True
    np.testing.assert_array_equal(rec.slot.numpy() == -2, late)
    assert (rec.t.numpy()[late] == FMAX32).all()
    first = resid[:8]
    assert torch.equal(rec.prim[first], base.prim[first])
