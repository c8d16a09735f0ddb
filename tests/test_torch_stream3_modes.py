"""radiance_tpu_torch's stream3 ordering modes and kernel forms vs
radiance_tpu's: the block presort's keys, kernel C's tq-sort form, kernel
D's lean form with _winner_barys, and its tq occlusion cull.

The port's plain versions (the CPU route) against the JAX module with its
Pallas kernels in interpret mode; each package builds its own scene from
the same mesh, rays come from a seed with numpy.  The JAX knobs that the
port turns into keywords (RADIANCE_TQSORT, RADIANCE_ISECT_LEAN) are set
by monkeypatch for the JAX call only.

Bars:
  * _block_sort: rows and block permutation bit-equal (the block means
    are f32 sums over 128 in both packages);
  * the sorted refine: kept counts and kept words identical, word for
    word;
  * whole waves: the end-to-end bar of test_torch_stream3_e2e.py (hit
    and prim agreement >= 0.999, t rtol 1e-5 atol 1e-6 on rays both hit);
    the lean barycentrics within 1e-5 of JAX's where the prims agree;
    _winner_barys within 2e-6 (rtol) of JAX's;
  * the cull: t bit-equal to the port's unculled trace and prims
    >= 0.999 of it (a culled leaf can only hold a tie in t).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.core import types as jtypes
from radiance_tpu.ops import stream3 as js3

from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops import stream3_stages as stg

from test_torch_stream3 import (  # noqa: F401
    TMAX, TMIN, _one_torch_thread, camera_wave, hold, jrows, scene_pair,
    soup_pair, trows)
from test_traversal import gen_rays


def closed_pair():
    """Three tilted walls of 40x40 quads that camera_wave(.., 12.0) faces
    (at least 0.8 of cos to every wall, no grazing ray): a full one at
    z ~ -8 that every ray hits, one at z ~ -3 and, over the upper half of
    the image only, one at z ~ 2.  Every 128-ray block then holds hits
    only, and the blocks of the upper half find their hits on the front
    wall before the walls behind it: kernel D's cull has pairs to skip.
    The grids lie off the rays' lattice, so no ray meets a shared edge
    (where the two packages' sums could round a sign apart)."""
    g = np.linspace(-30.0, 30.0, 41, dtype=np.float32) + np.float32(0.3719)
    gx, gy = np.meshgrid(g, g * np.float32(1.0931), indexing="ij")
    quads = []
    for z0, rows in ((-8.0, range(40)), (-3.0, range(40)),
                     (2.0, range(20, 40))):
        wall = np.stack([gx, gy, z0 + 0.0717 * gx + 0.0413 * gy], -1) \
            .astype(np.float32)
        for i in range(40):
            for j in rows:
                a, b = wall[i, j], wall[i + 1, j]
                c, e = wall[i + 1, j + 1], wall[i, j + 1]
                quads += [a, b, c, a, c, e]
    verts = np.asarray(quads, np.float32)
    return scene_pair(jtypes.Mesh(
        verts, np.arange(len(verts), dtype=np.uint32).reshape(-1, 3)))


@pytest.fixture(scope="module")
def closed():
    jds, tds = closed_pair()
    o, d = camera_wave(js3.G * js3.PKT, 128, 12.0)
    return jds, tds, o, d


def jax_run(jds, o, d, **kw):
    tstart, _ = js3.leaf_tables(jds.knode_f, jds.kleaf.shape[0])
    return js3._run(jrows(o, d), TMIN, TMAX, jds.knode_f, jds.kleaf,
                    jds.kprim, jds.ktri_geo, jds.inst_inv[0], tstart,
                    precision="f32", interpret=True,
                    stable=jds.stable_frames, **kw)


def torch_run(tds, o, d, **kw):
    return ts3._run(trows(o, d), TMIN, TMAX, tds.knode_f, tds.kleaf,
                    tds.inst_inv[0], stable=tds.stable_frames,
                    kprim=tds.kprim, ktri_geo=tds.ktri_geo, **kw)


# ------------------------------------------------------------ presort keys

@pytest.mark.parametrize("masked", [False, True])
def test_block_sort_matches_jax_bit_exact(masked):
    """_block_sort's sorted rows, block permutation and live mask equal
    JAX's on a scattered, a tile-ordered and a mixed wave; with `live`,
    blocks without a live ray sort last."""
    rng = np.random.default_rng(3)
    o1, d1 = gen_rays(rng, 8192, spread=8.0)
    o2, d2 = camera_wave(8192, 128, 30.0)
    waves = [(o1, d1), (o2, d2),
             (np.concatenate([o1[:4096], o2[4096:]]),
              np.concatenate([d2[:4096], d1[4096:]]))]
    for k, (o, d) in enumerate(waves):
        live = None
        if masked:
            live = rng.uniform(size=len(o)) < 0.5
            live[:384] = False                    # three dead blocks
        jr = js3._block_sort(jrows(o, d), None if live is None
                             else jnp.asarray(live))
        tr = ts3._block_sort(trows(o, d), None if live is None
                             else torch.from_numpy(live))
        for a, b in zip(jr[0], tr[0]):
            assert b.numpy().tobytes() == np.asarray(a).tobytes(), k
        np.testing.assert_array_equal(tr[1].numpy(), np.asarray(jr[1]))
        assert not np.array_equal(tr[1].numpy(), np.arange(64))
        if masked:
            np.testing.assert_array_equal(tr[2].numpy(), np.asarray(jr[2]))
            assert set(tr[1][:3].tolist()) == {61, 62, 63}
        else:
            assert tr[2] is None


# --------------------------------------------------------- C's sort form

def test_refine_sort_matches_jax_word_for_word(closed):
    """_refine_plain(sort=True) on JAX's emitted lists against JAX
    _stage_refine_exact(sort=True): the same kept counts and words in the
    same order; each list is the unsorted refine's, stably ordered by tq
    bucket."""
    jds, tds, o, d = closed
    _, feats_t, scal, smeta, bscal, lim, _ = js3._stage_prep(
        jrows(o, d), TMIN, TMAX, jds.knode_f, jds.inst_inv[0],
        stable=jds.stable_frames)
    words, emeta = js3._stage_emit(lim, scal, smeta, bscal, jds.knode_f,
                                   interpret=True, treelet=False)
    slot_pkt = smeta[:, 0]
    aabb8 = ts3.leaf_aabb8(tds.knode_f, tds.kleaf.shape[0])
    jw, je = (np.asarray(v) for v in js3._stage_refine_exact(
        words, emeta, slot_pkt, feats_t, jnp.asarray(aabb8.numpy()), lim,
        interpret=True, sort=True))
    args = (torch.from_numpy(np.asarray(words).copy()),
            torch.from_numpy(np.asarray(emeta).copy()),
            torch.from_numpy(np.asarray(slot_pkt).copy()),
            torch.from_numpy(np.asarray(feats_t).copy()), aabb8, TMAX,
            stg.PCAP)
    ws, es = (v.numpy() for v in stg._refine_plain(*args, sort=True))
    wu, eu = (v.numpy() for v in stg._refine_plain(*args))
    np.testing.assert_array_equal(es, je)
    np.testing.assert_array_equal(eu, es)
    moved = 0
    for s in np.nonzero(es[:, 0])[0]:
        k = es[s, 0]
        np.testing.assert_array_equal(ws[s, :k], jw[s, :k])
        u = wu[s, :k]
        np.testing.assert_array_equal(
            ws[s, :k], u[np.argsort((u & stg.W_TQ_MASK)
                                    >> stg.TQ_BUCKET_SHIFT, kind="stable")])
        moved += int((ws[s, :k] != u).any())
    assert (ws[np.arange(ws.shape[1])[None, :] >= es[:, :1]] == 0).all()
    assert es[:, 0].sum() > 100 and moved > 4    # sorting was not vacuous


# --------------------------------------------------------- D's lean form

def test_lean_run_matches_jax(closed, monkeypatch):
    """_run(lean=True) against JAX _run under RADIANCE_ISECT_LEAN=1 (kernel
    D without barycentrics, the winners' recomputed from ktri_geo): the
    end-to-end bar, and the barycentrics within 1e-5 where prims agree;
    the same t and prims as the port's default form."""
    jds, tds, o, d = closed
    monkeypatch.setenv("RADIANCE_ISECT_LEAN", "1")
    ref = jax_run(jds, o, d)
    monkeypatch.delenv("RADIANCE_ISECT_LEAN")
    got = torch_run(tds, o, d, lean=True)
    full = torch_run(tds, o, d)
    hit = hold(ref.t, ref.prim, got.t.numpy(), got.prim.numpy())
    assert hit.mean() > 0.99
    same = hit & (np.asarray(ref.prim) == got.prim.numpy())
    for a, b in ((ref.b1, got.b1), (ref.b2, got.b2)):
        np.testing.assert_allclose(b.numpy()[same], np.asarray(a)[same],
                                   atol=1e-5)
    assert torch.equal(got.t, full.t) and torch.equal(got.prim, full.prim)
    np.testing.assert_allclose(got.b1.numpy(), full.b1.numpy(), atol=2e-3)


def test_winner_barys_matches_jax():
    """_winner_barys on a transformed instance (inv0 not the identity),
    hits and misses, against JAX's, within 2e-6 relative."""
    jds, tds = soup_pair(300, 12)
    rng = np.random.default_rng(5)
    n = 3000
    o, d = gen_rays(rng, n, spread=6.0)
    nf = int(tds.kprim.shape[0])
    kp = tds.kprim.numpy()
    prim = kp[rng.integers(0, nf, n)].astype(np.int32)
    prim[rng.uniform(size=n) < 0.2] = -1
    t = np.where(prim >= 0, rng.uniform(0.1, 9.0, n),
                 np.float32(3.4028235e38)).astype(np.float32)
    a = np.eye(4, dtype=np.float32)
    a[:3, :3] = rng.normal(size=(3, 3)) * 0.3 + np.eye(3)
    a[:3, 3] = rng.normal(size=3)
    jb = js3._winner_barys(jrows(o, d), jnp.asarray(a), jds.kprim,
                           jds.ktri_geo, jnp.asarray(prim), jnp.asarray(t), n)
    tb = ts3._winner_barys(trows(o, d), torch.from_numpy(a), tds.kprim,
                           tds.ktri_geo, torch.from_numpy(prim),
                           torch.from_numpy(t), n)
    for x, y in zip(jb, tb):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=2e-6,
                                   atol=1e-6)
    assert (tb[0].numpy()[prim < 0] == 0).all()
    assert np.abs(tb[0].numpy()[prim >= 0]).max() > 0


# ---------------------------------------------------------- D's tq cull

@pytest.mark.parametrize("tqsort", [False, True])
def test_cull_run_matches_jax_default(closed, monkeypatch, tqsort):
    """_run(cull=True) against the JAX default _run (kernel D's cull on),
    with and without the tq-sorted refine (RADIANCE_TQSORT=1 for JAX):
    the end-to-end bar against JAX; against the port's unculled trace, t
    bit-equal and prims >= 0.999; the cull skipped pairs."""
    jds, tds, o, d = closed
    if tqsort:
        monkeypatch.setenv("RADIANCE_TQSORT", "1")
    ref = jax_run(jds, o, d)
    monkeypatch.delenv("RADIANCE_TQSORT", raising=False)
    stats = []
    plain = stg._isect_plain

    def counted(*a, **kw):
        st = {}
        out = plain(*a, stats=st, **kw)
        stats.append(st)
        return out

    monkeypatch.setattr(stg, "_isect_plain", counted)
    got = torch_run(tds, o, d, cull=True, tqsort=tqsort)
    base = torch_run(tds, o, d, tqsort=tqsort)
    hold(ref.t, ref.prim, got.t.numpy(), got.prim.numpy())
    assert got.t.numpy().tobytes() == base.t.numpy().tobytes()
    assert (got.prim == base.prim).float().mean() >= 0.999
    assert (got.t < 3e38).float().mean() > 0.99
    assert stats[0]["culled"] > 0 and "culled" not in stats[1]
    assert stats[0]["pairs"] + stats[0]["culled"] == stats[1]["pairs"]
