"""radiance_tpu_torch's ray reordering (ops/reorder.py) and
trace_rays_packet_sorted vs radiance_tpu's.

tests/test_reorder.py's four cases on the port, then each function's
output against the JAX module's on the same numpy inputs: a stable
counting sort is deterministic, so the permutations and keys must be
equal value for value.  The sorted packet traces (the port's plain
packet version on the CPU, JAX's Pallas kernel in interpret mode) are
held to test_torch_packet_trace.py's bars (hit and prim agreement
>= 0.999, t rtol 1e-5, barycentrics 1e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.ops import packet_trace as jpk
from radiance_tpu.ops import reorder as jre
from radiance_tpu.ops import traversal

from radiance_tpu_torch.ops import packet_trace as tpk
from radiance_tpu_torch.ops import reorder
from radiance_tpu_torch.ops import traversal as ttrav
from radiance_tpu_torch.ops.intersect import FLT_MAX

from test_torch_packet_trace import (  # noqa: F401
    TMAX, TMIN, _one_torch_thread, compare, single_scene, torch_scene)
from test_traversal import gen_rays


# ------------------------------------------- tests/test_reorder.py's cases

def test_bucket_perm_matches_stable_sort():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 9, 4096).astype(np.int32)
    perm = reorder.bucket_perm(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))


def test_bucket_perm_empty_and_single_bucket():
    assert reorder.bucket_perm(torch.zeros(0, dtype=torch.int32)).shape \
        == (0,)
    perm = reorder.bucket_perm(torch.zeros(257, dtype=torch.int32))
    np.testing.assert_array_equal(perm.numpy(), np.arange(257))


def test_coherence_perm_groups_and_stability():
    rng = np.random.default_rng(1)
    d = torch.from_numpy(rng.standard_normal((2048, 3)).astype(np.float32))
    live = torch.from_numpy(rng.random(2048) > 0.7)
    perm, inv = (x.numpy() for x in reorder.coherence_perm(d, live))
    key = reorder.octant_key(d, live).numpy()
    ks = key[perm]
    assert (np.diff(ks) >= 0).all()              # grouped ascending
    n_live = int(live.sum())
    assert (key[perm[:n_live]] < 8).all()        # dead rays at the tail
    assert (key[perm[n_live:]] == 8).all()
    for b in range(9):                           # stable in each bucket
        assert (np.diff(perm[ks == b]) > 0).all()
    np.testing.assert_array_equal(perm[inv], np.arange(2048))


def test_masked_packet_trace_sorted_matches_unsorted():
    """The live-masked packet trace of the sorted wave, gathered back,
    equals the unsorted one (the same hit set, t equal) and the walk on
    live lanes; dead lanes miss."""
    ds = torch_scene(single_scene(n_tris=300, seed=5))
    n = 2 * tpk.PACKET
    rng = np.random.default_rng(2)
    o = torch.from_numpy(np.tile([[0.0, 0.0, 12.0]], (n, 1))
                         .astype(np.float32))
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] -= 1.5
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    live = torch.from_numpy(rng.random(n) > 0.6)
    ref = tpk.trace_rays_packet(ds, o, d, TMIN, TMAX, live=live)
    perm, inv = reorder.coherence_perm(d, live)
    rec = tpk.trace_rays_packet(ds, o[perm], d[perm], TMIN, TMAX,
                                live=live[perm]).take(inv)
    t_s, t_r = rec.t.numpy(), ref.t.numpy()
    np.testing.assert_array_equal(t_s < FLT_MAX, t_r < FLT_MAX)
    np.testing.assert_allclose(t_s[t_s < FLT_MAX], t_r[t_r < FLT_MAX],
                               rtol=1e-6, atol=1e-6)
    assert (t_s[~live.numpy()] == np.float32(FLT_MAX)).all()
    orc = ttrav.trace_rays(ds, o, d, TMIN, TMAX).t.numpy()
    lv = live.numpy()
    assert ((t_s < FLT_MAX) == (orc < FLT_MAX))[lv].mean() == 1.0


# ------------------------------------------------- against the JAX module

@pytest.mark.parametrize("masked", [False, True])
def test_reorder_matches_jax(masked):
    """bucket_perm, invert_perm, octant_key (on [N, 3] and on a row
    tuple), coherence_perm and apply_perm_rows equal JAX's, value for
    value."""
    rng = np.random.default_rng(7)
    n = 5000
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:17] = 0.0                                 # -0.0 < 0 is False
    d[17:40, 1] = -0.0
    live = rng.random(n) > 0.4 if masked else None
    jl = None if live is None else jnp.asarray(live)
    tl = None if live is None else torch.from_numpy(live)
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    np.testing.assert_array_equal(reorder.octant_key(td, tl).numpy(),
                                  np.asarray(jre.octant_key(jd, jl)))
    rows_t = tuple(td[:, k] for k in range(3))
    rows_j = tuple(jd[:, k] for k in range(3))
    np.testing.assert_array_equal(reorder.octant_key(rows_t, tl).numpy(),
                                  np.asarray(jre.octant_key(rows_j, jl)))
    keys = rng.integers(0, 9, n).astype(np.int32)
    np.testing.assert_array_equal(
        reorder.bucket_perm(torch.from_numpy(keys)).numpy(),
        np.asarray(jre.bucket_perm(jnp.asarray(keys), 9)))
    tp, ti = reorder.coherence_perm(td, tl)
    jp, ji = jre.coherence_perm(jd, jl)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(reorder.invert_perm(tp).numpy(),
                                  np.asarray(jre.invert_perm(jp)))
    for a, b in zip(reorder.apply_perm_rows(rows_t, tp),
                    jre.apply_perm_rows(rows_j, jp)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("any_hit", [False, True])
def test_trace_rays_packet_sorted_matches_jax(any_hit):
    """trace_rays_packet_sorted against JAX's (interpret mode) on a
    scattered wave of a transformed instance, and against the port's
    unsorted trace (the same hits: sorting changes only which rays share
    a packet)."""
    c, s = np.cos(0.4), np.sin(0.4)
    tf = np.array([[c, 0, s, 0.5], [0, 1.5, 0, -1.0], [-s, 0, c, 2.0],
                   [0, 0, 0, 1]], np.float32)
    jds = single_scene(n_tris=400, seed=13, transform=tf)
    tds = torch_scene(jds)
    o, d = gen_rays(np.random.default_rng(4), 3000, spread=8.0)
    ref = jpk.trace_rays_packet_sorted(jds, jnp.asarray(o), jnp.asarray(d),
                                       jnp.float32(TMIN), jnp.float32(TMAX),
                                       any_hit=any_hit, interpret=True)
    got = tpk.trace_rays_packet_sorted(tds, torch.from_numpy(o),
                                       torch.from_numpy(d), TMIN, TMAX,
                                       any_hit=any_hit)
    plain = tpk.trace_rays_packet(tds, torch.from_numpy(o),
                                  torch.from_numpy(d), TMIN, TMAX,
                                  any_hit=any_hit)
    if any_hit:
        occ = np.asarray(ref.t) < FLT_MAX
        assert (occ == got.hit.numpy()).mean() >= 0.999 and occ.any()
        assert torch.equal(got.hit, plain.hit)
    else:
        hit = compare(ref, got)
        assert hit.mean() > 0.05
        assert torch.equal(got.t, plain.t)
        assert (got.prim == plain.prim).float().mean() >= 0.999
        wk = traversal.trace_rays(jds, jnp.asarray(o), jnp.asarray(d), TMIN,
                                  TMAX)
        assert ((np.asarray(wk.t) < FLT_MAX) == hit).mean() >= 0.999
