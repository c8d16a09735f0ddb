"""radiance_tpu_torch's stream3 block presort, cascade and build_tracer
vs radiance_tpu's.

The port's plain versions (the CPU route) against the JAX module with its
Pallas kernels in interpret mode, or against the JAX per-ray traversal
walk as the exact oracle; each package builds its own scene from the same
mesh, rays come from a seed with numpy.

Bar: the end-to-end bar of test_torch_stream3_e2e.py (hit and prim
agreement >= 0.999, t rtol 1e-5 atol 1e-6 on rays both hit); the presort's
flags and block permutation identical to JAX's; a presorted trace's rays
re-traced exactly those of the flagged packets' caller blocks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.ops import stream3 as js3
from radiance_tpu.ops import traversal

from radiance_tpu_torch.ops import packet_trace as tpk
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops.intersect import FLT_MAX

from test_torch_stream3 import (  # noqa: F401
    TMAX, TMIN, _one_torch_thread, camera_wave, hold, jrows, soup_pair,
    trows)
from test_torch_stream3_modes import closed_pair, jax_run, torch_run
from test_traversal import gen_rays

# closed_pair's walls under a wave whose middle half is tile-ordered
# camera rays (short walks) and whose outer quarters scatter (long
# walks): at this step cap (in 8-row step windows) the presorted wave
# flags all but one of its 8 packets
PARTIAL_CAP = 10
# closed_pair's camera wave: at this step cap one of its 8 packets flags,
# in caller order and presorted
CLOSED_CAP = 16


@pytest.fixture(scope="module")
def mixed():
    jds, tds = soup_pair(900, 3)
    o1, d1 = camera_wave(4096, 64, 12.0)
    o2, d2 = gen_rays(np.random.default_rng(7), 4096, spread=8.0)
    o = np.concatenate([o2[:2048], o1, o2[2048:]])
    d = np.concatenate([d2[:2048], d1, d2[2048:]])
    return jds, tds, o, d


def test_presort_run_matches_jax(mixed):
    """_run(presort=True) against JAX _run(presort=True): the bar, the
    same flags (sorted packet space) and block permutation; presort and
    caller order give the same hits; then both bounded by the unbounded
    trace's block_bound_from_t (caller order, mapped into sorted block
    space by each package)."""
    jds, tds, o, d = mixed
    ref, jd = jax_run(jds, o, d, presort=True, with_diag=True)
    got, gd = torch_run(tds, o, d, presort=True, with_diag=True)
    hold(ref.t, ref.prim, got.t.numpy(), got.prim.numpy())
    np.testing.assert_array_equal(gd["blk_perm"].numpy(),
                                  np.asarray(jd["blk_perm"]))
    np.testing.assert_array_equal(gd["pkt_flag"].numpy(),
                                  np.asarray(jd["pkt_flag"]))
    assert not np.array_equal(gd["blk_perm"].numpy(), np.arange(64))
    plain = torch_run(tds, o, d)
    hold(plain.t.numpy(), plain.prim.numpy(), got.t.numpy(),
         got.prim.numpy())

    bound = ts3.block_bound_from_t(plain.t * 0.8)
    ref_b = jax_run(jds, o, d, presort=True,
                    blk_bound=jnp.asarray(bound.numpy()))
    got_b = torch_run(tds, o, d, presort=True, blk_bound=bound)
    hold(ref_b.t, ref_b.prim, got_b.t.numpy(), got_b.prim.numpy())
    # rays within their block's bound keep the unbounded hit
    inside = (plain.t <= bound.repeat_interleave(ts3.BLK)[:len(o)]).numpy()
    assert 0.05 < inside.mean() < 0.95
    np.testing.assert_array_equal(got_b.prim.numpy()[inside],
                                  got.prim.numpy()[inside])


@pytest.fixture(scope="module")
def mixed_closed(mixed):
    """mixed's wave over closed_pair's walls, whose walks are long enough
    for a step cap in windows to flag some packets and not others."""
    jds, tds = closed_pair()
    return jds, tds, mixed[2], mixed[3]


def test_presort_forced_residual_rewalks_caller_blocks(mixed_closed,
                                                       monkeypatch):
    """At a step cap that flags some presorted packets: the flags equal
    those of JAX's compiled default walk (ws=True, treelet=True: the step
    cap in 8-row windows); trace_rows_stream3(presort=True) re-traces
    exactly the rays of the flagged packets' caller blocks
    (diag["blk_perm"]) through the packet kernel: those rays' records
    equal a packet-kernel trace of them bit for bit, the others _run's at
    the same cap; hits and prims agree with the JAX traversal walk on >=
    0.999 of the rays.  (t is held to the port's own tracers here, as on
    the soup's grazing triangles, where the kernels' plane numerators and
    the walk's Moeller-Trumbore differ by up to ~2e-5 of t.)"""
    jds, tds, o, d = mixed_closed
    monkeypatch.setattr(js3, "STEP_CAP", PARTIAL_CAP)
    monkeypatch.setattr(ts3, "STEP_CAP", PARTIAL_CAP)
    _, jd = jax_run(jds, o, d, presort=True, with_diag=True, ws=True,
                    treelet=True)
    traced = []
    real = tpk.trace_rays_packet

    def spy(scene, origin, direction, *a, **kw):
        traced.append(origin.clone())
        return real(scene, origin, direction, *a, **kw)

    monkeypatch.setattr(tpk, "trace_rays_packet", spy)
    got, gd = ts3.trace_rows_stream3(tds, trows(o, d), TMIN, TMAX,
                                     presort=True, with_diag=True)
    flag = np.asarray(jd["pkt_flag"])
    np.testing.assert_array_equal(gd["pkt_flag"].numpy(), flag)
    assert 0 < flag.sum() < len(flag)
    perm = gd["blk_perm"].numpy()
    blocks = perm[(np.nonzero(flag)[0][:, None] * 8
                   + np.arange(8)).reshape(-1)]
    rays = np.sort((blocks[:, None] * ts3.BLK
                    + np.arange(ts3.BLK)).reshape(-1))
    assert len(traced) == 1 and gd["residual_rays"] == len(rays)
    np.testing.assert_array_equal(
        np.sort(traced[0][:, 0].numpy()), np.sort(o[rays, 0]))
    monkeypatch.setattr(tpk, "trace_rays_packet", real)
    pk = real(tds, torch.from_numpy(o[rays]), torch.from_numpy(d[rays]),
              TMIN, TMAX)
    assert got.t[rays].numpy().tobytes() == pk.t.numpy().tobytes()
    assert torch.equal(got.prim[rays], pk.prim)
    rest = np.setdiff1d(np.arange(len(o)), rays)
    run = torch_run(tds, o, d, presort=True)
    assert got.t[rest].numpy().tobytes() == run.t[rest].numpy().tobytes()
    assert torch.equal(got.prim[rest], run.prim[rest])
    ref = traversal.trace_rays(jds, jnp.asarray(o), jnp.asarray(d), TMIN,
                               TMAX)
    hit = np.asarray(ref.t) < FLT_MAX
    assert (hit == got.hit.numpy()).mean() >= 0.999 and hit.mean() > 0.3
    both = hit & got.hit.numpy()
    assert (np.asarray(ref.prim)[both]
            == got.prim.numpy()[both]).mean() >= 0.999


def test_cascade_matches_jax():
    """trace_rows_cascade at the wave's median hit t against JAX's (the
    bar), equal to the port's one-stage trace (the same t and prims); its
    stage A emits fewer words than a full-range trace.  The occlusion
    cascade gives the one-stage occlusion wave's occluded-or-not."""
    jds, tds = closed_pair()
    o, d = camera_wave(js3.G * js3.PKT, 128, 12.0)
    full, fd = ts3.trace_rows_stream3(tds, trows(o, d), TMIN, TMAX,
                                      with_diag=True)
    near = float(torch.quantile(full.t[full.t < FLT_MAX], 0.5))
    ref = js3.trace_rows_cascade(jds, jrows(o, d), TMIN, TMAX, near,
                                 precision="f32", interpret=True)
    got, cd = ts3.trace_rows_cascade(tds, trows(o, d), TMIN, TMAX, near,
                                     with_diag=True)
    hold(ref.t, ref.prim, got.t.numpy(), got.prim.numpy())
    assert torch.equal(got.t, full.t) and torch.equal(got.prim, full.prim)
    assert int(cd["a"]["words"]) < int(fd["words"])
    assert 0.3 < float((got.t < near).float().mean()) < 0.7
    occ = ts3.trace_rows_stream3(tds, trows(o, d), TMIN, TMAX, occl=True)
    occ_c = ts3.trace_rows_cascade(tds, trows(o, d), TMIN, TMAX, near,
                                   occl=True)
    assert torch.equal(occ.hit, occ_c.hit)


@pytest.mark.parametrize("presort", [False, True])
def test_build_tracer_matches_jax(presort, monkeypatch):
    """build_tracer's tracer on [N, 3] rays and on six rows against the
    JAX build_tracer (probe checks off), on the walls of closed_pair (no
    grazing ray, where the JAX residual's walk and the port's packet
    kernel would differ in t by more than the bar): the bar; with a step
    cap that flags a packet, its residual re-trace completes the record,
    equal to trace_rows_stream3's."""
    jds, tds = closed_pair()
    o, d = camera_wave(js3.G * js3.PKT, 128, 12.0)
    monkeypatch.setattr(js3, "STEP_CAP", CLOSED_CAP)
    monkeypatch.setattr(ts3, "STEP_CAP", CLOSED_CAP)
    jt = js3.build_tracer(jds, interpret=True, check=False,
                          check_every_wave=False, presort=presort)
    ref = jt(jnp.asarray(o), jnp.asarray(d), TMIN, TMAX)
    tt = ts3.build_tracer(tds, presort=presort)
    got = tt(torch.from_numpy(o), torch.from_numpy(d), TMIN, TMAX)
    hold(ref.t, ref.prim, got.t.numpy(), got.prim.numpy())
    rows = tt(trows(o, d), None, TMIN, TMAX)
    assert torch.equal(rows.t, got.t) and torch.equal(rows.prim, got.prim)
    one, diag = ts3.trace_rows_stream3(tds, trows(o, d), TMIN, TMAX,
                                       presort=presort, with_diag=True)
    assert diag["flagged"] > 0
    assert torch.equal(one.t, got.t) and torch.equal(one.prim, got.prim)
