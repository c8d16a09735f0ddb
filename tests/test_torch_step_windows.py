"""Kernel B's step cap counted in the reference's step windows.

The reference's compiled emit walks (_emit3wst_kernel, its default off
interpret mode, and the lockstep _emit3t_kernel) count STEP_CAP in
aligned 8-row node windows: one iteration follows the walk through every
node of one window.  Its node walk (_emit3_kernel) counts nodes.  The
port's kernel B and its plain version take the window's rows as
step_rows: 8 by default, 1 for the node count.  Here the plain version
(the CPU route of stream3_stages.stage_emit) is held against the JAX
kernels in interpret mode, fed the same prep outputs, on every slot: the
words, the count, the capped flag and the steps.

The work-stealing kernel stamps emeta lane 2 with its global iteration
count at a slot's retire, and lays its rows out in retire order (lane 5:
the slot).  Both follow from the slots' own window counts and capped
flags through the kernel's schedule (ws_retire_order), so the port's
per-slot steps are held to them exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.api import accel as jaccel
from radiance_tpu.core import types as jtypes
from radiance_tpu.ops import stream3 as js3
from radiance_tpu.ops import stream3_multi as jsm

from radiance_tpu_torch.api import accel as taccel
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops import stream3_stages as stg

from test_torch_stream3 import (  # noqa: F401
    TMAX, TMIN, _one_torch_thread, camera_wave, jrows, soup_pair, trows)
from test_traversal import gen_rays

# step caps that cut many of the staged wave's slots: every live slot
# walks its octant's 31 rows, 4 step windows of 8 rows
SMALL_CAP = 3
NODE_CAP = 7
FULL_CAP = js3.STEP_CAP


@pytest.fixture(scope="module")
def prep():
    """The staged wave of tests/test_torch_stream3.py (a mixed-octant
    8192-ray wave on a 1200-triangle soup) through the JAX prep: the
    emit stage's inputs as numpy arrays, and the node table."""
    jds, _ = soup_pair(1200, 21)
    o, d = gen_rays(np.random.default_rng(7), js3.G * js3.PKT, spread=8.0)
    _, _, scal, smeta, bscal, lim, _ = js3._stage_prep(
        jrows(o, d), TMIN, TMAX, jds.knode_f, jds.inst_inv[0],
        stable=jds.stable_frames)
    return {k: np.asarray(v) for k, v in dict(
        scal=scal, smeta=smeta, bscal=bscal, lim=lim,
        nodef=jds.knode_f).items()}


@pytest.fixture(scope="module")
def clamp_prep():
    """tests/test_stream3_multi.py::test_tlas_native_treelet_window_clamp's
    scene (BLASes of 140, 90 and 61 triangles, six instances: the octant
    tables of the last BLAS, last in the concatenated tables, are one row
    each) and a wave whose packet p looks along direction octant p at an
    instance of that BLAS, through the JAX native route's prep: each
    packet's slot walks octant p's table there, whose step window starts
    clamped at the end of nodef (at -p)."""
    rng = np.random.default_rng(17)
    meshes = []
    for tris_per in (140, 90, 61):
        centers = rng.uniform(-2, 2, size=(tris_per, 3)).astype(np.float32)
        offs = rng.normal(scale=0.35, size=(tris_per, 3, 3)).astype(
            np.float32)
        meshes.append((centers[:, None, :] + offs).reshape(-1, 3))
    blases = [jaccel.BuildBottomAccelStruct(jtypes.Mesh(
        v, np.arange(len(v), dtype=np.uint32).reshape(-1, 3)))
        for v in meshes]
    insts, tfs = [], []
    for i in range(6):
        tf = np.eye(4, dtype=np.float32)
        tf[:3, 3] = rng.uniform(-8, 8, 3)
        tfs.append(tf)
        insts.append(jtypes.Instance(tf, 0, i, blases[i % 3]))
    jds = jaccel.BuildTopAccelStruct(insts).device_scene()
    mt = jsm.MultiTables(jds)
    assert (np.asarray(mt.inst_nk) % 8 != 0).any()
    o, d = [], []
    for p in range(js3.G):
        sgn = np.array([-1.0 if p >> k & 1 else 1.0 for k in range(3)])
        dp = sgn * (1.0 + rng.uniform(0.0, 0.3, (js3.PKT, 3)))
        dp /= np.linalg.norm(dp, axis=-1, keepdims=True)
        target = tfs[2 + 3 * (p % 2)][:3, 3] + rng.uniform(
            -1.5, 1.5, (js3.PKT, 3))
        o.append(target - 25.0 * dp)
        d.append(dp)
    o = np.concatenate(o).astype(np.float32)
    d = np.concatenate(d).astype(np.float32)
    rows = js3.rows_from_aos(jnp.asarray(o), jnp.asarray(d))
    _, scal, smeta, bscal, lim, *_ = jsm._prep_tlas(
        mt, jds.inst_inv[:6], rows, TMIN, TMAX, None, 48, stable=True)
    return {k: np.asarray(v) for k, v in dict(
        scal=scal, smeta=smeta, bscal=bscal, lim=lim,
        nodef=mt.nodef_cat).items()}


def port_emit(p, cap, step_rows):
    t = {k: torch.from_numpy(p[k].copy()) for k in
         ("scal", "smeta", "bscal", "nodef")}
    words, emeta = stg._emit_plain(t["scal"], t["smeta"], t["bscal"],
                                   t["nodef"], TMAX, cap, stg.PCAP,
                                   step_rows=step_rows)
    return words.numpy(), emeta.numpy()


def jax_emit(p, ws, treelet):
    args = tuple(jnp.asarray(p[k]) for k in
                 ("lim", "scal", "smeta", "bscal", "nodef"))
    fn = js3._stage_emit_ws if ws else js3._stage_emit
    return tuple(np.asarray(v) for v in fn(*args, interpret=True,
                                           treelet=treelet))


def ws_retire_order(steps, capped, alive, cap, wg=js3.G):
    """(slot, emeta lane 2) of each row of _emit3wst_kernel's output, in
    row order, from each slot's step windows and capped flag: wg rows
    pull slots from a global cursor; each loop iteration first retires
    the rows whose walk ended or reached the cap (into the grid step's
    next output row while it has one), refills the free rows, then walks
    one window on every row; lane 2 is the iterations run so far
    (stream3.py:1291-1342, :1488-1492)."""
    nslot = len(steps)
    slot, left, st4 = [-1] * wg, [0] * wg, [0] * wg
    cur = it = 0
    out = []
    for _ in range(nslot // wg):
        q = 0
        while q < wg:
            for w in range(wg):
                s = slot[w]
                walking = s >= 0 and (capped[s] or left[w] > 0)
                if s >= 0 and q < wg and (not walking or st4[w] >= cap):
                    out.append((s, it))
                    slot[w] = -1
                    q += 1
            for w in range(wg):
                if slot[w] < 0 and cur < nslot:
                    slot[w], st4[w] = cur, 0
                    left[w] = int(steps[cur]) if alive[cur] else 0
                    cur += 1
            for w in range(wg):
                left[w] = max(left[w] - 1, 0)
                st4[w] += 1
            it += 1
    return out


def assert_lists_equal(words, emeta, ref_words, ref_emeta):
    """Count and capped flag on every slot, and each slot's first
    min(count, PCAP) words."""
    np.testing.assert_array_equal(emeta[:, :2], ref_emeta[:, :2])
    cnt = np.minimum(emeta[:, 0], stg.PCAP)
    for s in np.nonzero(cnt)[0]:
        np.testing.assert_array_equal(words[s, :cnt[s]],
                                      ref_words[s, :cnt[s]])
    return cnt


def hold_ws(p, cap, monkeypatch):
    """The port at step_rows 8 against _emit3wst_kernel at step cap cap;
    returns the port's emeta."""
    monkeypatch.setattr(js3, "STEP_CAP", cap)
    jw, je = jax_emit(p, ws=True, treelet=True)
    words, emeta = port_emit(p, cap, 8)
    nsl = emeta.shape[0]
    rowslot = je[:, 5]
    assert sorted(rowslot.tolist()) == list(range(nsl))
    row_of = np.empty(nsl, np.int64)
    row_of[rowslot] = np.arange(nsl)
    cnt = assert_lists_equal(words, emeta, jw[row_of], je[row_of])
    alive = p["smeta"][:, 1] > 0
    sched = ws_retire_order(emeta[:, 2], emeta[:, 1] > 0, alive, cap)
    np.testing.assert_array_equal(np.array(sched),
                                  np.stack([rowslot, je[:, 2]], 1))
    assert (emeta[alive, 2] > 0).all() and (emeta[~alive, 2] == 0).all()
    return emeta, cnt


@pytest.mark.parametrize("cap", [FULL_CAP, SMALL_CAP])
def test_windows_match_ws_treelet_kernel(prep, cap, monkeypatch):
    """step_rows 8 equals _emit3wst_kernel on every slot: words, count,
    capped flag, and the steps through the kernel's schedule.  At the
    small cap many slots are cut, each after SMALL_CAP whole windows."""
    emeta, cnt = hold_ws(prep, cap, monkeypatch)
    assert cnt.sum() > 100 and (prep["smeta"][:, 1] > 0).sum() > 16
    capped = emeta[:, 1] > 0
    if cap == SMALL_CAP:
        assert capped.sum() > 8 and (emeta[capped, 2] == cap).all()
    else:
        assert not capped.any()


@pytest.mark.parametrize("cap", [FULL_CAP, SMALL_CAP])
def test_windows_match_treelet_lockstep_kernel(prep, cap, monkeypatch):
    """step_rows 8 equals _emit3t_kernel on every slot (words, count,
    capped flag), and the group maximum of the port's steps is the
    lockstep kernel's shared count; fewer steps than nodes."""
    monkeypatch.setattr(js3, "STEP_CAP", cap)
    jw, je = jax_emit(prep, ws=False, treelet=True)
    words, emeta = port_emit(prep, cap, 8)
    assert_lists_equal(words, emeta, jw, je)
    np.testing.assert_array_equal(emeta[:, 2].reshape(-1, js3.G).max(1),
                                  je[::js3.G, 2])
    if cap == FULL_CAP:
        _, node_emeta = port_emit(prep, cap, 1)
        assert emeta[:, 2].sum() < node_emeta[:, 2].sum()


@pytest.mark.parametrize("cap", [FULL_CAP, NODE_CAP])
def test_node_rows_match_emit3_kernel(prep, cap, monkeypatch):
    """step_rows 1 equals _emit3_kernel, the node walk, on every slot
    (words, count, capped flag); the group maximum of the steps is its
    shared count.  At the small cap it cuts more slots than the windows
    do."""
    monkeypatch.setattr(js3, "STEP_CAP", cap)
    jw, je = jax_emit(prep, ws=False, treelet=False)
    words, emeta = port_emit(prep, cap, 1)
    assert_lists_equal(words, emeta, jw, je)
    np.testing.assert_array_equal(emeta[:, 2].reshape(-1, js3.G).max(1),
                                  je[::js3.G, 2])
    if cap == NODE_CAP:
        _, win = port_emit(prep, cap, 8)
        assert (emeta[:, 1] > 0).sum() > (win[:, 1] > 0).sum()


def clamp_binds(p):
    """Whether some alive slot's walk enters a step window whose start is
    clamped at the end of nodef (the walk followed node by node)."""
    nodef, smeta = p["nodef"], p["smeta"]
    nrows = nodef.shape[0]
    for s in np.nonzero(smeta[:, 1] > 0)[0]:
        base, idx = int(smeta[s, 2]), 0
        while idx >= 0:
            if base + (idx // 8) * 8 > nrows - 8:
                return True
            row = nodef[base + idx]
            tn, tf = stg._interval_test(
                torch.from_numpy(row[None, 0:3].copy()),
                torch.from_numpy(row[None, 3:6].copy()),
                torch.from_numpy(p["scal"][s:s + 1].copy()), TMAX)
            hit = bool(tf[0] >= tn[0]) and float(tn[0]) < TMAX
            idx = int(row[9]) if row[10] > 0 or not hit else int(row[8])
    return False


@pytest.mark.parametrize("cap", [FULL_CAP, SMALL_CAP])
def test_windows_clamp_globally_on_concatenated_tables(clamp_prep, cap,
                                                       monkeypatch):
    """On the native route's concatenated tables, where the last octant
    table is not a multiple of 8 rows and a walk reaches its last
    window: the window start clamps at the end of nodef, and the port
    still equals _emit3wst_kernel on every slot."""
    assert clamp_binds(clamp_prep)
    emeta, cnt = hold_ws(clamp_prep, cap, monkeypatch)
    assert cnt.sum() > 20


def test_step_rows_refused():
    x = torch.zeros(8, 16)
    for bad in (0, 9, 2.0, True):
        with pytest.raises(ValueError):
            stg.check_step_rows(bad)
        with pytest.raises(ValueError):
            stg.stage_emit(x, x.int(), torch.zeros(32, 16), x, TMAX,
                           step_rows=bad)


def test_wave_flags_match_ws_treelet_run(monkeypatch):
    """A whole wave at a small step cap: the port's _run (its default
    count) flags the same packets as the JAX _run with the compiled
    default's walk (ws=True, treelet=True) in interpret mode, and the
    node count would flag more."""
    jds, tds = soup_pair(1200, 21)
    o, d = camera_wave(js3.G * js3.PKT, 128, 12.0)
    monkeypatch.setattr(js3, "STEP_CAP", SMALL_CAP)
    monkeypatch.setattr(ts3, "STEP_CAP", SMALL_CAP)
    _, jd = js3._run(jrows(o, d), TMIN, TMAX, jds.knode_f, jds.kleaf,
                     jds.kprim, jds.ktri_geo, jds.inst_inv[0], None,
                     precision="f32", interpret=True, ws=True, treelet=True,
                     with_diag=True, stable=jds.stable_frames)
    _, gd = ts3._run(trows(o, d), TMIN, TMAX, tds.knode_f, tds.kleaf,
                     tds.inst_inv[0], stable=tds.stable_frames,
                     with_diag=True)
    flag = np.asarray(jd["pkt_flag"])
    np.testing.assert_array_equal(gd["pkt_flag"].numpy(), flag)
    assert 0 < flag.sum() < len(flag)
    monkeypatch.setattr(ts3, "stage_emit", _node_stage_emit)
    _, nd = ts3._run(trows(o, d), TMIN, TMAX, tds.knode_f, tds.kleaf,
                     tds.inst_inv[0], stable=tds.stable_frames,
                     with_diag=True)
    assert nd["pkt_flag"].sum() > gd["pkt_flag"].sum()


def _node_stage_emit(*a, **k):
    return stg.stage_emit(*a, step_rows=1, **k)
