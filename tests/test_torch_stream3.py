"""radiance_tpu_torch's stream3 pipeline vs radiance_tpu's, stage by stage.

The port's plain PyTorch versions of the four kernels (the CPU route of
radiance_tpu_torch.ops.stream3_stages) and its prep, glue and entry
points against the JAX module (ops/stream3.py) with its Pallas kernels in
interpret mode.  Each package builds its own scene from the same mesh
(the tables are bit-identical, tests/test_torch_tables.py); rays are made
from a seed with numpy.

Bars, per stage:
  * transposes, prep (rows, feats_t, scal, smeta, bscal, slot order):
    exact -- the same f32 formulas in the same order;
  * emit: emeta lanes 0-1 and the first min(count, PCAP) words of every
    row identical (products, differences and comparisons only);
  * refine: kept counts, pre-refine counts and kept words identical;
  * isect on the refined lists, per ray both hit: t rtol 1e-5 atol 1e-6,
    prim equal on >= 0.999 -- the leaf product's 16 terms are summed in
    another order (torch.bmm vs the interpret-mode dot), which can flip a
    near-tie between two triangles;
  * end to end: tests/test_torch_stream3_e2e.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
import jax

from radiance_tpu.api import accel as jaccel
from radiance_tpu.core import types as jtypes
from radiance_tpu.ops import stream3 as js3
from radiance_tpu.ops.intersect import FLT_MAX

from radiance_tpu_torch.api import accel as taccel
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops import stream3_stages as stg

from test_bvh import random_mesh
from test_traversal import gen_rays

TMIN, TMAX = 1e-3, 1e3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain versions run many small ops; one intra-op thread avoids
    contention with the parallel test runner's other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_pair(mesh):
    """(JAX DeviceScene, port DeviceScene on the CPU) of one mesh, each
    built through its own package's accel path."""
    out = []
    for accel, types, kw in ((jaccel, jtypes, {}),
                             (taccel, ttypes, {"device": "cpu"})):
        blas = accel.BuildBottomAccelStruct(types.Mesh(mesh.vertices,
                                                       mesh.triangles))
        inst = types.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)
        out.append(accel.BuildTopAccelStruct([inst]).device_scene(**kw))
    return tuple(out)


def soup_pair(n_tris, seed):
    return scene_pair(random_mesh(np.random.default_rng(seed), n_tris,
                                  spread=5.0))


def mini_city_pair():
    """tests/test_stream3.py:1066-1082's clustered mini city."""
    rng = np.random.default_rng(7)
    centers = rng.uniform(-20, 20, size=(64, 3)).astype(np.float32)
    local = rng.uniform(-1.5, 1.5, size=(64, 60, 3)).astype(np.float32)
    offs = rng.normal(scale=0.08, size=(64, 60, 3, 3)).astype(np.float32)
    verts = ((centers[:, None, :] + local)[:, :, None, :]
             + offs).reshape(-1, 3)
    return scene_pair(jtypes.Mesh(
        verts, np.arange(len(verts), dtype=np.uint32).reshape(-1, 3)))


def camera_wave(n, w, z):
    ij = np.arange(n)
    xs = (ij % w) / w - 0.5
    ys = (ij // w) / (n / w) - 0.5
    o = np.tile([[0.0, 0.0, z]], (n, 1)).astype(np.float32)
    d = np.stack([xs * 1.2, ys * 0.7, np.full(n, -1.0)], -1).astype(
        np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def jrows(o, d):
    return js3.rows_from_aos(jnp.asarray(o), jnp.asarray(d))


def trows(o, d):
    return ts3.rows_from_aos(torch.from_numpy(o), torch.from_numpy(d))


def hold(ref_t, ref_prim, got_t, got_prim):
    """The end-to-end and isect bars; returns the hit mask."""
    ref_t, got_t = np.asarray(ref_t), np.asarray(got_t)
    hr, hg = ref_t < FLT_MAX, got_t < FLT_MAX
    assert (hr == hg).mean() >= 0.999
    both = hr & hg
    assert both.any()
    assert (np.asarray(ref_prim)[both]
            == np.asarray(got_prim)[both]).mean() >= 0.999
    np.testing.assert_allclose(got_t[both], ref_t[both], rtol=1e-5,
                               atol=1e-6)
    return hg


# ------------------------------------------------------------- transposes

def test_transposes_match_pallas_bit_exact():
    n = 2 * js3.PKT
    rng = np.random.default_rng(0)
    o = rng.standard_normal((n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    spec = pl.BlockSpec((js3.PKT, 3), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    ref = pl.pallas_call(
        js3._aos2rows_kernel, grid=(n // js3.PKT,), in_specs=[spec] * 2,
        out_specs=pl.BlockSpec((8, js3.PKT), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, n), jnp.float32),
        interpret=True)(jnp.asarray(o), jnp.asarray(d))
    got = ts3.rows_from_aos_fast(torch.from_numpy(o), torch.from_numpy(d))
    for k in range(6):
        assert got[k].numpy().tobytes() == np.asarray(ref[k]).tobytes()

    x = rng.standard_normal((16, n)).astype(np.float32)
    ref = pl.pallas_call(
        js3._transpose_kernel, grid=(n // js3.PKT,),
        in_specs=[pl.BlockSpec((16, js3.PKT), lambda i: (0, i),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((js3.PKT, 16), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, 16), jnp.float32),
        interpret=True)(jnp.asarray(x))
    got = ts3.feats_rows_to_major(torch.from_numpy(x))
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()


# ------------------------------------------------------------------ prep

@pytest.mark.parametrize("masked", [False, True])
def test_stage_prep_matches_jax(masked):
    """A 2-packet wave whose packets mix direction octants: the pure /
    sub-slot / conservative slot tables, exact."""
    jds, tds = soup_pair(300, 10)
    o, d = gen_rays(np.random.default_rng(4), 2 * js3.PKT, spread=8.0)
    o[:js3.PKT // 2] = [0.0, 0.0, 12.0]           # half a pure packet
    d[:js3.PKT // 2] = [0.0, 0.0, -1.0]
    live = np.random.default_rng(5).uniform(size=len(o)) < 0.5 \
        if masked else None
    ref = js3._stage_prep(jrows(o, d), TMIN, TMAX, jds.knode_f,
                          jds.inst_inv[0],
                          live=None if live is None else jnp.asarray(live),
                          stable=jds.stable_frames)
    got = ts3._stage_prep(trows(o, d), tds.knode_f, tds.inst_inv[0],
                          live=None if live is None
                          else torch.from_numpy(live),
                          stable=tds.stable_frames)
    rows_r, feats_r, scal_r, smeta_r, bscal_r, _, order_r = ref
    rows_g, feats_g, scal_g, smeta_g, bscal_g, order_g = got
    for a, b in zip(rows_r, rows_g):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in ((feats_r, feats_g), (scal_r, scal_g), (smeta_r, smeta_g),
                 (bscal_r, bscal_g), (order_r, order_g)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (smeta_g[:, 1] > 0).sum() > 2          # sub-slots were made


# ------------------------------------------------ emit, refine, isect

@pytest.fixture(scope="module")
def staged():
    """One G*PKT = 8192-ray mixed-octant wave through the JAX stages
    (interpret mode) and the port's plain versions, each stage fed the
    JAX stage's output so that each comparison is of one stage."""
    jds, tds = soup_pair(1200, 21)
    o, d = gen_rays(np.random.default_rng(7), js3.G * js3.PKT, spread=8.0)
    _, feats_t, scal, smeta, bscal, lim, _ = js3._stage_prep(
        jrows(o, d), TMIN, TMAX, jds.knode_f, jds.inst_inv[0],
        stable=jds.stable_frames)
    words, emeta = js3._stage_emit(lim, scal, smeta, bscal, jds.knode_f,
                                   interpret=True, treelet=False)
    slot_pkt = smeta[:, 0]
    _, aabb = js3.leaf_tables(jds.knode_f, jds.kleaf.shape[0])
    nl = aabb.shape[0]
    aabb8 = jnp.zeros((((nl + 7) // 8) * 8, 8), jnp.float32).at[
        :nl, :6].set(aabb)
    words_i, emeta_i = js3._stage_refine_exact(
        words, emeta, slot_pkt, feats_t, aabb8, lim, interpret=True)
    out = js3._stage_isect(words_i, emeta_i, slot_pkt, feats_t.T, lim,
                           jds.kleaf, precision="f32", interpret=True,
                           orient="major", stable=jds.stable_frames)
    j = {k: np.asarray(v) for k, v in dict(
        lim=lim, feats_t=feats_t, scal=scal, smeta=smeta, bscal=bscal,
        words=words, emeta=emeta, aabb8=aabb8, words_i=words_i,
        emeta_i=emeta_i, out=out).items()}
    t = {k: torch.from_numpy(v.copy()) for k, v in j.items()}
    return jds, tds, j, t


@pytest.mark.parametrize("step_rows", [8, 1])
def test_stage_emit_matches_jax(staged, step_rows):
    """stage_emit against the JAX kernel that counts as it does: at
    step_rows 8 the windowed walk (_emit3t_kernel), at 1 the node walk
    (_emit3_kernel, the fixture's): count, capped flag and words on every
    slot; the port counts each slot's own steps, the TPU stamps its
    group's."""
    jds, tds, j, t = staged
    if step_rows == 1:
        jw, je = j["words"], j["emeta"]
    else:
        jw, je = (np.asarray(v) for v in js3._stage_emit(
            jnp.asarray(j["lim"]), jnp.asarray(j["scal"]),
            jnp.asarray(j["smeta"]), jnp.asarray(j["bscal"]), jds.knode_f,
            interpret=True, treelet=True))
    words, emeta = stg.stage_emit(t["scal"], t["smeta"], t["bscal"],
                                  tds.knode_f, TMAX, step_rows=step_rows)
    words, emeta = words.numpy(), emeta.numpy()
    np.testing.assert_array_equal(emeta[:, :2], je[:, :2])
    cnt = np.minimum(emeta[:, 0], stg.PCAP)
    for s in np.nonzero(cnt)[0]:
        np.testing.assert_array_equal(words[s, :cnt[s]], jw[s, :cnt[s]])
    assert cnt.sum() > 100 and (j["smeta"][:, 1] > 0).sum() > 16
    alive = j["smeta"][:, 1] > 0
    assert (emeta[alive, 2] > 0).all() and (emeta[~alive, 2] == 0).all()
    assert (emeta[:, 2].reshape(-1, js3.G).max(1) == je[::js3.G, 2]).all()


@pytest.mark.parametrize("step_rows", [8, 1])
def test_stage_emit_matches_jax_treelet_walk(staged, step_rows):
    """The reference's windowed walk (_emit3t_kernel, stream3.py:753:
    aligned 8-row node windows, the walk followed inside each) emits the
    same word lists, counts and capped flags as the port's walk at either
    step_rows on every slot: following a window does not change the
    lists, and at STEP_CAP neither walk is cut on this wave."""
    jds, tds, j, t = staged
    jw, je = (np.asarray(v) for v in js3._stage_emit(
        jnp.asarray(j["lim"]), jnp.asarray(j["scal"]),
        jnp.asarray(j["smeta"]), jnp.asarray(j["bscal"]), jds.knode_f,
        interpret=True, treelet=True))
    words, emeta = (v.numpy() for v in stg.stage_emit(
        t["scal"], t["smeta"], t["bscal"], tds.knode_f, TMAX,
        step_rows=step_rows))
    np.testing.assert_array_equal(emeta[:, :2], je[:, :2])
    assert not emeta[:, 1].any() and (j["smeta"][:, 1] > 0).sum() > 16
    cnt = np.minimum(emeta[:, 0], stg.PCAP)
    for s in np.nonzero(cnt)[0]:
        np.testing.assert_array_equal(words[s, :cnt[s]], jw[s, :cnt[s]])
    assert cnt.sum() > 100


@pytest.mark.parametrize("step_rows", [8, 1])
@pytest.mark.parametrize("step_cap", [stg.STEP_CAP, 7])
def test_emit_plain_stats_count_window_loads(staged, monkeypatch, step_cap,
                                             step_rows):
    """_emit_plain(stats=) leaves its output unchanged and counts kernel
    B's dependent loads: with one-row windows one a visited node, with
    windows wider than a table one a live slot (the walk only moves
    forward), fewer the wider the window; steps are emeta's step windows,
    nodes the nodes visited (as many as the steps at step_rows 1)."""
    _, tds, _, t = staged
    args = (t["scal"], t["smeta"], t["bscal"], tds.knode_f, TMAX, step_cap,
            stg.PCAP)
    words, emeta = stg._emit_plain(*args, step_rows=step_rows)
    whole = tds.knode_f.shape[0]
    windows = (1, 4, stg.EMIT_WINDOW, whole)
    loads = []
    for window in windows:
        monkeypatch.setattr(stg, "EMIT_WINDOW", window)
        st = {}
        w2, e2 = stg._emit_plain(*args, stats=st, step_rows=step_rows)
        assert torch.equal(w2, words) and torch.equal(e2, emeta)
        assert st["steps"] == int(emeta[:, 2].sum())
        assert st["max_steps"] == int(emeta[:, 2].max())
        loads.append(st["window_loads"])
    nodes = st["nodes"]
    assert st["max_nodes"] <= step_cap * step_rows
    if step_rows == 1:
        assert nodes == st["steps"]
    else:
        assert nodes > st["steps"]
    alive = int((t["smeta"][:, 1] > 0).sum())
    assert loads[0] == nodes and loads[-1] == alive
    assert loads == sorted(loads, reverse=True)
    assert alive < loads[1] < loads[0]


def walk_windows(nodef, scal, base, alive, step_cap, step_rows):
    """One slot's walk, node by node, with its step cap in windows of
    step_rows rows (stream3_stages._emit_plain): (step windows, nodes,
    hit leaves, rows visited)."""
    nrows = nodef.shape[0]
    idx, steps, nodes, hits, rows = (0 if alive else -1), 0, 0, 0, set()
    wend, prev = 0, -1
    while idx >= 0:
        if not prev < idx < wend:
            if steps == step_cap:
                break
            steps += 1
            wend = min(max(base + idx // step_rows * step_rows, 0),
                       nrows - step_rows) - base + step_rows
        row = nodef[base + idx]
        tn, tf = stg._interval_test(row[None, 0:3], row[None, 3:6],
                                    scal[None], TMAX)
        box_hit = bool(tf[0] >= tn[0]) and float(tn[0]) < TMAX
        leaf = float(row[10]) > 0.0
        hits += leaf and box_hit
        rows.add(base + idx)
        nodes += 1
        prev = idx
        idx = int(row[9]) if leaf or not box_hit else int(row[8])
    return steps, nodes, hits, rows


@pytest.mark.parametrize("step_rows", [8, 1])
@pytest.mark.parametrize("step_cap", [stg.STEP_CAP, 7])
def test_emit_counts_match_a_walk_of_each_slot(staged, step_cap, step_rows):
    """chip_smoke.emit_counts, which kernel B's bound reads, on two
    launches walked together: each launch's steps are _emit_plain's
    emeta lane 2, and its nodes, hit leaves and distinct rows those of a
    walk of each of its slots on its own (the visited leaves whose box
    the slot frustum hits; the node rows any of its slots visits)."""
    import chip_smoke
    _, tds, _, t = staged
    nodef = tds.knode_f
    alive = torch.nonzero(t["smeta"][:, 1] > 0).squeeze(1)
    sel = torch.cat([alive[torch.linspace(0, alive.numel() - 1, 12).long()],
                     torch.nonzero(t["smeta"][:, 1] == 0)[:2, 0]])
    launches = [(t["scal"][s], t["smeta"][s], nodef, TMAX, step_cap,
                 step_rows) for s in (sel[:5], sel[5:])]
    for (scal, smeta, *_), (steps, nodes, hit_leaves, nrows) in zip(
            launches, chip_smoke.emit_counts(stg, launches)):
        _, emeta = stg._emit_plain(scal, smeta, t["bscal"], nodef, TMAX,
                                   step_cap, stg.PCAP, step_rows=step_rows)
        assert torch.equal(steps, emeta[:, 2].long())
        walks = [walk_windows(nodef, scal[s], int(smeta[s, 2]),
                              int(smeta[s, 1]) > 0, step_cap, step_rows)
                 for s in range(scal.shape[0])]
        assert steps.tolist() == [w[0] for w in walks]
        assert nodes.tolist() == [w[1] for w in walks]
        assert hit_leaves == sum(w[2] for w in walks) > 0
        rows = set().union(*(w[3] for w in walks))
        assert nrows == len(rows) < int(nodes.sum())


def test_stage_refine_matches_jax(staged):
    _, _, j, t = staged
    words, emeta = stg.stage_refine(t["words"], t["emeta"],
                                    t["smeta"][:, 0].contiguous(),
                                    t["feats_t"], t["aabb8"], TMAX)
    words, emeta = words.numpy(), emeta.numpy()
    np.testing.assert_array_equal(emeta[:, 0], j["emeta_i"][:, 0])
    np.testing.assert_array_equal(emeta[:, 4], j["emeta_i"][:, 4])
    for s in np.nonzero(emeta[:, 0])[0]:
        np.testing.assert_array_equal(words[s, :emeta[s, 0]],
                                      j["words_i"][s, :emeta[s, 0]])
    assert emeta[:, 0].sum() > 100                # the case is not vacuous


def test_stage_isect_matches_jax(staged):
    _, tds, j, t = staged
    feats = stg.feats_rows_to_major(t["feats_t"])
    out = stg.stage_isect(t["words_i"], t["emeta_i"],
                          t["smeta"][:, 0].contiguous(), feats, tds.kleaf,
                          TMIN, TMAX, stable=tds.stable_frames).numpy()
    ref = j["out"]
    hit = hold(ref[..., 0].ravel(), ref[..., 1].ravel(),
               out[..., 0].ravel(), out[..., 1].ravel())
    assert hit.mean() > 0.02
    miss = ~hit
    assert (out[..., 1].ravel()[miss] == -1).all()
    same = hit & (ref[..., 1].ravel() == out[..., 1].ravel())
    for lane in (2, 3):
        np.testing.assert_allclose(out[..., lane].ravel()[same],
                                   ref[..., lane].ravel()[same], atol=1e-4)


def test_leaf_tables_match_jax():
    jds, tds = soup_pair(500, 6)
    ref = js3.leaf_tables(jds.knode_f, jds.kleaf.shape[0])
    got = ts3.leaf_tables(tds.knode_f, tds.kleaf.shape[0])
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert ts3.supports(tds) and js3.supports(jds)


def test_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run on CPU tensors: the stages route
    those to the plain versions."""
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError):
        stg.transpose_cuda(x)
    with pytest.raises(ValueError):
        stg.emit_cuda(x, x.int(), x, x, TMAX, 4, 8)


def test_isect_plain_stats_count_needed_tests(staged):
    """_isect_plain(stats=) leaves its output bit-identical, and counts
    what a brute-force loop over the word lists finds: the kept (leaf,
    block) pairs, their rays that are not parked, and each such ray times
    its leaf's triangle lanes (non-zero edge rows 3-5).  A third of the
    rays are parked at origin 1e30 (stream3.park_dead): they miss."""
    _, tds, j, t = staged
    feats = stg.feats_rows_to_major(t["feats_t"]).clone()
    park = np.random.default_rng(3).uniform(size=feats.shape[0]) < 0.3
    feats[torch.from_numpy(park), 6:9] = 1e30
    slot_pkt = t["smeta"][:, 0].contiguous()
    args = (t["words_i"], t["emeta_i"], slot_pkt, feats, tds.kleaf, TMIN,
            TMAX, stg.PCAP, tds.stable_frames)
    st = {}
    counted = stg._isect_plain(*args, stats=st)
    plain = stg._isect_plain(*args)
    assert counted.numpy().tobytes() == plain.numpy().tobytes()
    lanes_of = slot_pkt.numpy().astype(np.int64)[:, None] * stg.PKT \
        + np.arange(stg.PKT)
    assert (plain[..., 0].numpy()[park[lanes_of]] == np.float32(FLT_MAX)).all()

    kleaf = tds.kleaf.numpy()
    nl, T = kleaf.shape[0], stg.T
    tri_lanes = (kleaf[:, 3:6, :3 * T].reshape(nl, 3, 3, T) != 0).any(
        axis=(1, 2)).sum(axis=1)
    words, cnt = j["words_i"], np.minimum(j["emeta_i"][:, 0], stg.PCAP)
    pairs = rays = tris = 0
    for s in range(words.shape[0]):
        for p in range(cnt[s]):
            w = int(words[s, p])
            leaf = max((w >> stg.W_LEAF_SHIFT) - 1, 0)
            for b in range(8):
                if (w >> (stg.W_KEEP_SHIFT + b)) & 1:
                    lo = int(slot_pkt[s]) * stg.PKT + b * stg.BLK
                    r = int((~park[lo:lo + stg.BLK]).sum())
                    pairs += 1
                    rays += r
                    tris += r * int(tri_lanes[leaf])
    assert st == dict(pairs=pairs, ray_tests=rays, tri_tests=tris)
    assert 0 < rays < pairs * stg.BLK and tris < rays * T
