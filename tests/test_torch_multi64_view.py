"""The 64-instance TLAS scene (rtbench's multi64_1m configuration) on the
port's normal path, at a small size on the CPU.

rtbench/geometry/multi64.py's 8 meshes and 64 translations, cut to a few
thousand triangles and packed before a near eye (rtbench's tiny copy of
the configuration), are written as a GLB of 8 meshes and 64 nodes
(scene/glb_writer.write_glb), loaded by scene/loader.load_scene and
rendered by samples/sample1.Sample1: every wave of the engine, primary,
bounce and shadow, goes through the instance scan
(ops/stream3_multi.trace_rows_multi).  Held here:

  * the frames against rtbench's plain reference (rtbench/reference/
    shade.py) over the scene flattened into world-space triangles, one
    tree and no TLAS;
  * the loaded scene: 64 instances over 8 unique kernel BLASes
    (inst_kblas), each slot with its node's translation, and the
    instance-ordered MeshInfo table;
  * the spans and counts of stream3_multi (multi.trace, multi.cull, the
    stream3 stages nested in them) against trace_rows_multi's
    diagnostics, the forced poisoning of an overflowed block list
    included, and no host read for the poisoned count while spans are
    off;
  * the scan's stream3 runs over many instances' sub-waves (one in all on
    the BLASes' tables end to end, or one a BLAS): every packet keeps the
    slots of a run of its instance alone (stream3._stage_prep's
    per-segment octant pools), and the records equal those of one run per
    instance, on the CPU and (marked gpu) on the card;
  * on the card only (marked gpu; it skips here), that the engine takes
    the fused material wave on the 64-entry instance table.

Tolerance of the frames: the port traces each ray in its instance's
object space and the reference in world space, where every vertex was
moved by its translation in float32, so a hit distance may differ in its
last bits; at a triangle's edge that flips a hit, and a bounce drawn from
a flipped hit goes elsewhere.  So: a mean u8 gap of at most 0.25 and at
most 2% of the values more than 1 apart (the reference's own bfloat16
copy reads 13.6 and 35% on this scene, rtbench's control).

This file imports nothing of JAX.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from radiance_tpu_torch.api import platform  # noqa: E402
from radiance_tpu_torch.api.sbt import ShaderBindingTable  # noqa: E402
from radiance_tpu_torch.core import types  # noqa: E402
from radiance_tpu_torch.engine import pathtracer, shaders  # noqa: E402
from radiance_tpu_torch.ops import stream3, stream3_multi  # noqa: E402
from radiance_tpu_torch.samples import sample1  # noqa: E402
from radiance_tpu_torch.scene import loader  # noqa: E402
from radiance_tpu_torch.shading import camera as tcam  # noqa: E402
from radiance_tpu_torch.utils import profiling  # noqa: E402
from rtbench import check  # noqa: E402
from rtbench.drivers import view_glb  # noqa: E402
from rtbench.geometry import multi64  # noqa: E402
from rtbench.reference import shade, trace  # noqa: E402

TMIN, TMAX = 1e-3, 1e3
W, H = 16, 12
MEAN_GAP, GAP_SHARE = 0.25, 0.02
STAGES = {"stream3.prep", "stream3.emit", "stream3.refine", "stream3.isect",
          "stream3.glue"}


def _config():
    """rtbench's multi64_1m with its tiny copy's keys."""
    cfg = {}
    for path in ("rtbench/configs/multi64_1m.json",
                 "rtbench/tests/tiny/configs/multi64_1m.json"):
        with open(os.path.join(ROOT, path)) as f:
            cfg.update(json.load(f))
    return cfg


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """(configuration, the generator's scene, the loaded HostScene, its
    DeviceScene on the CPU) of the GLB path."""
    cfg = _config()
    scene = multi64.scene(cfg["n_tris"], cfg["seed"], **cfg["generator_args"])
    path = str(tmp_path_factory.mktemp("glb") / "multi64.glb")
    view_glb.write_glb(path, multi64, scene, cfg["material"])
    host = loader.load_scene(path, verbose=False, device="cpu")
    ds = host.tlas.device_scene("cpu", leaf_cap=cfg["leaf_cap"])
    return cfg, scene, host, ds


def test_loaded_scene_shares_8_blases_over_64_instances(loaded):
    cfg, (meshes, translations, mesh_of), host, ds = loaded
    assert len(ds.inst_kblas) == 64 and len(set(ds.inst_kblas)) == 8
    assert stream3_multi.supports(ds) and pathtracer._many_instances(ds)
    created = ds.inst_id.tolist()
    assert sorted(created) == list(range(64))
    # a slot's BLAS is its node's mesh: one kernel BLAS a mesh
    blas_of_mesh = {}
    for slot, c in enumerate(created):
        assert blas_of_mesh.setdefault(int(mesh_of[c]),
                                       ds.inst_kblas[slot]) == \
            ds.inst_kblas[slot]
        assert torch.equal(ds.inst_transform[slot][:3, 3],
                           torch.from_numpy(translations[c]))
    assert len(set(blas_of_mesh.values())) == 8
    # the MeshInfo table in instance (node) order: copies of a mesh share
    # its offsets (floats for vertices, indices for triangles; one vertex
    # a triangle corner here)
    first = np.cumsum([0] + [len(m) for m in meshes])
    assert [m.vertex_offset for m in host.mesh_infos] == [
        int(first[m]) * 3 for m in mesh_of]
    assert [m.index_offset for m in host.mesh_infos] == [
        int(first[m]) for m in mesh_of]


def test_frames_match_the_reference(loaded, one_thread):
    """Two b1 d2 frames through Sample1 against the plain reference at
    every pixel."""
    cfg, scene, host, _ = loaded
    cam = cfg["camera"]
    camera = types.PhysicalCamera(
        width_pixel=float(W), height_pixel=float(H),
        focal_length=cam["focal_length"], sensor_width=cam["sensor_width"],
        focal_distance=cam["focal_distance"], f_stop=0.0,
        x=cfg["eye"][0], y=cfg["eye"][1], z=cfg["eye"][2])
    platform.Platform._instance = None
    try:
        s1 = sample1.Sample1(W, H, 1, 2, scene=host, camera=camera,
                             device="cpu")
        # (a frame's image is read into one buffer: copy it out)
        got = np.stack([s1.render_frame().reshape(-1, 4)[:, :3].astype(
            np.float32) for _ in range(2)])
    finally:
        platform.Platform._instance = None
    verts, tris, fn = multi64.world(*scene)
    tree = trace.build(torch.from_numpy(verts[tris.astype(np.int64)]))
    ref = shade.Frames(tree, torch.from_numpy(fn), W, H,
                       dict(cam, eye=cfg["eye"]), cfg["view_light"],
                       cfg["material"], 2)
    want = ref.images(torch.arange(W * H), 2, 1)
    r = check.view_readings(torch.from_numpy(got), want)
    assert (want[-1] != want[-1][0]).any()         # not a blank image
    assert r["u8_mean_gap"] <= MEAN_GAP and r["u8_gap_share"] <= GAP_SHARE, r


def _camera_rows(cfg, n=768, w=32):
    """A pinhole camera's rays from the configuration's eye, down -z."""
    ij = np.arange(n)
    d = np.stack([((ij % w) / w - 0.5) * 1.2,
                  ((ij // w) / (n / w) - 0.5) * 0.7,
                  np.full(n, -1.0)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.float32([cfg["eye"]]), (n, 1))
    return stream3.rows_from_aos(torch.from_numpy(o), torch.from_numpy(d))


def _down_rows(ds, n=3 * 8192):
    """n rays straight down onto slot 0's box: every block overlaps it."""
    lo, hi = stream3_multi.multi_tables(ds).aabb_w[0].reshape(2, 3)
    o = np.tile(np.float32([[(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2,
                             hi[2] + 10.0]]), (n, 1))
    d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
    return stream3.rows_from_aos(torch.from_numpy(o), torch.from_numpy(d))


def _profiled():
    """A CPU profile whose first span restarts the log."""
    with profiling.span("off"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("case", ["camera", "camera_occl", "overflow"])
def test_multi_spans_note_the_scan(loaded, one_thread, case):
    """multi.trace is the root of one trace_rows_multi call, multi.cull
    and every stream3 stage nest in it, and its counts are the scan's
    (with_diag's): an overflowed block list (bcap 1 on 192 blocks over
    one instance) reads poisoned > 0."""
    cfg, _, _, ds = loaded
    mt = stream3_multi.multi_tables(ds)
    kw = dict(occl=case == "camera_occl")
    rows = _camera_rows(cfg)
    if case == "overflow":
        rows, kw = _down_rows(ds), dict(bcap_blocks=1)
    with _profiled():
        rec, diag = stream3_multi.trace_rows_multi(ds, mt, rows, TMIN, TMAX,
                                                   with_diag=True, **kw)
    recs = profiling.spans().records
    top = [r for r in recs if r.name == "multi.trace"]
    assert len(top) == 1 and top[0].parent == -1
    i = recs.index(top[0])
    children = {r.name for r in recs if r.parent == i}
    assert "multi.cull" in children and STAGES <= children
    assert all(r.root == i for r in recs if r.name != "off")
    c = top[0].counts
    n = rows[0].shape[0]
    blocks = -(-n // 8192) * 64
    assert c == dict(rays=n, instances=64,
                     instances_run=diag["instances_run"], blocks=blocks,
                     block_pairs=c["block_pairs"],
                     poisoned=diag["poisoned"])
    assert 1 <= c["instances_run"] <= c["instances"]
    assert 0 < c["block_pairs"] <= min(diag["pairs"], blocks * 64)
    assert c["poisoned"] == int((rec.slot == -2).sum())
    if case == "overflow":
        # each overlapped instance keeps 64 of the 192 blocks; the other
        # 128 blocks' rays are poisoned
        assert c["block_pairs"] == 64 * c["instances_run"] < diag["pairs"]
        assert c["poisoned"] == 128 * 128
    else:
        assert c["block_pairs"] == diag["pairs"] and c["poisoned"] == 0


class _Reads(TorchDispatchMode):
    """Counts the host reads of tensor values (.item(), int(), bool())."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_poisoned_is_read_only_while_traced(loaded, one_thread):
    """With spans off the scan makes one host read fewer than with a
    profiler on: the poisoned count's; the records are the same."""
    _, _, _, ds = loaded
    mt = stream3_multi.multi_tables(ds)
    rows = _down_rows(ds, 256)
    reads, recs = [], []
    for traced in (False, True):
        with _Reads() as r:
            if traced:
                with _profiled():
                    rec = stream3_multi.trace_rows_multi(ds, mt, rows, TMIN,
                                                         TMAX)
            else:
                rec = stream3_multi.trace_rows_multi(ds, mt, rows, TMIN,
                                                     TMAX)
        reads.append(r.n)
        recs.append(rec)
    assert reads[1] == reads[0] + 1
    for f in ("t", "prim", "slot", "b1", "b2"):
        assert torch.equal(getattr(recs[0], f), getattr(recs[1], f))


@pytest.mark.gpu
def test_fused_material_wave_on_64_instances(tmp_path):
    """On the card, the engine's fused material wave takes the 64-entry
    instance table of the loaded scene (every instance's SBT offset 0,
    the built-in material and environment records)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused material wave runs only "
                    "there")
    cfg = _config()
    scene = multi64.scene(cfg["n_tris"], cfg["seed"], **cfg["generator_args"])
    path = str(tmp_path / "multi64.glb")
    view_glb.write_glb(path, multi64, scene, cfg["material"])
    host = loader.load_scene(path, verbose=False, device="cuda")
    ds = host.tlas.device_scene("cuda", leaf_cap=cfg["leaf_cap"])
    assert ds.inst_sbt.shape == (64,)
    tracer = pathtracer.WavefrontPathTracer(
        ray_generator=tcam.physical_camera_raygen,
        sbt=ShaderBindingTable.from_json(shaders.DEFAULT_SBT_RECORDS,
                                         shaders.SHADER_REGISTRY))
    assert tracer.fuses_material(ds, tracer.hit_offset, tracer.miss_index, 0)


def _storage(prep):
    """_stage_prep's (scal, smeta) back in storage order."""
    _, _, scal, smeta, _, order = prep
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0])
    return scal[inv], smeta[inv]


def test_prep_gives_each_segment_its_own_pool(loaded, one_thread):
    """A wave of 5 segments of one group each, every packet holding rays
    of all 8 octants (320 octant slots, past one EXTRA pool of 256): each
    segment's base and octant slots are those of its sub-wave prepped
    alone, its pool at npk + k * EXTRA."""
    _, _, _, ds = loaded
    nodef = ds.kblas[ds.inst_kblas[0]][0]
    gen = torch.Generator().manual_seed(5)
    nseg, per = 5, stream3.G * stream3.PKT
    o = torch.rand(nseg * per, 3, generator=gen) * 4.0
    d = torch.nn.functional.normalize(torch.randn(nseg * per, 3,
                                                  generator=gen), dim=1)
    rows = stream3.rows_from_aos(o, d)
    npk_s = per // stream3.PKT
    pkt_seg = torch.arange(nseg).repeat_interleave(npk_s)
    scal, smeta = _storage(stream3._stage_prep(
        rows, nodef, torch.eye(4), stable=False, segments=(pkt_seg, nseg)))
    npk, extra = nseg * npk_s, stream3.EXTRA
    assert scal.shape[0] == npk + nseg * extra
    used = 0
    for k in range(nseg):
        alone = stream3._stage_prep(
            tuple(r[k * per:(k + 1) * per] for r in rows), nodef,
            torch.eye(4), stable=False)
        a_scal, a_meta = _storage(alone)
        a_meta = a_meta.clone()
        a_meta[:, 0] += torch.where(a_meta[:, 1] > 0, k * npk_s, 0)
        a_meta[:npk_s, 0] = torch.arange(npk_s) + k * npk_s
        base = slice(k * npk_s, (k + 1) * npk_s)
        pool = slice(npk + k * extra, npk + (k + 1) * extra)
        assert torch.equal(scal[base], a_scal[:npk_s])
        assert torch.equal(smeta[base], a_meta[:npk_s])
        assert torch.equal(scal[pool], a_scal[npk_s:])
        assert torch.equal(smeta[pool], a_meta[npk_s:])
        used += int((a_meta[npk_s:, 1] > 0).sum())
    assert used > extra                   # one shared pool would not fit


def _one_run_an_instance(monkeypatch):
    """trace_rows_multi's plan cut into one stream3 run per instance, each
    on its own BLAS's tables: the scan instance by instance."""
    plan_runs = stream3_multi._plan

    def plan(mt, n_act, one_run):
        p, runs = plan_runs(mt, n_act, False)
        out = []
        for k0, k1, _ in runs:
            cut = [k0, *(k0 + np.flatnonzero(np.diff(p[2, k0:k1])) + 1), k1]
            out += [(a, b, 1) for a, b in zip(cut[:-1], cut[1:])]
        p = p.copy()
        p[2] = 0
        return p, out

    monkeypatch.setattr(stream3_multi, "_plan", plan)
    monkeypatch.setattr(stream3_multi, "supports_native",
                        lambda mt, tq_bits=None: False)


def _aimed_rows(ds, cfg, device, per=128):
    """`per` rays from the eye at seeded points of each of the first three
    copies of one mesh: blocks over many instances, copies of every mesh
    among them."""
    mt = stream3_multi.multi_tables(ds)
    gen = torch.Generator().manual_seed(9)
    tgt = []
    for s in np.flatnonzero(mt.inst_idx == 0)[:3]:
        lo, hi = torch.from_numpy(mt.aabb_w[s]).reshape(2, 3)
        tgt.append(lo + torch.rand(per, 3, generator=gen) * (hi - lo))
    tgt = torch.cat(tgt)
    o = torch.tensor(cfg["eye"], dtype=torch.float32).expand_as(tgt)
    d = torch.nn.functional.normalize(tgt - o, dim=1)
    return stream3.rows_from_aos(o.contiguous().to(device), d.to(device))


def _runs_and_instance_by_instance(cfg, ds, monkeypatch, occl, runs):
    mt = stream3_multi.multi_tables(ds)
    dev = ds.inst_inv.device
    rows = _aimed_rows(ds, cfg, dev)
    n = rows[0].shape[0]
    live = torch.rand(n, generator=torch.Generator().manual_seed(3)) > 0.1
    kw = dict(live=live.to(dev), occl=occl, with_diag=True)
    assert stream3_multi.supports_native(mt)
    with monkeypatch.context() as m:
        if runs == "by_blas":       # the leaf rows past the word's reach
            m.setattr(stream3_multi, "supports_native",
                      lambda mt, tq_bits=None: False)
        got, gd = stream3_multi.trace_rows_multi(ds, mt, rows, TMIN, TMAX,
                                                 **kw)
    with monkeypatch.context() as m:
        _one_run_an_instance(m)
        want, wd = stream3_multi.trace_rows_multi(ds, mt, rows, TMIN, TMAX,
                                                  **kw)
    assert gd == wd and gd["instances_run"] > 8
    for f in ("t", "prim", "slot", "b1", "b2"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (got.slot >= 0).sum() > 100 and (got.slot == -1).any()


@pytest.mark.parametrize("runs", ["one", "by_blas"])
@pytest.mark.parametrize("occl", [False, True])
def test_scan_runs_match_instance_by_instance(loaded, one_thread,
                                              monkeypatch, occl, runs):
    """One stream3 run over every instance's sub-wave on the BLASes'
    tables end to end, or one a BLAS on its own tables, gives the records
    and diagnostics of one run per instance, bit for bit."""
    _runs_and_instance_by_instance(loaded[0], loaded[3], monkeypatch, occl,
                                   runs)


@pytest.mark.gpu
@pytest.mark.parametrize("runs", ["one", "by_blas"])
@pytest.mark.parametrize("occl", [False, True])
def test_scan_runs_match_instance_by_instance_on_the_card(
        monkeypatch, tmp_path, occl, runs):
    """The same on the card, through the CUDA stages."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stream3 kernels run only there")
    cfg = _config()
    scene = multi64.scene(cfg["n_tris"], cfg["seed"], **cfg["generator_args"])
    path = str(tmp_path / "multi64.glb")
    view_glb.write_glb(path, multi64, scene, cfg["material"])
    host = loader.load_scene(path, verbose=False, device="cuda")
    ds = host.tlas.device_scene("cuda", leaf_cap=cfg["leaf_cap"])
    _runs_and_instance_by_instance(cfg, ds, monkeypatch, occl, runs)
