"""The CUDA kernels vs their plain PyTorch versions, on the card: the
packet-trace kernel and the stream3 pipeline's six kernels (the two
transposes, emit walk, exact refine, closest-hit and occlusion pair
intersection, prep octant scalars), the many-instance scan and the
TLAS-native route on the card against their CPU routes, and sample1's RD-API route against a direct
render of the same inputs; a temporally bounded stream3 wave against
its unbounded trace, and the temporal cull on the card against the CPU;
kernel C's tq-sort form and kernel D's lean and cull forms against their
plain versions on hand-made lists, long lists and exact ties; B-E built
for leaf caps 64, 256 and 512 and tq widths 7, 9 and 5, and the packet
kernel on those caps, against their plain versions; kernel B's step cap in windows of 8
and of 1 rows, also where the window start clamps at the end of the
native route's concatenated tables; and B-E and the packet kernel on
tables of the SAH-driven leaf collapse.

Every case is marked `gpu` and skips (with the reason) where no CUDA
card is present; the `cuda` fixture decides at run time, never at
import.  This file imports nothing of JAX, so on the card's machine it
runs without the JAX package's conftest:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest

Bars (the port's traversal bars): hit/miss agreement >= 0.999, prim
agreement >= 0.999 on rays both hit, p99 relative |dt| <= 1e-5 where
both agree on the prim (the kernel sums the leaf products in another
order, with FMAs, than the plain version's matmul; near-cancelling side
products amplify that on a few rays); any-hit variants are compared on
occluded or not.  Stream3: the transposes are bit-exact, emit and
refine give identical word lists (no FMA contraction in either), the
pair intersection and the whole wave hold the traversal bars.  The
octant scalars equal the plain version's value for value (a minimum or
maximum over +0 and -0 may return either zero); the occlusion pair
kernel's out lanes equal the plain version's on >= 0.999 of rays (FMA
contraction may move a hit at t ~ tmin or tmax, or on an edge).
"""

import numpy as np
import pytest
import torch

from radiance_tpu_torch.api import accel
from radiance_tpu_torch.api.sbt import ShaderBindingTable
from radiance_tpu_torch.core import math as rmath
from radiance_tpu_torch.core import types
from radiance_tpu_torch.engine import shaders
from radiance_tpu_torch.engine.pathtracer import WavefrontPathTracer
from radiance_tpu_torch.ops import packet_trace as pk
from radiance_tpu_torch.ops import stream3 as s3
from radiance_tpu_torch.ops import stream3_multi as s3m
from radiance_tpu_torch.ops import stream3_stages as stg
from radiance_tpu_torch.ops.intersect import FLT_MAX, intersect_triangle_soup
from radiance_tpu_torch.scene import procedural
from radiance_tpu_torch.shading import camera

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the packet-trace kernel runs only on "
                    "the GPU (CPU tensors take its plain version, tested "
                    "in test_torch_packet_trace.py)")
    pk.load_kernel()
    stg.load_kernels()
    return torch.device("cuda")


def _mesh(seed, n_tris, spread, offset=0.0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    v = (c[:, None, :] + rng.normal(scale=0.5, size=(n_tris, 3, 3))
         .astype(np.float32)).reshape(-1, 3) + np.float32(offset)
    return types.Mesh(v.astype(np.float32),
                      np.arange(3 * n_tris, dtype=np.uint32).reshape(-1, 3))


def _scene(mesh):
    blas = accel.BuildBottomAccelStruct(mesh)
    return accel.BuildTopAccelStruct(
        [types.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)])


def _rays(seed, n, spread):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def diffuse_bounces(verts, tris, o, d, t, prim, seed):
    """A diffuse bounce wave off primary hits (o + t d on face `prim` of
    the mesh): directions drawn cosine-weighted about each face's normal
    turned toward the ray, from 1e-3 in front of the hit; (o, d) sorted
    by coherence_key, as the engine's argsort route sorts a bounce wave.
    numpy in, numpy out."""
    p = o + t[:, None] * d
    tv = verts[tris[prim].astype(np.int64)]
    nrm = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where(((nrm * d).sum(1) > 0)[:, None], -nrm, nrm)
    rng = np.random.default_rng(seed)
    u1, u2 = rng.uniform(size=len(t)), rng.uniform(size=len(t))
    r, phi = np.sqrt(u1), 2 * np.pi * u2
    a = np.where(np.abs(nrm[:, :1]) > 0.9, [[0.0, 1.0, 0.0]],
                 [[1.0, 0.0, 0.0]])
    tx = np.cross(a, nrm)
    tx /= np.linalg.norm(tx, axis=1, keepdims=True)
    ty = np.cross(nrm, tx)
    bd = ((r * np.cos(phi))[:, None] * tx + (r * np.sin(phi))[:, None] * ty
          + np.sqrt(1 - u1)[:, None] * nrm).astype(np.float32)
    bo = (p + 1e-3 * nrm).astype(np.float32)
    perm = torch.argsort(pk.coherence_key(torch.from_numpy(bo),
                                          torch.from_numpy(bd)),
                         stable=True).numpy()
    return bo[perm], bd[perm]


def hall_primary_hits(tlas_or_scene, meta, w, h):
    """The hall's w x h pinhole primaries from its camera, traced by the
    plain version on the CPU: (o, d, t, prim) of the rays that hit."""
    u, v = np.meshgrid(np.linspace(-0.6, 0.6, w), np.linspace(-0.4, 0.4, h))
    d = np.stack([u.ravel(), v.ravel(), -np.ones(w * h)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.tile(np.float32(meta["camera_origin"]), (w * h, 1))
    rec = pk.trace_rays_packet(tlas_or_scene, torch.from_numpy(o),
                               torch.from_numpy(d), 1e-3, 1e3)
    hit = rec.hit.numpy()
    return o[hit], d[hit], rec.t.numpy()[hit], rec.prim.numpy()[hit]


@pytest.fixture(scope="module")
def hall():
    """A small interior hall (20k triangles) and two waves off its 64 x 48
    primaries' hits, each sorted as the engine sorts it: diffuse bounces,
    then shadow rays toward the hall's light; (tlas, o, d), 64-ray
    packets of the first wave then of the second."""
    verts, tris, meta = procedural.interior_hall(20000, seed=11)
    tlas = _scene(types.Mesh(verts, tris))
    o, d, t, prim = hall_primary_hits(tlas.device_scene("cpu"), meta, 64, 48)
    k = (len(t) // 64) * 64
    bo, bd = diffuse_bounces(verts, tris, o[:k], d[:k], t[:k], prim[:k], 6)
    sd = np.tile(np.float32(meta["light_dir"]), (k, 1))
    perm = torch.argsort(pk.coherence_key(torch.from_numpy(bo),
                                          torch.from_numpy(sd)),
                         stable=True).numpy()
    return tlas, np.concatenate([bo, bo[perm]]), np.concatenate([bd, sd])


def _agree(ref, got, any_hit):
    hr = ref.t.cpu().numpy() < FLT_MAX
    hg = got.t.cpu().numpy() < FLT_MAX
    assert (hr == hg).mean() >= 0.999
    if any_hit:
        return hg
    both = hr & hg
    pr, pg = ref.prim.cpu().numpy(), got.prim.cpu().numpy()
    assert (pr[both] == pg[both]).mean() >= 0.999
    same = both & (pr == pg)
    tr, tg = ref.t.cpu().numpy()[same], got.t.cpu().numpy()[same]
    rel = np.abs(tg - tr) / np.abs(tr)
    assert np.quantile(rel, 0.99) <= 1e-5 and rel.max() <= 1e-3
    return hg


@pytest.mark.parametrize("rays", ["random", "hall"])
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_plain(cuda, any_hit, masked, stable, rays, hall):
    """Each variant against the plain version: random rays into a random
    soup, and the small hall's diffuse bounces and shadows as the engine
    sorts them (packets whose rays fan out, and coherent ones)."""
    if rays == "random":
        tlas = _scene(_mesh(10, 3000, 8.0))
        o, d = _rays(1, 5000, 10.0)
    else:
        tlas, o, d = hall
    n = o.shape[0]
    live = (np.random.default_rng(2).uniform(size=n) < 0.6
            if masked else None)
    out = {}
    for dev in ("cpu", cuda):
        ds = tlas.device_scene(dev, stable_frames=stable)
        out[str(dev)] = pk.trace_rays_packet(
            ds, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            1e-3, 1e3, any_hit=any_hit,
            live=None if live is None else torch.from_numpy(live).to(dev))
    torch.cuda.synchronize()
    hit = _agree(out["cpu"], out["cuda"], any_hit)
    assert hit.mean() > 0.05
    if masked:
        assert not hit[~live].any()
    key = pk.variant(any_hit, masked, stable)
    assert pk.packet_trace_cuda.launches[key] >= 1


def test_kernel_far_grazing_scene_vs_soup(cuda):
    offset = np.float32(600.0)
    mesh = _mesh(5, 400, 5.0, offset)
    ds = _scene(mesh).device_scene(cuda)
    rng = np.random.default_rng(7)
    o = np.full((4096, 3), offset, np.float32)
    o[:, 2] += 60.0
    d = offset + rng.uniform(-5, 5, (4096, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    got = pk.trace_rays_packet(ds, o_t, d_t, 1e-3, 1e4)
    v = torch.from_numpy(mesh.vertices).to(cuda)
    tri = torch.from_numpy(mesh.triangles.astype(np.int64)).to(cuda)
    t_ref, _, _, _ = intersect_triangle_soup(
        o_t, d_t, v[tri[:, 0]], v[tri[:, 1]] - v[tri[:, 0]],
        v[tri[:, 2]] - v[tri[:, 0]], 1e-3, 1e4)
    hr = (t_ref < FLT_MAX).cpu().numpy()
    hg = got.hit.cpu().numpy()
    assert (hr == hg).mean() >= 0.999 and hr.mean() > 0.2


def test_kernel_axis_parallel_and_degenerate_rays(cuda):
    """d.x == 0 columns on slab planes and zero directions: the kernel
    follows the plain version's NaN semantics; zero directions miss."""
    tlas = _scene(_mesh(3, 500, 4.0))
    rng = np.random.default_rng(4)
    o = np.round(rng.uniform(-4, 4, (2048, 3))).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d[:, 0] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:16] = 0.0
    res = {}
    for dev in ("cpu", cuda):
        ds = tlas.device_scene(dev)
        res[str(dev)] = pk.trace_rays_packet(
            ds, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            1e-3, 1e3)
    _agree(res["cpu"], res["cuda"], False)
    assert (res["cuda"].t[:16].cpu() == np.float32(FLT_MAX)).all()


def test_pcg3d_on_card_bit_exact(cuda):
    rng = np.random.default_rng(0)
    v = rng.integers(0, 2 ** 32, size=(10000, 3), dtype=np.uint64)
    t = torch.from_numpy(v.astype(np.int64))
    assert torch.equal(rmath.pcg3d_words(t.to(cuda)).cpu(),
                       rmath.pcg3d_words(t))
    assert (rmath.pcg3d(t.to(cuda)).cpu().numpy().tobytes()
            == rmath.pcg3d(t).numpy().tobytes())


def test_wrapper_raises_on_bad_input(cuda):
    ds = _scene(_mesh(1, 100, 3.0)).device_scene(cuda)
    o = torch.zeros(8, 3, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        pk.packet_trace_cuda(o, o, None, ds.knode_f, ds.kleaf, 1e-3, 1e3,
                             any_hit=False, stable=True)


@pytest.mark.parametrize("scene", ["cornell", "single"])
def test_render_on_card_matches_cpu(cuda, scene):
    w = 48
    sbt = ShaderBindingTable.from_json(shaders.DEFAULT_SBT_RECORDS,
                                       shaders.SHADER_REGISTRY)
    tracer = WavefrontPathTracer(ray_generator=camera.physical_camera_raygen,
                                 sbt=sbt)
    cam = types.PhysicalCamera(width_pixel=float(w), height_pixel=float(w),
                               focal_length=0.035, sensor_width=0.05,
                               focal_distance=8.0, z=4.0 if scene == "cornell"
                               else 30.0)
    imgs = {}
    for dev in ("cpu", cuda):
        if scene == "cornell":
            host = procedural.cornell_box(device=dev)
        else:
            m = _mesh(9, 4000, 8.0)
            host = procedural.assemble_scene(
                [(m.vertices, m.triangles, np.tile([[0, 0, 1.0]],
                                                   (len(m.vertices), 1))
                  .astype(np.float32), np.zeros_like(m.vertices), 0)],
                [types.Material()], types.SceneProperties(lights=[
                    types.DirLight(direction=(0.3, -1.0, -0.4, 0.0))]),
                device=dev)
        res = dict(host.resources)
        res["camera"] = camera.camera_params(cam, dev)
        acc, img = tracer.render(host.device_scene(dev), res,
                                 torch.zeros(w * w, 3, device=dev), 0, w, w,
                                 batch=2, depth=2)
        assert torch.isfinite(acc).all()
        imgs[str(dev)] = img.cpu().numpy()[..., :3].astype(np.float64)
    rmse = np.sqrt(np.mean((imgs["cpu"] - imgs["cuda"]) ** 2))
    assert rmse < 3.0, rmse
    assert imgs["cuda"].std() > 1.0


def test_s3_transpose_bit_exact(cuda):
    """Kernel A's two launches bit-exact with .t().contiguous(): AoS ->
    rows at odd n (a ragged last warp, n < 32, a view off 16-byte
    alignment), [16, C] -> [C, 16] just past a 256-column tile and at a
    width that is no multiple of 4."""
    rng = np.random.default_rng(0)
    stg.reset_launches()

    def same(got, ref):
        return got.cpu().numpy().tobytes() == ref.numpy().tobytes()

    for n in (1, 31, 1025, 5000, 3 * stg.PKT + 7):
        x = torch.from_numpy(rng.standard_normal((n + 1, 6))
                             .astype(np.float32))
        for lo in (0, 1):              # lo = 1: offset views, scalar path
            o, d = x[lo:, :3].contiguous(), x[lo:, 3:].contiguous()
            o_c, d_c = o.to(cuda), d.to(cuda)
            if lo:
                o_c, d_c = x[:, :3].to(cuda)[1:], x[:, 3:].to(cuda)[1:]
            ref = torch.cat([o.t(), d.t()]).contiguous()
            assert same(stg.aos_rows_cuda(o_c, d_c), ref), (n, lo)
            rows = s3.rows_from_aos_fast(o_c, d_c)
            assert same(torch.stack(rows), ref)
    for c in (8192, 8192 + 4, 8192 + 1, 3):
        x = torch.from_numpy(rng.standard_normal((16, c)).astype(np.float32))
        assert same(stg.transpose_cuda(x.to(cuda)), x.t().contiguous()), c
    assert stg.aos_rows_cuda.launches == 20
    assert stg.transpose_cuda.launches == 4


def _s3_stages(dev, tlas, n=8192, seed=7, leaf_cap=128):
    """A mixed-octant wave through prep on `dev`: the stage inputs."""
    ds = tlas.device_scene(dev, leaf_cap=leaf_cap)
    o, d = _rays(seed, n, 10.0)
    rows = s3.rows_from_aos(torch.from_numpy(o).to(dev),
                            torch.from_numpy(d).to(dev))
    _, feats_t, scal, smeta, bscal, _ = s3._stage_prep(
        rows, ds.knode_f, ds.inst_inv[0], stable=ds.stable_frames)
    return ds, feats_t, scal, smeta, bscal


def test_s3_emit_and_refine_identical_to_plain(cuda):
    tlas = _scene(_mesh(10, 3000, 8.0))
    ds, feats_t, scal, smeta, bscal = _s3_stages(cuda, tlas)
    wk, ek = stg.emit_cuda(scal, smeta, bscal, ds.knode_f, 1e3, stg.STEP_CAP,
                           stg.PCAP)
    wp, ep = stg._emit_plain(scal, smeta, bscal, ds.knode_f, 1e3,
                             stg.STEP_CAP, stg.PCAP)
    assert torch.equal(ek, ep)
    cnt = torch.clamp(ek[:, 0], max=stg.PCAP)
    valid = torch.arange(stg.PCAP, device=cuda)[None, :] < cnt[:, None]
    assert torch.equal(wk[valid], wp[valid]) and int(cnt.sum()) > 100
    slot_pkt = smeta[:, 0].contiguous()
    aabb8 = s3.leaf_aabb8(ds.knode_f, ds.kleaf.shape[0])
    rk, rek = stg.refine_cuda(wk, ek, slot_pkt, feats_t, aabb8, 1e3,
                              stg.PCAP)
    rp, rep = stg._refine_plain(wp, ep, slot_pkt, feats_t, aabb8, 1e3,
                                stg.PCAP)
    assert torch.equal(rek, rep)
    valid = torch.arange(stg.PCAP, device=cuda)[None, :] < rek[:, :1]
    assert torch.equal(rk[valid], rp[valid])


def _emit_pair(args, step_rows=stg.STEP_ROWS):
    """Kernel B and its plain version on the same arguments and step
    windows: emeta and the valid words identical.  Returns the emeta."""
    wk, ek = stg.emit_cuda(*args, step_rows=step_rows)
    wp, ep = stg._emit_plain(*args, step_rows=step_rows)
    assert torch.equal(ek, ep)
    valid = (torch.arange(args[6], device=ek.device)[None, :]
             < torch.clamp(ek[:, :1], max=args[6]))
    assert torch.equal(wk[valid], wp[valid])
    return ek


@pytest.mark.parametrize("step_rows", [1, 8])
def test_s3_emit_edge_cases(cuda, step_rows):
    """Kernel B against its plain version where its windows could go
    wrong: step caps that cut a walk inside a load window and on its
    edges (node steps), or after one step window, list caps the count
    runs past, dead slots, NaN slot scalars, slots sharing a packet (the
    mixed-octant pool), every octant table walked to its end (the last
    one's final window reaches past nodef's rows), and a one-leaf
    table."""
    assert stg.emit_window() == stg.EMIT_WINDOW
    tlas = _scene(_mesh(10, 3000, 8.0))
    ds, _, scal, smeta, bscal = _s3_stages(cuda, tlas)
    assert int((smeta[:, 1] > 0).sum()) > smeta.shape[0] // 8
    assert int(torch.unique(smeta[smeta[:, 1] > 0, 0]).numel()) \
        < int((smeta[:, 1] > 0).sum())       # packets with several slots
    cut = 33 if step_rows == 1 else 1       # a cap that cuts some walks
    for cap in (1, 5, 31, 32, 33, 100, stg.STEP_CAP):
        ek = _emit_pair((scal, smeta, bscal, ds.knode_f, 1e3, cap,
                         stg.PCAP), step_rows)
        if cap == cut:
            assert int(ek[:, 1].sum()) > 0 and int((ek[:, 2] == cut).sum())
        if cap == stg.STEP_CAP:     # walks that reach their table's end
            assert int(ek[:, 1].sum()) == 0
            assert int(ek[:, 2].max()) > 32 // step_rows
            assert int(ek[:, 0].max()) > 7
    for pcap in (1, 7):
        ek = _emit_pair((scal, smeta, bscal, ds.knode_f, 1e3, stg.STEP_CAP,
                         pcap), step_rows)
        assert int(ek[:, 0].max()) > pcap
    odd_scal, odd_meta = scal.clone(), smeta.clone()
    odd_meta[::3, 1] = 0                       # dead slots
    odd_scal[1::5, 9] = float("nan")           # a NaN interval scalar
    odd_scal[2::7] = float("nan")              # every scalar NaN
    ek = _emit_pair((odd_scal, odd_meta, bscal, ds.knode_f, 1e3,
                     stg.STEP_CAP, stg.PCAP), step_rows)
    assert bool((ek[::3] == 0).all())
    one = _scene(_mesh(3, 2, 1.0))
    ds1, _, scal1, smeta1, bscal1 = _s3_stages(cuda, one)
    assert ds1.knode_f.shape[0] == 8
    ek = _emit_pair((scal1, smeta1, bscal1, ds1.knode_f, 1e3, stg.STEP_CAP,
                     stg.PCAP), step_rows)
    assert int(ek[:, 2].max()) == 1


def _clamp_stages(dev):
    """The native route's concatenated tables of three BLASes of 140, 90
    and 61 triangles (six instances; the last BLAS's octant tables are
    one row each, last in nodef_cat) and a wave whose packet p looks
    along direction octant p at an instance of that BLAS, through the
    route's prep: slots whose step window starts clamped at the end of
    nodef (tests/test_torch_step_windows.py's case)."""
    rng = np.random.default_rng(17)
    blases = []
    for tris_per in (140, 90, 61):
        c = rng.uniform(-2, 2, size=(tris_per, 3)).astype(np.float32)
        v = (c[:, None, :] + rng.normal(scale=0.35, size=(tris_per, 3, 3))
             .astype(np.float32)).reshape(-1, 3)
        blases.append(accel.BuildBottomAccelStruct(types.Mesh(
            v, np.arange(len(v), dtype=np.uint32).reshape(-1, 3))))
    insts, tfs = [], []
    for i in range(6):
        tf = np.eye(4, dtype=np.float32)
        tf[:3, 3] = rng.uniform(-8, 8, 3)
        tfs.append(tf)
        insts.append(types.Instance(tf, 0, i, blases[i % 3]))
    ds = accel.BuildTopAccelStruct(insts).device_scene(dev)
    o, d = [], []
    for p in range(8):
        sgn = np.array([-1.0 if p >> k & 1 else 1.0 for k in range(3)])
        dp = sgn * (1.0 + rng.uniform(0.0, 0.3, (stg.PKT, 3)))
        dp /= np.linalg.norm(dp, axis=-1, keepdims=True)
        aim = tfs[2 + 3 * (p % 2)][:3, 3] + rng.uniform(-1.5, 1.5,
                                                        (stg.PKT, 3))
        o.append(aim - 25.0 * dp)
        d.append(dp)
    rows = s3.rows_from_aos(
        torch.from_numpy(np.concatenate(o).astype(np.float32)).to(dev),
        torch.from_numpy(np.concatenate(d).astype(np.float32)).to(dev))
    mt = s3m.multi_tables(ds)
    _, scal, smeta, bscal, *_ = s3m._prep_tlas(
        mt, ds.inst_inv[:6], rows, 1e-3, 1e3, None, 48, stable=True)
    return mt.nodef_cat, scal, smeta, bscal


def test_emit_step_windows_match_plain(cuda):
    """Kernel B against its plain version at step_rows 8 (the reference's
    compiled count) and 1 (its node count), at the step cap and at caps
    that cut walks (9, 7, 1), on a mixed-octant wave and on
    concatenated tables where the window start clamps at the end of
    nodef: emeta (count, capped, step windows) and the words identical;
    8-row windows cut fewer walks than nodes at the same cap."""
    tlas = _scene(_mesh(10, 3000, 8.0))
    ds, _, scal, smeta, bscal = _s3_stages(cuda, tlas)
    nodef_c, scal_c, smeta_c, bscal_c = _clamp_stages(cuda)
    live = smeta_c[:, 1] > 0
    assert bool((smeta_c[live, 2] > nodef_c.shape[0] - 8).any())
    for nodef, sc, sm, bs in ((ds.knode_f, scal, smeta, bscal),
                              (nodef_c, scal_c, smeta_c, bscal_c)):
        for cap in (stg.STEP_CAP, 9, 7, 1):
            em = {r: _emit_pair((sc, sm, bs, nodef, 1e3, cap, stg.PCAP), r)
                  for r in (8, 1)}
            assert int(em[8][:, 1].sum()) <= int(em[1][:, 1].sum())
            assert bool((em[8][:, 2] <= em[1][:, 2]).all())
    # every live slot of the wave walks its octant's 65 rows: 9 windows
    cut = {r: _emit_pair((scal, smeta, bscal, ds.knode_f, 1e3, 9, stg.PCAP),
                         r) for r in (8, 1)}
    assert int(cut[8][:, 1].sum()) == 0 < int(cut[1][:, 1].sum())


@pytest.mark.parametrize("grid", [1, 7, 0])
def test_s3_refine_edge_cases(cuda, grid):
    """Kernel C against its plain version on hand-made lists over 8
    packets: list lengths 0, 1, 31, 32, 33, PCAP and a count past PCAP;
    a fully parked packet (origin 1e30: every word dropped); a packet
    whose rays start inside one leaf's box (every word of that leaf
    kept); NaN directions; several slots sharing a packet.  With one
    test block taking every chunk, 7 blocks whose shares start and end
    inside lists, and the kernel's own grid (0)."""
    ds = _scene(_mesh(10, 3000, 8.0)).device_scene(cuda)
    nl = ds.kleaf.shape[0]
    aabb8 = s3.leaf_aabb8(ds.knode_f, nl)
    npk = 8
    rng = np.random.default_rng(5)
    o, d = _rays(6, npk * stg.PKT, 10.0)
    pk0 = slice(0, stg.PKT)
    o[pk0] = 1e30                                     # parked
    inside = slice(stg.PKT, 2 * stg.PKT)
    o[inside] = (aabb8[3, :3] + aabb8[3, 3:6]).cpu().numpy() / 2
    d[2 * stg.PKT:2 * stg.PKT + 100] = np.nan         # NaN directions
    feats_t = torch.zeros(16, npk * stg.PKT)
    feats_t[0:3] = torch.from_numpy(d.T.copy())
    feats_t[6:9] = torch.from_numpy(o.T.copy())
    feats_t = feats_t.to(cuda)
    lens = [0, 1, 31, 32, 33, stg.PCAP, 1500, 40, 40, 200, 64, 65]
    pkts = [3, 4, 5, 6, 7, 2, 3, 0, 1, 2, 4, 2]
    nslot = len(lens)
    words = np.zeros((nslot, stg.PCAP), np.int32)
    for s, (n, p) in enumerate(zip(lens, pkts)):
        m = min(n, stg.PCAP)
        leaves = (np.full(m, 3) if p == 1 else rng.integers(0, nl, m))
        keep = (np.full(m, 255) if p < 2
                else rng.integers(1, 256, m))
        words[s, :m] = ((leaves + 1) << stg.W_LEAF_SHIFT) \
            | (keep << stg.W_KEEP_SHIFT) | rng.integers(0, 512, m)
    emeta = np.zeros((nslot, 8), np.int32)
    emeta[:, 0] = lens
    emeta[:, 1:] = rng.integers(0, 5, (nslot, 7))
    args = (torch.from_numpy(words).to(cuda), torch.from_numpy(emeta).to(cuda),
            torch.tensor(pkts, dtype=torch.int32, device=cuda), feats_t, aabb8,
            1e3, stg.PCAP)
    rk, rek = stg.refine_cuda(*args, grid=grid)
    rp, rep = stg._refine_plain(*args)
    assert torch.equal(rek, rep)
    valid = torch.arange(stg.PCAP, device=cuda)[None, :] < rek[:, :1]
    assert torch.equal(rk[valid], rp[valid])
    kept = rek[:, 0].tolist()
    assert rek[:, 4].tolist() == [min(n, stg.PCAP) for n in lens]
    assert kept[7] == 0 and kept[8] == 40          # all dropped, all kept
    assert torch.equal(rk[8, :40], args[0][8, :40])
    assert 0 < kept[5] < stg.PCAP and kept[0] == 0


def test_s3_isect_matches_plain(cuda):
    tlas = _scene(_mesh(10, 3000, 8.0))
    ds, feats_t, scal, smeta, bscal = _s3_stages(cuda, tlas)
    words, emeta = stg._emit_plain(scal, smeta, bscal, ds.knode_f, 1e3,
                                   stg.STEP_CAP, stg.PCAP)
    slot_pkt = smeta[:, 0].contiguous()
    words, emeta = stg._refine_plain(
        words, emeta, slot_pkt, feats_t,
        s3.leaf_aabb8(ds.knode_f, ds.kleaf.shape[0]), 1e3, stg.PCAP)
    feats = feats_t.t().contiguous()
    args = (words, emeta, slot_pkt, feats, ds.kleaf, 1e-3, 1e3, stg.PCAP,
            ds.stable_frames)
    ok = stg.isect_cuda(*args)
    op = stg._isect_plain(*args)
    ref = pk.HitRecord(t=op[..., 0].reshape(-1), prim=op[..., 1].reshape(-1),
                       slot=None, b1=None, b2=None)
    got = pk.HitRecord(t=ok[..., 0].reshape(-1), prim=ok[..., 1].reshape(-1),
                       slot=None, b1=None, b2=None)
    assert _agree(ref, got, False).mean() > 0.02


@pytest.mark.parametrize("masked", [False, True])
def test_s3_wave_matches_packet_kernel(cuda, masked):
    """trace_rows_stream3 on the card (all four kernels) against the CUDA
    packet kernel: two exact tracers on the same rays."""
    tlas = _scene(_mesh(11, 4000, 8.0))
    ds = tlas.device_scene(cuda)
    o, d = _rays(3, 20000, 10.0)
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    live = (torch.from_numpy(np.random.default_rng(4).uniform(size=20000)
                             < 0.5).to(cuda) if masked else None)
    stg.reset_launches()
    got = s3.trace_rows_stream3(ds, s3.rows_from_aos_fast(o_t, d_t), 1e-3,
                                1e3, live=live)
    ref = pk.trace_rays_packet(ds, o_t, d_t, 1e-3, 1e3, live=live)
    torch.cuda.synchronize()
    closest = ("transpose", "emit", "refine", "isect", "oscal")
    assert all(stg.KERNELS[k].launches >= 1 for k in closest)
    assert stg.isect_occl_cuda.launches == 0
    hit = _agree(ref, got, False)
    assert hit.mean() > 0.05
    if masked:
        assert not hit[~live.cpu().numpy()].any()


@pytest.mark.parametrize("cap,bits", [(64, 7), (256, 9), (512, 5)])
def test_leaf_cap_and_tq_width_match_plain(cuda, cap, bits):
    """The kernels at a leaf cap and tq width other than (128, 9), each
    built for it (B and C for the width, D and E for both; the packet
    kernel, one library for every cap, tests a leaf in passes of 32
    lanes), against its plain version: B's and C's word lists (unsorted and tq-sorted)
    identical, D to the traversal bars, E on >= 0.999 of rays, the packet
    kernel's closest and any-hit traces; then the whole stream3 wave at
    the width against the packet kernel."""
    tlas = _scene(_mesh(10, 3000, 8.0))
    ds = tlas.device_scene(cuda, leaf_cap=cap)
    assert ds.leaf_cap == cap and ds.kleaf.shape[2] == 4 * cap
    o, d = _rays(1, 5000, 10.0)
    for any_hit in (False, True):
        out = {}
        for dev in ("cpu", cuda):
            out[str(dev)] = pk.trace_rays_packet(
                tlas.device_scene(dev, leaf_cap=cap),
                torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                1e-3, 1e3, any_hit=any_hit)
        assert _agree(out["cpu"], out["cuda"], any_hit).mean() > 0.05

    ds, feats_t, scal, smeta, bscal = _s3_stages(cuda, tlas, leaf_cap=cap)
    args = (scal, smeta, bscal, ds.knode_f, 1e3, stg.STEP_CAP, stg.PCAP)
    wk, ek = stg.emit_cuda(*args, tq_bits=bits)
    wp, ep = stg._emit_plain(*args, tq_bits=bits)
    assert torch.equal(ek, ep)
    valid = (torch.arange(stg.PCAP, device=cuda)[None, :]
             < torch.clamp(ek[:, :1], max=stg.PCAP))
    assert torch.equal(wk[valid], wp[valid]) and int(valid.sum()) > 100
    slot_pkt = smeta[:, 0].contiguous()
    aabb8 = s3.leaf_aabb8(ds.knode_f, ds.kleaf.shape[0])
    for sort in (False, True):
        rk, rek = stg.refine_cuda(wk, ek, slot_pkt, feats_t, aabb8, 1e3,
                                  stg.PCAP, sort=sort, tq_bits=bits)
        rp, rep = stg._refine_plain(wp, ep, slot_pkt, feats_t, aabb8, 1e3,
                                    stg.PCAP, sort=sort, tq_bits=bits)
        assert torch.equal(rek, rep)
        kept = torch.arange(stg.PCAP, device=cuda)[None, :] < rek[:, :1]
        assert torch.equal(rk[kept], rp[kept])
    feats = feats_t.t().contiguous()
    iargs = (rk, rek, slot_pkt, feats, ds.kleaf, 1e-3, 1e3, stg.PCAP,
             ds.stable_frames)
    ok = stg.isect_cuda(*iargs, tq_bits=bits)
    op = stg._isect_plain(*iargs, tq_bits=bits)
    ref = pk.HitRecord(t=op[..., 0].reshape(-1), prim=op[..., 1].reshape(-1),
                       slot=None, b1=None, b2=None)
    got = pk.HitRecord(t=ok[..., 0].reshape(-1), prim=ok[..., 1].reshape(-1),
                       slot=None, b1=None, b2=None)
    assert _agree(ref, got, False).mean() > 0.02
    eargs = (wk, ek) + iargs[2:]
    occ_k = stg.isect_occl_cuda(*eargs, tq_bits=bits)
    occ_p = stg._isect_occl_plain(*eargs, tq_bits=bits)
    assert float((occ_k == occ_p).all(dim=2).float().mean()) >= 0.999
    assert 0.02 < float((occ_k[..., 0] == 0).float().mean()) < 0.98

    o, d = _rays(3, 20000, 10.0)
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    wave = s3.trace_rows_stream3(ds, s3.rows_from_aos_fast(o_t, d_t), 1e-3,
                                 1e3, tq_bits=bits)
    torch.cuda.synchronize()
    assert _agree(pk.trace_rays_packet(ds, o_t, d_t, 1e-3, 1e3), wave,
                  False).mean() > 0.05


def _values_equal(a, b):
    """Equal shapes, dtypes and values, NaN matching NaN (+0 == -0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def _oscal_case(masked):
    """8 packets of adversarial rays for kernel F, as six [8 * PKT] f32
    rows and the live mask (or None).  Packet 0: +0 x directions and a
    warp whose 32 rays span all 8 octants; 1: one octant, -0 y
    directions; 2: +-0 x origins; 3: |d| under 1e-30 (some subnormal);
    4: NaN and inf in o and in d; 5: all rays live in one octant, with
    d.x and o.x = +inf and o.y = -inf (no fill may join); 6: all dead;
    7: one live ray."""
    pkt = stg.PKT
    n = 8 * pkt
    o, d = _rays(5, n, 6.0)
    d[:pkt, 0] = 0.0
    i = np.arange(32)[:, None]
    d[64:96] = (0.1 + np.abs(d[64:96])) * np.where(i & [1, 2, 4], -1, 1)
    d[pkt:2 * pkt] = np.abs(d[pkt:2 * pkt])
    d[pkt:2 * pkt:3, 1] = -0.0
    o[2 * pkt:3 * pkt, 0] = np.where(np.arange(pkt) % 2, 0.0, -0.0)
    d[3 * pkt:3 * pkt + 300, 0] = 1e-35
    d[3 * pkt + 300:3 * pkt + 600, 1] = -1e-40
    d[3 * pkt + 600:3 * pkt + 632] = [5e-31, -2e-38, 1e-45]
    o[4 * pkt + 3, 0] = np.nan
    d[4 * pkt + 40, 1] = np.inf
    d[4 * pkt + 70, 2] = np.nan
    o[4 * pkt + 100, 1] = -np.inf
    d[4 * pkt + 130, 0] = -np.inf
    d[5 * pkt:6 * pkt] = np.abs(d[5 * pkt:6 * pkt])
    d[5 * pkt:6 * pkt, 0] = np.inf
    o[5 * pkt:6 * pkt, :2] = [np.inf, -np.inf]
    live = None
    if masked:
        live = np.random.default_rng(6).uniform(size=n) < 0.6
        live[64:96] = True
        live[[4 * pkt + 3, 4 * pkt + 40, 4 * pkt + 70, 4 * pkt + 100]] = True
        live[5 * pkt:6 * pkt] = True
        live[6 * pkt:] = False
        live[7 * pkt + 5] = True
        o[6 * pkt + 9, 2] = np.nan          # dead: must not reach a row
        d[7 * pkt + 9, 0] = np.nan
    rows = [np.ascontiguousarray(v, np.float32) for v in (*o.T, *d.T)]
    return rows, live


@pytest.mark.parametrize("masked", [False, True])
def test_s3_oscal_matches_plain(cuda, masked):
    """Kernel F's four outputs (octant scalars, presence, whole-packet
    scalars, 32-ray sub-frustum rows) equal its plain version's by value
    on adversarial packets."""
    rows_np, live_np = _oscal_case(masked)
    rows = tuple(torch.from_numpy(v).to(cuda) for v in rows_np)
    live = None if live_np is None else torch.from_numpy(live_np).to(cuda)
    before = stg.oscal_cuda.launches
    got = stg.oscal_cuda(rows, live, 8)
    ref = stg._oscal_plain(rows, live, 8)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == 4
    for name, a, b in zip(("cand", "present", "full", "bscal"), got, ref):
        assert _values_equal(a, b), name
    assert stg.oscal_cuda.launches == before + 1
    cand, present, full, bscal = (x.cpu() for x in ref)
    # the cases are not vacuous
    assert bool(present[0].all())                    # all 8 octants
    assert int(present[1].sum()) == 1
    assert bool(torch.isnan(full[4]).any())
    # packet 5: every ray a member, so no fill: olo.x = +inf, ohi.y =
    # -inf, ilo.x = 1/inf
    assert float(full[5, 3]) == np.inf and float(full[5, 7]) == -np.inf
    assert float(cand[5, 0, 3]) == np.inf and float(full[5, 9]) == 0.0
    assert bool((bscal[5 * 32:6 * 32, 3] == np.inf).all())
    if masked:
        assert not bool(present[6].any()) and int(present[7].sum()) == 1
        assert bool((full[6, 3:6] == 1e30).all())
        assert not bool(torch.isnan(bscal[6 * 32:]).any())


def test_s3_isect_occl_matches_plain(cuda):
    """Kernel E against its plain version on the emitted (unrefined) word
    lists of a mixed wave and on the same lists refined by kernel C, in
    both frame modes; the two list forms give the same occluded-or-not."""
    for stable in (True, False):
        ds = _scene(_mesh(10, 3000, 8.0)).device_scene(cuda,
                                                       stable_frames=stable)
        o, d = _rays(7, 8192, 10.0)
        rows = s3.rows_from_aos(torch.from_numpy(o).to(cuda),
                                torch.from_numpy(d).to(cuda))
        _, feats_t, scal, smeta, bscal, _ = s3._stage_prep(
            rows, ds.knode_f, ds.inst_inv[0], stable=stable)
        words, emeta = stg.emit_cuda(scal, smeta, bscal, ds.knode_f, 1e3,
                                     stg.STEP_CAP, stg.PCAP)
        slot_pkt = smeta[:, 0].contiguous()
        refined = stg.refine_cuda(words, emeta, slot_pkt, feats_t,
                                  s3.leaf_aabb8(ds.knode_f,
                                                ds.kleaf.shape[0]),
                                  1e3, stg.PCAP)
        occ = {}
        for form, (w, e) in (("emitted", (words, emeta)),
                             ("refined", refined)):
            args = (w, e, slot_pkt, feats_t.t().contiguous(), ds.kleaf,
                    1e-3, 1e3, stg.PCAP, stable)
            ok = stg.isect_occl_cuda(*args)
            op = stg._isect_occl_plain(*args)
            same = (ok == op).all(dim=2).float().mean()
            assert float(same) >= 0.999, form
            occ[form] = ok[..., 0] == 0
            assert 0.02 < float(occ[form].float().mean()) < 0.98
        assert _pairs(*refined) <= _pairs(words, emeta)
        assert float((occ["emitted"] == occ["refined"]).float().mean()) \
            >= 0.999


def _pairs(words, emeta):
    """The (leaf, block) pairs of word lists: their keep bits set."""
    cnt = torch.clamp(emeta[:, 0], max=stg.PCAP)
    valid = torch.arange(words.shape[1], device=words.device) < cnt[:, None]
    km = (words[valid] >> stg.W_KEEP_SHIFT) & 255
    return sum(int(((km >> b) & 1).sum()) for b in range(8))


def _wall_scene(dev, stable):
    """3000 small triangles under a wall at z = 0, one triangle (prim 0)
    that covers [-60, 30]^2: a ray from above the middle pointing down is
    occluded by the wall's leaf."""
    rng = np.random.default_rng(12)
    wall = np.array([[-60, -60, 0], [120, -60, 0], [-60, 120, 0]],
                    np.float32)
    c = rng.uniform(-8, 8, (3000, 3)).astype(np.float32)
    c[:, 2] = rng.uniform(-6, -1, 3000)
    v = (c[:, None, :] + rng.normal(scale=0.5, size=(3000, 3, 3))
         .astype(np.float32)).reshape(-1, 3)
    verts = np.concatenate([wall, v]).astype(np.float32)
    mesh = types.Mesh(verts, np.arange(len(verts), dtype=np.uint32)
                      .reshape(-1, 3))
    return _scene(mesh).device_scene(dev, stable_frames=stable)


@pytest.mark.parametrize("stable", [True, False])
def test_s3_isect_occl_edge_cases(cuda, stable):
    """Kernel E against its plain version on hand-made word lists over 8
    packets of rays from above a wall, pointing down: packet 0 entirely
    parked (origin 1e30), packet 1 half parked.  Each packet has two
    slots: one whose list starts with the wall's leaf, all keep bits set
    (every live ray occluded after one word), then 20 other leaves; one
    of 30 other leaves, each word's keep mask a single bit.  Every case
    on the hand-made lists and on the same lists refined by kernel C:
    dead lanes equal the plain version's miss, live lanes agree, and the
    two forms give the same occluded-or-not."""
    ds = _wall_scene(cuda, stable)
    npk = 8
    n = npk * stg.PKT
    rng = np.random.default_rng(8)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(2, 8, n)
    d = np.concatenate([0.3 * rng.normal(size=(n, 2)), -np.ones((n, 1))],
                       axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    live = np.ones(n, bool)
    live[:stg.PKT] = False
    live[stg.PKT:2 * stg.PKT] = rng.uniform(size=stg.PKT) < 0.5
    live_t = torch.from_numpy(live).to(cuda)
    rows = s3.park_dead(tuple(torch.from_numpy(np.ascontiguousarray(v))
                              .to(cuda) for v in (*o.T, *d.T)), live_t)
    _, feats_t, *_ = s3._stage_prep(rows, ds.knode_f, ds.inst_inv[0],
                                    live=live_t, stable=stable)
    feats = feats_t.t().contiguous()

    nl = ds.kleaf.shape[0]
    wall = int(torch.nonzero((ds.kleaf[:, 10, :stg.T] == 0).any(dim=1))[0])
    others = np.array([leaf for leaf in range(nl) if leaf != wall])
    nslot = 2 * npk
    words = np.zeros((nslot, stg.PCAP), np.int32)
    cnt = np.zeros(nslot, np.int32)
    for s in range(nslot):
        if s < npk:          # the wall first, every block kept
            leaves = np.concatenate([[wall], rng.choice(others, 20)])
            keep = np.full(len(leaves), 255)
        else:                # single-bit keep masks, no wall
            leaves = rng.choice(others, 30)
            keep = 1 << rng.integers(0, 8, len(leaves))
        words[s, :len(leaves)] = ((leaves + 1) << stg.W_LEAF_SHIFT) \
            | (keep << stg.W_KEEP_SHIFT)
        cnt[s] = len(leaves)
    emeta = np.zeros((nslot, 8), np.int32)
    emeta[:, 0] = cnt
    words_t = torch.from_numpy(words).to(cuda)
    emeta_t = torch.from_numpy(emeta).to(cuda)
    slot_pkt = torch.arange(nslot, dtype=torch.int32, device=cuda) % npk
    refined = stg.refine_cuda(words_t, emeta_t, slot_pkt, feats_t,
                              s3.leaf_aabb8(ds.knode_f, nl), 1e3, stg.PCAP)
    assert _pairs(*refined) < _pairs(words_t, emeta_t)
    lane_live = live_t.view(npk, stg.PKT)[slot_pkt.long()]
    miss = torch.tensor([FLT_MAX, -1.0, 0.0, 0.0], device=cuda)
    occ = {}
    for form, (w, e) in (("hand-made", (words_t, emeta_t)),
                         ("refined", refined)):
        args = (w, e, slot_pkt, feats, ds.kleaf, 1e-3, 1e3, stg.PCAP, stable)
        ok = stg.isect_occl_cuda(*args)
        op = stg._isect_occl_plain(*args)
        assert torch.equal(ok[~lane_live], op[~lane_live]), form
        assert bool((ok[~lane_live] == miss).all()), form
        agree = (ok == op).all(dim=2)[lane_live].float().mean()
        assert float(agree) >= 0.999, form
        occ[form] = ok[..., 0] == 0
        # after the wall's word every live ray is occluded
        assert bool(occ[form][:npk][lane_live[:npk]].all()), form
        single = occ[form][npk:][lane_live[npk:]]
        assert 0 < int(single.sum()) < single.numel(), form
    assert (occ["hand-made"] == occ["refined"])[lane_live].float().mean() \
        >= 0.999


def test_s3_occl_wave_matches_packet_kernel(cuda):
    """trace_rays_stream3(any_hit=True) on the card (kernels F, B, C, A
    and E: occlusion waves refine) against the packet kernel's any-hit,
    two exact tracers: occluded-or-not agreement."""
    ds = _scene(_mesh(11, 4000, 8.0)).device_scene(cuda)
    o, d = _rays(3, 20000, 10.0)
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    stg.reset_launches()
    got = s3.trace_rays_stream3(ds, o_t, d_t, 1e-3, 1e3, any_hit=True)
    ref = pk.trace_rays_packet(ds, o_t, d_t, 1e-3, 1e3, any_hit=True)
    torch.cuda.synchronize()
    assert _agree(ref, got, True).mean() > 0.05
    assert stg.isect_occl_cuda.launches >= 1
    assert stg.refine_cuda.launches == 1
    assert stg.isect_cuda.launches == 0
    assert set(np.unique(got.t.cpu().numpy())) <= {0.0, np.float32(FLT_MAX)}


@pytest.mark.parametrize("occl", [False, True])
def test_s3_bounded_wave_matches_unbounded(cuda, occl):
    """A temporally bounded stream3 wave on the card (the cull between
    kernels C and D or E, the residual through the packet kernel), on a
    soup cut by a wall that every ray hits, so every block has a finite
    bound: a bound from the previous identical closest-hit wave
    culls pairs and gives the unbounded trace bit for bit (occlusion:
    t), with no residual; the tightest bound (half of each block's
    nearest hit) makes every closest-hit ray residual (16384 rays, all
    under the cap) and gives the same hits to the traversal bars."""
    soup = _mesh(11, 4000, 8.0)
    # one triangle through the middle of the soup, so the half of it
    # behind the wall lies past every block's bound (two triangles' shared
    # edge would cross the grid's diagonal, where a ray may slip between)
    wall = np.float32([[-100, -100, 0], [300, -100, 0], [-100, 300, 0]])
    v = np.concatenate([soup.vertices, wall])
    ds = _scene(types.Mesh(v, np.arange(len(v), dtype=np.uint32)
                           .reshape(-1, 3))).device_scene(cuda)
    n = 128 * 128
    ij = np.arange(n)
    d = np.stack([((ij % 128) / 128 - 0.5) * 0.7,
                  ((ij // 128) / 128 - 0.5) * 0.7, -np.ones(n)],
                 -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.float32([[0.0, 0.0, 30.0]]), (n, 1))
    rows = s3.rows_from_aos_fast(torch.from_numpy(o).to(cuda),
                                 torch.from_numpy(d).to(cuda))
    closest = s3.trace_rows_stream3(ds, rows, 1e-3, 1e3)
    base = s3.trace_rows_stream3(ds, rows, 1e-3, 1e3, occl=occl)
    assert bool(closest.hit.all())
    fields = ("t",) if occl else ("t", "prim", "slot", "b1", "b2")
    stg.reset_launches()
    rec, diag = s3.trace_rows_stream3(
        ds, rows, 1e-3, 1e3, occl=occl, with_diag=True,
        blk_bound=s3.block_bound_from_t(closest.t))
    torch.cuda.synchronize()
    assert (stg.isect_occl_cuda if occl else stg.isect_cuda).launches == 1
    assert diag["tb_residual"] == 0 and diag["tb_marked"] == 0
    assert int(diag["block_pairs_bounded"]) < int(diag["block_pairs"])
    for f in fields:
        assert torch.equal(getattr(rec, f), getattr(base, f)), f
    tight = torch.where(closest.hit, closest.t * 0.5, FLT_MAX)
    tight = tight.reshape(-1, 128).amin(dim=1)
    pk_before = sum(pk.packet_trace_cuda.launches.values())
    rec, diag = s3.trace_rows_stream3(ds, rows, 1e-3, 1e3, occl=occl,
                                      with_diag=True, blk_bound=tight)
    torch.cuda.synchronize()
    assert sum(pk.packet_trace_cuda.launches.values()) > pk_before
    # every closest hit lies past half its block's nearest; an occlusion
    # ray is residual unless a kept leaf still occludes it
    assert diag["tb_marked"] == 0 and diag["tb_residual"] > 0, diag
    assert occl or diag["tb_residual"] == n
    assert int(diag["block_pairs_bounded"]) < int(diag["block_pairs"])
    assert (rec.slot >= -1).all()
    _agree(base, rec, occl)


def test_apply_block_bound_on_card_equals_cpu(cuda):
    """The temporal cull on CUDA tensors gives the CPU's words, NaN, inf,
    negative and zero bounds included (a NaN bound culls nothing on
    either device)."""
    rng = np.random.default_rng(5)
    nslot, npk = 301, 37
    words = ((rng.integers(0, stg.W_LEAF_MAX - 2, (nslot, 512)) + 1)
             << stg.W_LEAF_SHIFT | rng.integers(0, 256, (nslot, 512))
             << stg.W_KEEP_SHIFT | rng.integers(0, 512, (nslot, 512)))
    words = words.astype(np.int32)
    words[rng.uniform(size=words.shape) < 0.2] &= ~stg.W_TQ_MASK
    words[rng.uniform(size=words.shape) < 0.1] = 0
    slot_pkt = rng.integers(0, npk, nslot).astype(np.int32)
    b = rng.uniform(0, 200, npk * 8).astype(np.float32)
    b[:8] = [np.inf, -np.inf, np.nan, -np.nan, 0.0, -3.0, FLT_MAX, 1e-42]
    args = [torch.from_numpy(x) for x in (words, slot_pkt, b)]
    ref = s3._apply_block_bound(*args)
    got = s3._apply_block_bound(*(x.to(cuda) for x in args))
    assert not torch.equal(ref, args[0])
    assert torch.equal(got.cpu(), ref)


def _multi_scene(dev, n_inst=12, tris_per=200, seed=4):
    rng = np.random.default_rng(seed)
    insts = []
    for i in range(n_inst):
        c = rng.uniform(-2, 2, (tris_per, 3)).astype(np.float32)
        v = (c[:, None, :] + rng.normal(scale=0.3, size=(tris_per, 3, 3))
             .astype(np.float32)).reshape(-1, 3)
        tf = np.eye(4, dtype=np.float32)
        tf[:3, 3] = rng.uniform(-8, 8, 3)
        insts.append(types.Instance(tf, 0, i, accel.BuildBottomAccelStruct(
            types.Mesh(v, np.arange(len(v), dtype=np.uint32)
                       .reshape(-1, 3)))))
    return accel.BuildTopAccelStruct(insts).device_scene(dev)


@pytest.mark.parametrize("occl", [False, True])
def test_trace_rows_multi_on_card_matches_cpu(cuda, occl):
    """The instance scan on the card (kernels F, B, A and C + D or E)
    against its CPU route (the plain versions) and against the packet
    kernel's per-instance sweeps; the same poisoned rays."""
    o, d = _rays(6, 20000, 12.0)
    out = {}
    for dev in ("cpu", cuda):
        ds = _multi_scene(dev)
        stg.reset_launches()
        rows = s3.rows_from_aos(torch.from_numpy(o).to(dev),
                                torch.from_numpy(d).to(dev))
        out[str(dev)] = s3m.trace_rows_multi(ds, s3m.multi_tables(ds), rows,
                                             1e-3, 1e3, occl=occl)
    torch.cuda.synchronize()
    assert stg.oscal_cuda.launches >= 1
    assert (stg.isect_occl_cuda.launches >= 1) == occl
    got, ref = out["cuda"], out["cpu"]
    assert torch.equal(got.slot.cpu() == -2, ref.slot == -2)
    hit = _agree(ref, got, occl)
    assert hit.mean() > 0.01
    sweeps = pk.trace_rays_packet_multi(ds, torch.from_numpy(o).to(cuda),
                                        torch.from_numpy(d).to(cuda), 1e-3,
                                        1e3, any_hit=occl)
    ok = (got.slot != -2).cpu().numpy()
    assert ((sweeps.t.cpu().numpy() < FLT_MAX)
            == (got.t.cpu().numpy() < FLT_MAX))[ok].mean() >= 0.999


def _clustered_mesh(seed=7, clusters=64, per=60):
    """A clustered mesh (tests/test_stream3.py's mini city): spatially
    separate clusters, where the SAH collapse cuts other leaves than the
    greedy one."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20, 20, size=(clusters, 3)).astype(np.float32)
    local = rng.uniform(-1.5, 1.5, size=(clusters, per, 3)).astype(np.float32)
    offs = rng.normal(scale=0.08, size=(clusters, per, 3, 3)).astype(
        np.float32)
    v = ((centers[:, None, :] + local)[:, :, None, :] + offs).reshape(-1, 3)
    return types.Mesh(v, np.arange(len(v), dtype=np.uint32).reshape(-1, 3))


@pytest.mark.parametrize("cap", [128, 64])
def test_sah_tables_match_plain(cuda, cap):
    """Tables built with collapse="sah" (more, tighter leaves than the
    greedy cut on a clustered mesh): the packet kernel's closest and
    any-hit traces against its plain version on the CPU build of the same
    tables, and B, C, D and E against their plain versions on a wave's
    stages (B and C word for word, D to the traversal bars, E on >= 0.999
    of rays); the stream3 wave against the packet kernel."""
    mesh = _clustered_mesh()
    tlas = _scene(mesh)
    ds = tlas.device_scene(cuda, leaf_cap=cap, collapse="sah")
    greedy = tlas.device_scene(cuda, leaf_cap=cap)
    assert (ds.collapse, ds.rho) == ("sah", 0.15)
    assert ds.kleaf.shape[0] > greedy.kleaf.shape[0]
    rng = np.random.default_rng(2)
    verts = mesh.vertices
    aim = verts[rng.integers(0, len(verts), 8192)] + rng.normal(
        scale=0.05, size=(8192, 3))
    d = rng.normal(size=(8192, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (aim - 30.0 * d).astype(np.float32)
    d = d.astype(np.float32)
    for any_hit in (False, True):
        ref, got = (pk.trace_rays_packet(
            tlas.device_scene(dev, leaf_cap=cap, collapse="sah"),
            torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev), 1e-3,
            1e3, any_hit=any_hit) for dev in ("cpu", cuda))
        assert _agree(ref, got, any_hit).mean() > 0.05
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    rows = s3.rows_from_aos(o_t, d_t)
    _, feats_t, scal, smeta, bscal, _ = s3._stage_prep(
        rows, ds.knode_f, ds.inst_inv[0], stable=ds.stable_frames)
    bits = 9 if s3.supports(ds) else 7
    args = (scal, smeta, bscal, ds.knode_f, 1e3, stg.STEP_CAP, stg.PCAP)
    wk, ek = stg.emit_cuda(*args, tq_bits=bits)
    wp, ep = stg._emit_plain(*args, tq_bits=bits)
    assert torch.equal(ek, ep)
    valid = (torch.arange(stg.PCAP, device=cuda)[None, :]
             < torch.clamp(ek[:, :1], max=stg.PCAP))
    assert torch.equal(wk[valid], wp[valid]) and int(valid.sum()) > 100
    slot_pkt = smeta[:, 0].contiguous()
    aabb8 = s3.leaf_aabb8(ds.knode_f, ds.kleaf.shape[0])
    rk, rek = stg.refine_cuda(wk, ek, slot_pkt, feats_t, aabb8, 1e3,
                              stg.PCAP, tq_bits=bits)
    rp, rep = stg._refine_plain(wp, ep, slot_pkt, feats_t, aabb8, 1e3,
                                stg.PCAP, tq_bits=bits)
    assert torch.equal(rek, rep)
    kept = torch.arange(stg.PCAP, device=cuda)[None, :] < rek[:, :1]
    assert torch.equal(rk[kept], rp[kept])
    iargs = (rk, rek, slot_pkt, feats_t.t().contiguous(), ds.kleaf, 1e-3,
             1e3, stg.PCAP, ds.stable_frames)
    ok = stg.isect_cuda(*iargs, tq_bits=bits)
    op = stg._isect_plain(*iargs, tq_bits=bits)
    ref = pk.HitRecord(t=op[..., 0].reshape(-1), prim=op[..., 1].reshape(-1),
                       slot=None, b1=None, b2=None)
    got = pk.HitRecord(t=ok[..., 0].reshape(-1), prim=ok[..., 1].reshape(-1),
                       slot=None, b1=None, b2=None)
    assert _agree(ref, got, False).mean() > 0.02
    eargs = (wk, ek) + iargs[2:]
    occ_k = stg.isect_occl_cuda(*eargs, tq_bits=bits)
    occ_p = stg._isect_occl_plain(*eargs, tq_bits=bits)
    assert float((occ_k == occ_p).all(dim=2).float().mean()) >= 0.999
    wave = s3.trace_rows_stream3(ds, s3.rows_from_aos_fast(o_t, d_t), 1e-3,
                                 1e3, tq_bits=bits)
    torch.cuda.synchronize()
    assert _agree(pk.trace_rays_packet(ds, o_t, d_t, 1e-3, 1e3), wave,
                  False).mean() > 0.05


def _tlas_scene(dev, n_inst=9, n_uniq=3, tris_per=400, seed=7):
    """n_inst instances of n_uniq shared BLASes under rotation, scale and
    placement (tests/test_torch_stream3_tlas.py's kind of scene)."""
    rng = np.random.default_rng(seed)
    blases = []
    for _ in range(n_uniq):
        c = rng.uniform(-2, 2, (tris_per, 3)).astype(np.float32)
        v = (c[:, None, :] + rng.normal(scale=0.35, size=(tris_per, 3, 3))
             .astype(np.float32)).reshape(-1, 3)
        blases.append(accel.BuildBottomAccelStruct(types.Mesh(
            v, np.arange(len(v), dtype=np.uint32).reshape(-1, 3))))
    insts = []
    for i in range(n_inst):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        tf = np.eye(4, dtype=np.float32)
        tf[:3, :3] = q * rng.uniform(0.5, 2.0)
        tf[:3, 3] = rng.uniform(-10, 10, 3)
        insts.append(types.Instance(tf, 0, i, blases[i % n_uniq]))
    return accel.BuildTopAccelStruct(insts).device_scene(dev)


@pytest.mark.parametrize("occl", [False, True])
def test_trace_rows_tlas_on_card_matches_cpu(cuda, occl):
    """The TLAS-native route on the card (one launch each of F, B, C, A and
    D or E over the wave's slots, the packet kernel in its residual)
    against its CPU route (the plain versions) on the same small scene;
    a pool of 64 slots forces the residual on both."""
    o, d = _rays(3, 12000, 14.0)
    out, diags = {}, {}
    for dev in ("cpu", cuda):
        ds = _tlas_scene(dev)
        stg.reset_launches()
        pk_before = sum(pk.packet_trace_cuda.launches.values())
        rows = s3.rows_from_aos(torch.from_numpy(o).to(dev),
                                torch.from_numpy(d).to(dev))
        mt = s3m.multi_tables(ds)
        assert s3m.supports_native(mt)
        out[str(dev)], diags[str(dev)] = s3m.trace_rows_tlas(
            ds, mt, rows, 1e-3, 1e3, occl=occl, scap=64, with_diag=True)
    torch.cuda.synchronize()
    for k in ("oscal", "emit", "refine", "transpose"):
        assert getattr(stg, f"{k}_cuda").launches == 1, k
    assert stg.isect_occl_cuda.launches == int(occl)
    assert stg.isect_cuda.launches == int(not occl)
    assert sum(pk.packet_trace_cuda.launches.values()) > pk_before
    got, ref = out["cuda"], out["cpu"]
    assert diags["cuda"] == diags["cpu"] and diags["cpu"]["flagged"] > 0
    assert (got.slot != -2).all()
    hit = _agree(ref, got, occl)
    assert hit.mean() > 0.01
    if not occl:
        both = (ref.t < FLT_MAX).numpy() & hit
        assert (got.slot.cpu().numpy() == ref.slot.numpy())[both].mean() \
            >= 0.999


# ------------------------------------------- packet kernel: edge cases

def _pk_pair(cuda, ds, o, d, live=None, any_hit=False, stable=True):
    """(t, tri) of the packet kernel and of its plain version on the same
    object-space rays (CUDA tensors)."""
    args = (o, d, live, ds.knode_f, ds.kleaf, 1e-3, 1e3)
    kw = dict(any_hit=any_hit, stable=stable)
    got = pk.packet_trace_cuda(*args, **kw)
    ref = pk._packet_trace_reference(*args, **kw)
    torch.cuda.synchronize()
    return got, ref


def _hold_pk(got, ref, kprim, any_hit):
    rec = [pk.HitRecord(t=t, prim=kprim[tri.clamp(min=0).long()], slot=None,
                        b1=None, b2=None) for t, tri in (ref, got)]
    return _agree(rec[0], rec[1], any_hit)


@pytest.mark.parametrize("n", [1, 31, 1025, 5000])
def test_kernel_ragged_mixed_octants(cuda, n):
    """Ragged wave sizes whose packets mix all eight direction octants
    (each packet walks one octant's table, exact for every ray), closest
    and any-hit, against the plain version."""
    ds = _scene(_mesh(10, 3000, 8.0)).device_scene(cuda)
    o, d = _rays(1, n, 10.0)
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    for any_hit in (False, True):
        got, ref = _pk_pair(cuda, ds, o_t, d_t, any_hit=any_hit)
        if n == 1:
            assert torch.equal(got[0] < FLT_MAX, ref[0] < FLT_MAX)
            continue
        hit = _hold_pk(got, ref, ds.kprim, any_hit)
        assert hit.mean() > 0.05


def test_kernel_dead_lanes_nan(cuda):
    """Masked packets: whole packets dead, packets half dead, dead lanes
    carrying NaN and Inf origins and directions, given to the kernel as
    they are (not parked): dead rays miss, live ones match the plain
    version, which parks them."""
    ds = _scene(_mesh(10, 3000, 8.0)).device_scene(cuda)
    packet = pk.PACKET_RAYS
    n = 8 * packet + 5
    o, d = _rays(2, n, 10.0)
    rng = np.random.default_rng(3)
    live = rng.uniform(size=n) < 0.5
    live[:2 * packet] = False                      # two all-dead packets
    live[4 * packet:5 * packet] = True             # one all-live packet
    o[~live] = np.where(rng.uniform(size=((~live).sum(), 1)) < 0.5,
                        np.nan, np.inf)
    d[~live] = np.nan
    lv = torch.from_numpy(live).to(cuda)
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    for any_hit in (False, True):
        got, ref = _pk_pair(cuda, ds, o_t, d_t, live=lv, any_hit=any_hit)
        t_k = got[0].cpu().numpy()
        assert (t_k[~live] == np.float32(FLT_MAX)).all()
        assert (got[1].cpu().numpy()[~live] == -1).all()
        hit = _hold_pk(got, ref, ds.kprim, any_hit)
        assert hit[live].mean() > 0.05


N_COPIES = 200      # copies of one triangle in _dup_scene (prims 0-199)


def _dup_scene(dev, stable):
    """300 small triangles below z = -2 and N_COPIES copies of one
    triangle at z = 0, in two or more kernel leaves: every copy at t = 5
    for a ray from z = 5 straight down -- ties within a leaf and, in
    legacy frames, across leaves."""
    rng = np.random.default_rng(0)
    tri = np.array([[-3, -3, 0], [3, -3, 0], [0, 3, 0]], np.float32)
    c = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    c[:, 2] = rng.uniform(-8, -2, 300)
    v = (c[:, None, :] + rng.normal(scale=0.5, size=(300, 3, 3))
         .astype(np.float32)).reshape(-1, 3)
    verts = np.concatenate([np.tile(tri, (N_COPIES, 1)), v]).astype(np.float32)
    return _scene(types.Mesh(verts, np.arange(len(verts), dtype=np.uint32)
                             .reshape(-1, 3))).device_scene(
                                 dev, stable_frames=stable)


def _assert_copies_tie(ds, stable):
    """The copies' coefficient columns (rows 0-9 of each lane's four
    quarters) are bit-equal within each leaf, and in legacy frames across
    the leaves too (stable frames subtract each leaf's own centroid), so
    every version's per-copy t ties exactly there, whatever its summation
    order."""
    kl = ds.kleaf.cpu()
    T = kl.shape[2] // 4
    cols = []
    for leaf in range(kl.shape[0]):
        prim = kl[leaf, 10, :T]
        lanes = torch.nonzero((prim >= 0) & (prim < N_COPIES)).squeeze(1)
        if lanes.numel():
            c = torch.stack([kl[leaf, :10, e * T + lanes] for e in range(4)])
            cols.append(c.permute(2, 0, 1).reshape(lanes.numel(), -1))
    assert len(cols) >= 2 and sum(c.shape[0] for c in cols) == N_COPIES
    for c in cols:
        assert torch.equal(c, c[:1].expand_as(c))
    if not stable:
        assert all(torch.equal(c[:1], cols[0][:1]) for c in cols)


def _down_rays(n):
    rng = np.random.default_rng(1)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-0.5, 0.5, (n, 2))
    o[:, 2] = 5.0
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("stable", [True, False])
def test_kernel_exact_ties(cuda, stable):
    """Rays that hit N_COPIES copies of one triangle at t = 5 (their
    per-copy t tie exactly within a leaf, and across leaves in legacy
    frames): the kernel picks the plain version's face -- the lowest lane,
    then the earlier leaf -- on every ray (one octant, so both walk the
    same table); t to f32 rounding (the two sum the products in other
    orders)."""
    ds = _dup_scene(cuda, stable)
    _assert_copies_tie(ds, stable)
    o, d = _down_rays(4096)
    got, ref = _pk_pair(cuda, ds, torch.from_numpy(o).to(cuda),
                        torch.from_numpy(d).to(cuda), stable=stable)
    assert bool(((ref[0] - 5.0).abs() < 1e-4).all())
    assert bool((ref[1] >= 0).all())
    assert torch.equal(got[1], ref[1])
    assert torch.allclose(got[0], ref[0], rtol=1e-6, atol=0.0)


def test_kernel_any_hit_t_is_a_true_hit(cuda):
    """Any-hit t is the distance of an accepted hit on the face the
    kernel returns: recomputed from ktri_geo, inside (tmin, tmax)."""
    from radiance_tpu_torch.ops.intersect import intersect_triangle

    ds = _scene(_mesh(10, 3000, 8.0)).device_scene(cuda)
    o, d = _rays(4, 6000, 10.0)
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    (t, tri), ref = _pk_pair(cuda, ds, o_t, d_t, any_hit=True)
    hit = t < FLT_MAX
    assert torch.equal(hit, ref[0] < FLT_MAX) and float(hit.float().mean()) > 0.1
    geo = ds.ktri_geo[tri[hit].long()]
    ok, t64, _, _ = intersect_triangle(o_t[hit].double(), d_t[hit].double(),
                                       geo[:, 0:3].double(),
                                       geo[:, 3:6].double(),
                                       geo[:, 6:9].double())
    rel = ((t[hit].double() - t64).abs() / t64.abs()).cpu().numpy()
    assert np.quantile(rel, 0.99) <= 1e-5
    assert bool((t[hit] > 1e-3).all() and (t[hit] < 1e3).all())


# ------------------------------------------------- kernel D: edge cases

def _isect_pair(args):
    ok = stg.isect_cuda(*args)
    op = stg._isect_plain(*args)
    torch.cuda.synchronize()
    return ok, op


@pytest.mark.parametrize("stable", [True, False])
def test_s3_isect_exact_ties(cuda, stable):
    """Kernel D on the duplicate-triangle scene's primary wave through
    the card's own stages (exact ties as in test_kernel_exact_ties): every
    ray's winner (prim) equal to the plain version's -- the lowest lane,
    then the earlier word -- and t, b1, b2 to f32 rounding."""
    ds = _dup_scene(cuda, stable)
    _assert_copies_tie(ds, stable)
    o, d = _down_rays(4 * stg.PKT)
    rows = s3.rows_from_aos(torch.from_numpy(o).to(cuda),
                            torch.from_numpy(d).to(cuda))
    _, feats_t, scal, smeta, bscal, _ = s3._stage_prep(
        rows, ds.knode_f, ds.inst_inv[0], stable=ds.stable_frames)
    words, emeta = stg.emit_cuda(scal, smeta, bscal, ds.knode_f, 1e3,
                                 stg.STEP_CAP, stg.PCAP)
    slot_pkt = smeta[:, 0].contiguous()
    words, emeta = stg.refine_cuda(words, emeta, slot_pkt, feats_t,
                                   s3.leaf_aabb8(ds.knode_f,
                                                 ds.kleaf.shape[0]),
                                   1e3, stg.PCAP)
    ok, op = _isect_pair((words, emeta, slot_pkt, feats_t.t().contiguous(),
                          ds.kleaf, 1e-3, 1e3, stg.PCAP, ds.stable_frames))
    live = (smeta[:, 1] > 0)
    assert bool(((op[live][..., 0] - 5.0).abs() < 1e-4).all())
    assert torch.equal(ok[live][..., 1], op[live][..., 1])
    assert torch.allclose(ok[live], op[live], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stable", [True, False])
def test_s3_isect_edge_cases(cuda, stable):
    """Kernel D against its plain version on hand-made word lists over 8
    packets: slots whose every word keeps one ray block of eight, a slot
    list longer than one 128-word chunk, leaves with padded lanes (every
    leaf of the scene has fewer than 128 triangles), a half-parked packet
    and an all-parked one: equal outputs on >= 0.999 of lanes, parked
    lanes exact misses."""
    ds = _scene(_mesh(10, 3000, 8.0)).device_scene(cuda,
                                                   stable_frames=stable)
    npk = 8
    n = npk * stg.PKT
    o, d = _rays(9, n, 10.0)
    live = np.ones(n, bool)
    live[:stg.PKT] = False
    live[stg.PKT:2 * stg.PKT] = np.random.default_rng(2).uniform(
        size=stg.PKT) < 0.5
    live_t = torch.from_numpy(live).to(cuda)
    rows = s3.park_dead(tuple(torch.from_numpy(np.ascontiguousarray(v))
                              .to(cuda) for v in (*o.T, *d.T)), live_t)
    _, feats_t, *_ = s3._stage_prep(rows, ds.knode_f, ds.inst_inv[0],
                                    live=live_t, stable=stable)
    feats = feats_t.t().contiguous()
    nl = ds.kleaf.shape[0]
    prim = ds.kleaf[:, 10, :stg.T]
    assert bool(((prim < 0) | (prim >= 2 ** 24)).any(dim=1).all())
    rng = np.random.default_rng(8)
    nslot = 2 * npk + 1
    words = np.zeros((nslot, stg.PCAP), np.int32)
    cnt = np.zeros(nslot, np.int32)
    for s in range(nslot):
        m = 300 if s == nslot - 1 else 40
        leaves = rng.integers(0, nl, m)
        keep = (1 << rng.integers(0, 8, m) if s < npk
                else rng.integers(1, 256, m))
        words[s, :m] = ((leaves + 1) << stg.W_LEAF_SHIFT) \
            | (keep << stg.W_KEEP_SHIFT)
        cnt[s] = m
    emeta = np.zeros((nslot, 8), np.int32)
    emeta[:, 0] = cnt
    slot_pkt = torch.arange(nslot, dtype=torch.int32, device=cuda) % npk
    ok, op = _isect_pair((torch.from_numpy(words).to(cuda),
                          torch.from_numpy(emeta).to(cuda), slot_pkt, feats,
                          ds.kleaf, 1e-3, 1e3, stg.PCAP, stable))
    lane_live = live_t.view(npk, stg.PKT)[slot_pkt.long()]
    miss = torch.tensor([FLT_MAX, -1.0, 0.0, 0.0], device=cuda)
    assert bool((ok[~lane_live] == miss).all())
    assert torch.equal(ok[~lane_live], op[~lane_live])
    hk, hp = ok[..., 0] < FLT_MAX, op[..., 0] < FLT_MAX
    assert float((hk == hp)[lane_live].float().mean()) >= 0.999
    same = hk & hp & (ok[..., 1] == op[..., 1])
    assert float(same.sum()) >= 0.999 * float((hk & hp).sum())
    assert float(hp[lane_live].float().mean()) > 0.05
    rel = ((ok[..., 0] - op[..., 0]).abs() / op[..., 0].abs())[same]
    assert float(torch.quantile(rel.double(), 0.99)) <= 1e-5
    for k in (2, 3):
        assert float((ok[..., k] - op[..., k]).abs()[same].max()) <= 1e-4
    assert stg.isect_cuda.launches >= 1


# ------------------------------------- kernels C and D: their other forms

@pytest.mark.parametrize("grid", [1, 0])
def test_s3_refine_sort_form_matches_plain(cuda, grid):
    """Kernel C's tq-sort form against _refine_plain(sort=True) on
    hand-made lists over 8 packets (lengths 0 to past PCAP, a list of one
    tq bucket, a list of two buckets interleaved, random tq): the same
    emeta and kept words in the same order, each list the unsorted form's
    kept words stably ordered by bucket; and on a wave's emitted lists."""
    ds = _scene(_mesh(10, 3000, 8.0)).device_scene(cuda)
    nl = ds.kleaf.shape[0]
    aabb8 = s3.leaf_aabb8(ds.knode_f, nl)
    npk = 8
    o, d = _rays(6, npk * stg.PKT, 10.0)
    feats_t = torch.zeros(16, npk * stg.PKT)
    feats_t[0:3] = torch.from_numpy(d.T.copy())
    feats_t[6:9] = torch.from_numpy(o.T.copy())
    feats_t = feats_t.to(cuda)
    rng = np.random.default_rng(11)
    lens = [0, 1, 31, 33, 130, stg.PCAP, 1500, 200, 200, 64]
    nslot = len(lens)
    words = np.zeros((nslot, stg.PCAP), np.int32)
    for s, n in enumerate(lens):
        m = min(n, stg.PCAP)
        tq = rng.integers(0, 512, m)
        if s == 7:
            tq[:] = 77                            # one bucket: list order
        if s == 8:
            tq = np.where(np.arange(m) % 2, 40, 500)
        words[s, :m] = ((rng.integers(0, nl, m) + 1) << stg.W_LEAF_SHIFT) \
            | (rng.integers(1, 256, m) << stg.W_KEEP_SHIFT) | tq
    emeta = np.zeros((nslot, 8), np.int32)
    emeta[:, 0] = lens
    args = (torch.from_numpy(words).to(cuda), torch.from_numpy(emeta).to(cuda),
            torch.arange(nslot, dtype=torch.int32, device=cuda) % npk,
            feats_t, aabb8, 1e3, stg.PCAP)
    before = stg.refine_cuda.sort_launches
    rk, rek = stg.refine_cuda(*args, sort=True, grid=grid)
    rp, rep = stg._refine_plain(*args, sort=True)
    ru, _ = stg.refine_cuda(*args, grid=grid)
    torch.cuda.synchronize()
    assert stg.refine_cuda.sort_launches == before + 1
    assert torch.equal(rek, rep) and int(rek[:, 0].sum()) > 1000
    for s in range(nslot):
        k = int(rek[s, 0])
        assert torch.equal(rk[s, :k], rp[s, :k])
        u = ru[s, :k]
        order = torch.argsort(stg.tq_bucket(u), stable=True)
        assert torch.equal(rk[s, :k], u[order])
    k8 = int(rek[8, 0])
    assert bool((stg.tq_bucket(rk[8, :k8]).diff() >= 0).all())
    tlas = _scene(_mesh(10, 3000, 8.0))
    ds, feats_t, scal, smeta, bscal = _s3_stages(cuda, tlas)
    wk, ek = stg.emit_cuda(scal, smeta, bscal, ds.knode_f, 1e3,
                           stg.STEP_CAP, stg.PCAP)
    args = (wk, ek, smeta[:, 0].contiguous(), feats_t,
            s3.leaf_aabb8(ds.knode_f, ds.kleaf.shape[0]), 1e3, stg.PCAP)
    rk, rek = stg.refine_cuda(*args, sort=True)
    rp, rep = stg._refine_plain(*args, sort=True)
    assert torch.equal(rek, rep)
    valid = torch.arange(stg.PCAP, device=cuda)[None, :] < rek[:, :1]
    assert torch.equal(rk[valid], rp[valid])


def _deep_scene(dev, stable):
    """A wall at z = 0 over 20,000 small triangles in [-8, 8]^2 x
    [-6, -1]: rays from z = 5 pointing down all hit the wall at t = 5,
    and a packet spread over the square crosses more leaves than one of
    kernel D's 128-position chunks."""
    rng = np.random.default_rng(14)
    wall = np.array([[-60, -60, 0], [120, -60, 0], [-60, 120, 0]],
                    np.float32)
    c = rng.uniform(-8, 8, (20000, 3)).astype(np.float32)
    c[:, 2] = rng.uniform(-6, -1, 20000)
    v = (c[:, None, :] + rng.normal(scale=0.2, size=(20000, 3, 3))
         .astype(np.float32)).reshape(-1, 3)
    verts = np.concatenate([wall, v]).astype(np.float32)
    mesh = types.Mesh(verts, np.arange(len(verts), dtype=np.uint32)
                      .reshape(-1, 3))
    return _scene(mesh).device_scene(dev, stable_frames=stable)


def _card_lists(ds, o, d, sort):
    """A wave through the card's prep, emit and refine (tq-sorted with
    sort): D's arguments."""
    rows = s3.rows_from_aos(o, d)
    _, feats_t, scal, smeta, bscal, _ = s3._stage_prep(
        rows, ds.knode_f, ds.inst_inv[0], stable=ds.stable_frames)
    words, emeta = stg.emit_cuda(scal, smeta, bscal, ds.knode_f, 1e3,
                                 stg.STEP_CAP, stg.PCAP)
    slot_pkt = smeta[:, 0].contiguous()
    words, emeta = stg.refine_cuda(words, emeta, slot_pkt, feats_t,
                                   s3.leaf_aabb8(ds.knode_f,
                                                 ds.kleaf.shape[0]),
                                   1e3, stg.PCAP, sort=sort)
    return (words, emeta, slot_pkt, feats_t.t().contiguous(), ds.kleaf,
            1e-3, 1e3, stg.PCAP, ds.stable_frames), smeta[:, 1] > 0


def _hk(out):
    return pk.HitRecord(t=out[..., 0].reshape(-1),
                        prim=out[..., 1].reshape(-1), slot=None, b1=None,
                        b2=None)


@pytest.mark.parametrize("stable", [True, False])
def test_s3_isect_lean_and_cull_match_plain(cuda, stable):
    """Kernel D's lean and cull forms, alone and together, on tq-sorted
    and unsorted lists longer than one chunk, against _isect_plain with
    the same flags: the traversal bars; each form's t bit-equal to the
    same version's default form (the cull skips only pairs that cannot
    lower a t), prims >= 0.999 of it; lean lanes 2-3 zero; on the sorted
    lists, where the wall's leaf comes first, the cull skipped pairs in
    the plain version and in the kernel; the kernel never skips more than
    the plain version's whole-list rule."""
    ds = _deep_scene(cuda, stable)
    rng = np.random.default_rng(3)
    n = 8 * stg.PKT
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-8, 8, (n, 2))
    o[:, 2] = 5.0
    # one direction octant: every slot is a whole packet, every ray hits
    d = np.abs(rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for sort in (False, True):
        args, live = _card_lists(ds, torch.from_numpy(o).to(cuda),
                                 torch.from_numpy(d).to(cuda), sort)
        assert int(args[1][live, 0].max()) > 128
        base_k, base_p = _isect_pair(args)
        assert bool((base_p[live][..., 0] < FLT_MAX).all())
        for lean, cull in ((True, False), (False, True), (True, True)):
            st, kst = {}, {}
            ok = stg.isect_cuda(*args, lean=lean, cull=cull, stats=kst)
            op = stg._isect_plain(*args, lean=lean, cull=cull, stats=st)
            torch.cuda.synchronize()
            _agree(_hk(op[live]), _hk(ok[live]), False)
            for out, base in ((ok, base_k), (op, base_p)):
                assert torch.equal(out[live][..., 0], base[live][..., 0])
                same = (out[live][..., 1] == base[live][..., 1])
                assert float(same.float().mean()) >= 0.999
            if lean:
                assert not bool(ok[..., 2:].any()) and not bool(op[..., 2:].any())
            else:
                assert torch.equal(ok[..., 2:] != 0, base_k[..., 2:] != 0)
            if cull:
                assert kst["culled"] <= st["culled"]
            if cull and sort:
                assert st["culled"] > 0 and kst["culled"] > 0


@pytest.mark.parametrize("stable", [True, False])
def test_s3_isect_cull_exact_ties(cuda, stable):
    """On the duplicate-triangle scene (every ray ties at t = 5 over two
    or more leaves, one list chunk) the cull form picks the plain cull
    form's prim on every ray; t to f32 rounding.  In one chunk the
    kernel applies the plain version's rule to its own bests, so the
    kernel's cull fires where the plain one does; the counts may differ
    by the few pairs whose entry bound a rounding of t moves a best
    across (every ray here ties at the leaves' entry)."""
    ds = _dup_scene(cuda, stable)
    o, d = _down_rays(4 * stg.PKT)
    args, live = _card_lists(ds, torch.from_numpy(o).to(cuda),
                             torch.from_numpy(d).to(cuda), True)
    assert int(args[1][live, 0].max()) <= 128
    st, kst = {}, {}
    ok = stg.isect_cuda(*args, cull=True, stats=kst)
    op = stg._isect_plain(*args, cull=True, stats=st)
    torch.cuda.synchronize()
    assert (kst["culled"] > 0) == (st["culled"] > 0)
    assert bool(((op[live][..., 0] - 5.0).abs() < 1e-4).all())
    assert torch.equal(ok[live][..., 1], op[live][..., 1])
    assert torch.allclose(ok[live][..., 0], op[live][..., 0], rtol=1e-6,
                          atol=0.0)


def test_rd_route_matches_direct_render(cuda, tmp_path, monkeypatch):
    """sample1's RD route (Platform, buffers, TraceRays) on the Cornell box
    at 64x64 on the card: its accumulator after two frames equals a
    direct WavefrontPathTracer.render of the same scene, resources and
    camera at least as closely as two direct renders equal each other,
    and the accumulator stays on the card between frames."""
    from radiance_tpu_torch.api import pipeline, platform
    from radiance_tpu_torch.engine import programs
    from radiance_tpu_torch.samples import sample1

    monkeypatch.setattr(platform.Platform, "_instance", None)
    w, batch, depth = 64, 2, 2
    host = procedural.cornell_box(light_dir=(0.3, -1.0, -0.4), device=cuda)
    accums = []
    trace = pipeline.TraceRays

    def traced(plt, *a):
        trace(plt, *a)
        prog = plt.active_pipeline.modules[a[0]]
        handles = dict(zip(prog.descriptor_semantics,
                           plt.bound_descriptor_set))
        accums.append(handles["image_scratch"].device_value)

    monkeypatch.setattr(pipeline, "TraceRays", traced)
    img = sample1.render_sample1(w, w, batch, depth, frames=2, scene=host,
                                 out=str(tmp_path / "s1.png"), device=cuda)
    assert len(accums) == 2 and all(a.is_cuda for a in accums)

    tracer = programs.sample1_program().tracer
    res = dict(host.resources)
    res["camera"] = camera.camera_params(sample1.sample1_camera(w, w), cuda)
    direct = []
    for _ in range(2):
        acc = torch.zeros(w * w, 3, device=cuda)
        for f in range(2):
            acc, dimg = tracer.render(host.device_scene(cuda), res, acc,
                                      batch * f, w, w, batch=batch,
                                      depth=depth)
        direct.append((acc, dimg))
    d_rd = float((accums[-1] - direct[0][0]).abs().max())
    d_dd = float((direct[1][0] - direct[0][0]).abs().max())
    assert d_rd <= d_dd, (d_rd, d_dd)
    assert torch.isfinite(accums[-1]).all()
    if d_dd == 0.0:
        np.testing.assert_array_equal(img, direct[0][1].cpu().numpy())
    assert img[..., :3].std() > 1.0


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_on_card_matches_packet_kernel(cuda, any_hit):
    """The two-level walk (ops/traversal.py, torch ops on the card) against
    the packet kernel on a small scene, and against its own CPU run."""
    from radiance_tpu_torch.ops import traversal

    tlas = _scene(_mesh(10, 3000, 8.0))
    o, d = _rays(1, 5000, 10.0)
    ds = tlas.device_scene(cuda)
    ot, dt = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    walk = traversal.trace_rays(ds, ot, dt, 1e-3, 1e3,
                                any_hit_terminate=any_hit)
    kern = pk.trace_rays_packet(ds, ot, dt, 1e-3, 1e3, any_hit=any_hit)
    hit = _agree(kern, walk, any_hit)
    assert hit.mean() > 0.05
    cpu = traversal.trace_rays(tlas.device_scene("cpu"),
                               torch.from_numpy(o), torch.from_numpy(d),
                               1e-3, 1e3, any_hit_terminate=any_hit)
    _agree(cpu, walk, any_hit)


def test_lbvh_on_card_bit_equal_to_cpu(cuda):
    """bvh/lbvh.lbvh_scene on the card: node_packed and bundle_packed
    equal the CPU build's bit for bit (IEEE min, max, add, multiply and
    divide only; the rows built in int32)."""
    from radiance_tpu_torch.bvh import lbvh

    rng = np.random.default_rng(3)
    c = rng.uniform(-20, 20, (20000, 3)).astype(np.float32)
    v = (c[:, None, :] + rng.normal(scale=0.25, size=(20000, 3, 3))
         .astype(np.float32)).reshape(-1, 3)
    tris = torch.arange(v.shape[0], dtype=torch.int32).reshape(-1, 3)
    vt = torch.from_numpy(v)
    on_card = lbvh.lbvh_scene(vt.to(cuda), tris.to(cuda))
    on_cpu = lbvh.lbvh_scene(vt, tris)
    for k in ("node_packed", "bundle_packed"):
        assert torch.equal(getattr(on_card, k).cpu().view(torch.int32),
                           getattr(on_cpu, k).view(torch.int32)), k


def _city_on(dev, w, n_tris=100_000):
    """bench._engine_setup's city bindings on a cut of the bench's city,
    a w x w camera, and sample1's tracer."""
    import bench
    from radiance_tpu_torch.scene import bindings

    verts, tris = bench.scene_geometry("city", n_tris=n_tris)
    tris = tris.astype(np.uint32)
    fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                  verts[tris[:, 2]] - verts[tris[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-9)
    res = bindings.make_scene_bindings(
        [types.MeshInfo()], verts, tris, np.zeros_like(verts),
        np.repeat(fn, 3, axis=0).astype(np.float32),
        [types.Material(albedo=(0.7, 0.7, 0.7, 1.0), roughness=0.6)],
        types.SceneProperties(lights=[types.DirLight(
            direction=(0.26726124, 0.8017837, 0.5345225, 0.0),
            color=(3.0, 3.0, 3.0, 1.0))]), device=dev)
    res["camera"] = camera.camera_params(types.PhysicalCamera(
        width_pixel=float(w), height_pixel=float(w), focal_length=0.035,
        sensor_width=0.05, focal_distance=80.0, z=140.0), dev)
    scene = _scene(types.Mesh(verts, tris)).device_scene(dev)
    tracer = WavefrontPathTracer(
        ray_generator=camera.physical_camera_raygen,
        sbt=ShaderBindingTable.from_json(shaders.DEFAULT_SBT_RECORDS,
                                         shaders.SHADER_REGISTRY))
    return scene, res, tracer


def test_sharded_city_frame_matches_render(cuda):
    """render_sharded on 3 shards of one card (65,536 pixels padded to
    65,538: shards that end inside a packet) against render: on >= 0.9999
    of pixels the u8 image equal and accum within rtol 1e-5, atol 1e-6
    (a tie between leaves at a packet boundary may pick another prim)."""
    from radiance_tpu_torch.parallel import sharding

    w = 256
    scene, res, tracer = _city_on(cuda, w)
    acc0 = torch.zeros(w * w, 3, device=cuda)
    want = tracer.render(scene, res, acc0, 0, w, w, batch=2, depth=2)
    mesh = sharding.make_mesh(3, devices=[cuda] * 3)
    got = sharding.render_sharded(tracer, mesh, scene, res, acc0, 0, w, w,
                                  batch=2, depth=2)
    assert got[0].device == want[0].device and got[1].shape == (w, w, 4)
    same_img = (got[1] == want[1]).all(-1).reshape(-1)
    close = torch.isclose(got[0], want[0], rtol=1e-5, atol=1e-6).all(-1)
    assert float((same_img & close).float().mean()) >= 0.9999
    assert want[1][..., :3].float().std() > 1.0


@pytest.fixture(scope="module")
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("one card: the launch-device check needs two")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_launches_run_on_their_tensors_card(two_cards):
    """The packet kernel and the stream3 chain through D (F, B, C, D) on
    cuda:1 tensors, called from the main thread with cuda:0 current,
    equal the same calls on cuda:0: each launch makes its tensors'
    device current."""
    tlas = _scene(_mesh(10, 3000, 8.0))
    o, d = _rays(1, 5000, 10.0)
    out = {}
    with torch.cuda.device(two_cards[0]):
        for dev in two_cards:
            ds = tlas.device_scene(dev)
            ot, dt = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
            rec = pk.trace_rays_packet(ds, ot, dt, 1e-3, 1e3)
            args, _ = _card_lists(ds, ot, dt, sort=False)
            dout = stg.isect_cuda(*args)
            assert torch.cuda.current_device() == 0
            torch.cuda.synchronize(dev)
            out[dev.index] = (rec.t.cpu(), rec.prim.cpu(), dout.cpu())
    assert float((out[0][0] < FLT_MAX).float().mean()) > 0.05
    for a, b in zip(out[0], out[1]):
        assert torch.equal(a, b)


def test_span_maps_device_records_inside_it(cuda):
    """Under rtbench's CUDA-only profile (rtbench/prof.device_profile), a
    kernel launched inside a span that ends with torch.cuda.synchronize()
    has its device record inside the span once mapped onto
    perf_counter_ns by the span log's anchor, within 20 us."""
    from radiance_tpu_torch.utils import profiling
    from rtbench import prof

    with profiling.span("off"):             # a span found off ends a session
        pass
    with prof.device_profile() as p:
        for i in range(4):
            with profiling.span(f"clock.{i}"):
                torch.cuda._sleep(200_000)
                torch.cuda.synchronize()
    log = profiling.spans()
    spans = [r for r in log.records if r.name.startswith("clock.")]
    recs = [r for r in prof.records(p) if "spin" in r[0]]
    assert len(spans) == len(recs) == 4
    slack = 20_000
    for sp, (_, start, dur) in zip(spans, recs):
        a = log.anchor.to_perf_ns(start)
        assert sp.start_ns - slack <= a < a + dur <= sp.end_ns + slack, (
            sp, a - sp.start_ns, sp.end_ns - a - dur)
