"""The frozen copies in rtbench/ against their originals at small sizes:
the port's own functions where they live in the port, literals printed by
bench.py's and chip_smoke.py's functions where they live there (neither
may be imported here)."""

import hashlib

import numpy as np
import pytest
import torch

from conftest import ROOT  # noqa: F401  (puts the repository on sys.path)
from rtbench import launches, prof, rays, roofline
from rtbench.geometry import city, interior
from rtbench.reference import trace as rtrace

IDX = [0, 100, 1000, 3071]


def test_city_matches_bench_scene_geometry():
    # bench.scene_geometry("city", 20000)
    v, t = city.generate(20000)
    assert v.shape == (60000, 3) and t.shape == (20000, 3)
    assert hashlib.sha256(v.tobytes()).hexdigest() == (
        "0ac4fd8d41f79c20d9033652b9096e5d54aa7da9932e449ff27f4e9f039f3fdd")
    assert v[-1].tolist() == [14.170797348022461, -5.714499473571777,
                              45.37371063232422]
    assert (t == np.arange(60000, dtype=np.uint32).reshape(-1, 3)).all()


def test_interior_matches_the_port():
    from radiance_tpu_torch.scene import procedural
    v0, t0, _ = procedural.interior_hall(30000, seed=11)
    v1, t1 = interior.generate(30000, seed=11)
    assert np.array_equal(v0, v1) and np.array_equal(t0, t1)


def test_pcg3d_matches_bench():
    # bench._pcg3d_np([[5, 0, 7], [123456789, 0, 4000000000], [0, 0, 0]])
    v = torch.tensor([[5, 0, 7], [123456789, 0, 4000000000], [0, 0, 0]])
    want = [[0.9151206016540527, 0.36669304966926575, 0.3583245575428009],
            [0.28189146518707275, 0.10013565421104431, 0.12116408348083496],
            [0.608151912689209, 0.659798264503479, 0.24641849100589752]]
    assert rays.pcg3d(v).tolist() == want


def test_jittered_primaries_match_chip_smoke():
    # chip_smoke.interior_rays(cpu, 64, 48, 5, bench._pcg3d_np)
    want = [[-0.48813048005104065, -0.28891894221305847, -0.8235620856285095],
            [-0.4481155276298523, -0.2617216408252716, -0.8548066020011902],
            [-0.4034278690814972, 0.08648942410945892, -0.9109147191047668],
            [0.4771271347999573, 0.2838135063648224, -0.831744909286499]]
    p = rays.Primaries(64, 48, (0.0, 6.0, 46.0), torch.device("cpu"))
    o, d = p.rays(5)
    assert o[IDX].tolist() == [[0.0, 6.0, 46.0]] * 4
    assert torch.allclose(d[IDX], torch.tensor(want), rtol=0, atol=2e-7)
    o2, d2 = p.rays(5, torch.tensor(IDX))
    assert torch.equal(d2, d[IDX])


def test_tile_order_matches_chip_smoke_camera_rays():
    # chip_smoke.camera_rays(cpu, 64, 48): unjittered, from (0, 0, 140)
    want = [[-0.4927809536457062, -0.2874555289745331, -0.8213015198707581],
            [-0.44863370060920715, -0.2617030143737793, -0.8545404076576233],
            [-0.40859800577163696, 0.09269121289253235, -0.9079955816268921],
            [0.48264259099960327, 0.27851417660713196, -0.8303528428077698]]
    order = rays.tile_order(64, 48)[IDX]
    xs, ys = (order % 64) / 64 - 0.5, (order // 64) / 48 - 0.5
    d = np.stack([xs * 1.2, ys * 0.7, -np.ones(4)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    assert np.allclose(d, want, rtol=0, atol=2e-7)


def test_mirror_bounce_matches_chip_smoke():
    # chip_smoke.bounce_rays(rmath, o, d, t1, FLT_MAX)
    o = torch.tensor([[0, 0, 140.], [0, 0, 140.], [1, 2, 3], [0, 6, 46]])
    d = torch.nn.functional.normalize(torch.tensor(
        [[0.1, 0.2, -1.], [0.3, 0, -1], [0, 1, 0], [-0.2, 0.1, -1]]), dim=-1)
    t1 = torch.tensor([10.0, 3.4028234663852886e38, 7.5, 140.0])
    o2, d2 = rays.mirror_bounce(o, d, t1, 3.4028234663852886e38)
    want_o2 = [[0.9758026003837585, 1.951605200767517, 130.24197387695312],
               [0.0, 0.0, 140.0], [1.0, 9.49899959564209, 3.0],
               [-27.325010299682617, 19.662504196166992, -90.62504577636719]]
    want_d2 = [[-0.09758998453617096, -0.19517996907234192, 0.9758999943733215],
               [0.2873478829860687, 0.0, -0.9578262567520142],
               [0.0, -1.0, 0.0],
               [0.1951799988746643, -0.09758998453617096, 0.9758999943733215]]
    assert torch.allclose(o2, torch.tensor(want_o2), rtol=1e-6, atol=1e-5)
    assert torch.allclose(d2, torch.tensor(want_d2), rtol=0, atol=1e-6)


def test_lights_and_cameras_match():
    # bench.light_vec() (the city) and chip_smoke.interior_light()
    assert rays.to_light([0.5, 1.5, 1.0]).tolist() == [
        0.26726123690605164, 0.8017837405204773, 0.5345224738121033]
    assert rays.to_light([0.15, 1.0, 0.05]).tolist() == [
        0.1481594443321228, 0.9877296090126038, 0.04938647896051407]
    import json
    import os
    for name, eye in (("city_1m", [0.0, 0.0, 140.0]),
                      ("interior_1m", [0.0, 6.0, 46.0])):
        with open(os.path.join(ROOT, "rtbench", "configs",
                               name + ".json")) as f:
            cfg = json.load(f)
        # chip_smoke.city_resources' PhysicalCamera, sample1's light
        assert cfg["eye"] == eye
        assert cfg["camera"] == {"focal_length": 0.035, "sensor_width": 0.05,
                                 "focal_distance": 80.0}
        assert cfg["view_light"] == {"direction": [0.3, -1.0, -0.4],
                                     "color": [3.0, 3.0, 3.0]}


def test_busy_union_matches_chip_smoke():
    # chip_smoke.busy_ms over these records: 2.1e-05 ms
    recs = [("a", 0, 10), ("b", 5, 10), ("c", 30, 5), ("d", 31, 2),
            ("e", 40, 1)]
    assert prof.busy_s(recs) == pytest.approx(2.1e-05 / 1e3)
    assert prof.gaps(recs) == [(15, 15), (35, 5)]


def test_lost_records_count_the_launches(monkeypatch):
    from radiance_tpu_torch.ops import packet_trace, stream3_stages
    monkeypatch.setattr(packet_trace.packet_trace_cuda, "launches",
                        {"closest": 2, "any_hit": 1})
    monkeypatch.setattr(stream3_stages.KERNELS["emit"], "launches", 2)
    recs = [("packet_trace_kernel<1>", 0, 1), ("packet_trace_kernel<0>", 2, 1),
            ("emit_window_kernel", 4, 1), ("emit_window_kernel", 6, 1)]
    assert launches.lost_records(recs) == 1
    assert launches.lost_records(recs + [("packet_trace_kernel", 9, 1)]) == 0


def test_classifier():
    for name in ("void at::native::elementwise_kernel<128, 2>(int)",
                 "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel",
                 "Memcpy DtoH (Device -> Pinned)", "Memset (Device)",
                 "void thrust::cuda_cub::core::_kernel_agent"):
        assert prof.is_torch(name), name
    for name in ("packet_trace_kernel", "emit_window_kernel",
                 "void isect_kernel<128, 9>(Params)", "oscal_kernel"):
        assert not prof.is_torch(name), name


def test_least_work_of_an_iteration():
    n, tris = 1920 * 1080, 1_000_000
    assert roofline.wave_bytes(n, tris) == (
        3 * n * 24 + 2 * n * 16 + n * 4 + 3 * tris * 36)
    assert roofline.wave_flops(n) == 3 * n * 44
    assert roofline.wave_least_s(n, tris) == pytest.approx(
        roofline.wave_bytes(n, tris) / 3.35e12)


def test_reference_tracer_against_brute_force():
    v, t = interior.generate(6000)
    tv = torch.from_numpy(v[t.astype(np.int64)])
    tree = rtrace.build(tv)
    g = torch.Generator().manual_seed(0)
    r = 300
    o = torch.tensor([0.0, 6.0, 46.0]).expand(r, 3).contiguous()
    d = torch.cat([torch.rand(r, 2, generator=g) - 0.5, -torch.ones(r, 1)], 1)
    d = d / d.norm(dim=-1, keepdim=True)
    t_r, p_r, _, _ = rtrace.trace(tree, o, d, 1e-3, 1e4)
    _, occ, _, _ = rtrace.trace(tree, o, d, 1e-3, 1e4, any_hit=True)
    v0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    dd = d[:, None].expand(-1, len(v0), -1)
    p = torch.cross(dd, e2[None].expand(r, -1, -1), dim=-1)
    det = (e1[None] * p).sum(-1)
    s = o[:, None] - v0[None]
    u = (s * p).sum(-1) / det
    q = torch.cross(s, e1[None].expand(r, -1, -1), dim=-1)
    vv = (dd * q).sum(-1) / det
    tt = (e2[None] * q).sum(-1) / det
    ok = (u >= 0) & (vv >= 0) & (u + vv <= 1) & (tt > 1e-3) & (tt < 1e4)
    tb, pb = torch.where(ok, tt, torch.inf).min(-1)
    pb = torch.where(ok.any(-1), pb, -1)
    assert (pb >= 0).float().mean() > 0.9
    assert torch.equal(p_r, pb)
    assert torch.equal(occ >= 0, pb >= 0)
    both = pb >= 0
    assert torch.allclose(t_r[both], tb[both], rtol=1e-5)
