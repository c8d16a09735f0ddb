"""radiance_tpu_torch.parallel.sharding against the port's own render.

At the bars of the JAX package's tests/test_sharding.py: the pixel and
staged modes on make_mesh(8, devices=["cpu"] * 8) (the counterpart of
its virtual 8-device CPU mesh) hold accum to rtol 1e-5, atol 1e-6 and
the images equal; the sample-parallel and 2D modes hold accum to a
single-device render of batch n_sp * batch at rtol 1e-4, atol 1e-5.
Scenes: the Cornell box at 32x32 (per-instance sweeps) and a 20k-triangle
cut of the bench's city (the stream3 primary, live-masked shadows,
argsorted bounces), with shards smaller than a 1024-ray packet and pixel
counts the mesh does not divide.  Also: the mesh constructors' errors
(no CPU fallback), replicate(), the per-device workers and their
exceptions, and the kernel wrappers' launch counts under threads.
"""

import sys
import threading

import pytest
import torch

from radiance_tpu_torch.ops import cuda_build
from radiance_tpu_torch.parallel import sharding

from test_torch_engine import (  # noqa: F401
    _cornell, _city, _one_torch_thread, tracers)

W = H = 32
N = W * H
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def tracer(tracers):  # noqa: F811
    return tracers[1]


@pytest.fixture(scope="module")
def scenes():
    return {"cornell": _cornell(W, H)[1], "city": _city(W, H)[1]}


@pytest.fixture(scope="module")
def renders(tracer, scenes):
    """render at batch 2 and 4, depth 2, from a zero accumulator."""
    return {(k, b): tracer.render(*v, torch.zeros(N, 3), 0, W, H, batch=b,
                                  depth=2)
            for k, v in scenes.items() for b in (2, 4)}


def _hold_pixels(got, want):
    acc, img = got
    torch.testing.assert_close(acc, want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(img.reshape(want[1].shape), want[1])
    assert want[1][..., :3].float().std() > 1.0


@pytest.mark.parametrize("scene", ["cornell", "city"])
@pytest.mark.parametrize("shards", [8, 7])
def test_render_sharded_matches_render(tracer, scenes, renders, scene,
                                       shards):
    # 7 shards: 1024 pixels padded to 1029, 147 a shard
    mesh = sharding.make_mesh(shards, devices=["cpu"] * shards)
    got = sharding.render_sharded(tracer, mesh, *scenes[scene],
                                  torch.zeros(N, 3), 0, W, H, batch=2,
                                  depth=2)
    assert got[0].shape == (N, 3) and got[1].shape == (H, W, 4)
    _hold_pixels(got, renders[(scene, 2)])


def test_shard_frame_continues_a_frame(tracer, scenes, renders):
    fn = sharding.shard_frame(tracer, sharding.make_mesh(8, devices=CPU8),
                              batch=2, depth=2)
    acc0, _ = renders[("cornell", 2)]
    got = fn(*scenes["cornell"], acc0, 2, torch.arange(N))
    want = tracer.render(*scenes["cornell"], acc0, 2, W, H, batch=2, depth=2)
    _hold_pixels(got, want)
    with pytest.raises(ValueError, match="equal shards"):
        fn(*scenes["cornell"], acc0[:N - 1], 2, torch.arange(N - 1))


@pytest.mark.parametrize("scene", ["cornell", "city"])
def test_sample_parallel_matches_render(tracer, scenes, renders, scene):
    fn = sharding.sample_parallel_frame(
        tracer, sharding.make_mesh(4, devices=CPU8), batch=1, depth=2)
    acc, img = fn(*scenes[scene], torch.zeros(N, 3), 0, torch.arange(N))
    assert torch.isfinite(acc).all() and acc.std() > 0.01
    # device d uses frame id d: the sample set of one device's batch 4
    acc1, img1 = renders[(scene, 4)]
    torch.testing.assert_close(acc, acc1, rtol=1e-4, atol=1e-5)
    di = (img.int() - img1.reshape(-1, 4).int()).abs()
    assert (di > 1).float().mean() < 0.01


def test_tile_sample_2d_mesh_matches_render(tracer, scenes, renders):
    """4x2 mesh (pixels x samples), batch 2: a single-device frame of
    batch 4 over the same sample ids, then the progressive continuation
    advancing totalSamples by 4."""
    scene = scenes["cornell"]
    fn = sharding.tile_sample_frame(
        tracer, sharding.make_mesh2d(4, 2, devices=CPU8), batch=2, depth=2)
    acc, img = fn(*scene, torch.zeros(N, 3), 0, torch.arange(N))
    acc1, img1 = renders[("cornell", 4)]
    torch.testing.assert_close(acc, acc1, rtol=1e-4, atol=1e-5)
    di = (img.int() - img1.reshape(-1, 4).int()).abs()
    assert (di > 1).float().mean() < 0.01
    acc2, _ = fn(*scene, acc, 4, torch.arange(N))
    want2, _ = tracer.render(*scene, acc1, 4, W, H, batch=4, depth=2)
    torch.testing.assert_close(acc2, want2, rtol=1e-4, atol=1e-5)


def test_tile_sample_on_the_city_with_swapped_axes(tracer, scenes, renders):
    # a ("sp", "px") mesh: the modes read the axes by name
    mesh = sharding.Mesh(sharding.make_mesh2d(2, 4, devices=CPU8).devices,
                         ("sp", "px"))
    fn = sharding.tile_sample_frame(tracer, mesh, batch=2, depth=2)
    acc, _ = fn(*scenes["city"], torch.zeros(N, 3), 0, torch.arange(N))
    torch.testing.assert_close(acc, renders[("city", 4)][0], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("routes", ["auto", (None, None, None)])
def test_staged_matches_render(tracer, scenes, renders, routes):
    fn = sharding.staged_shard_frame(
        tracer, sharding.make_mesh(8, devices=CPU8), batch=2, depth=2,
        routes=routes)
    got = fn(*scenes["city"], torch.zeros(N, 3), 0, torch.arange(N))
    _hold_pixels(got, renders[("city", 2)])


def test_staged_explicit_routes_and_offsets(tracer, scenes):
    routes = ("stream3", "gen1_sort", "stream3", "gen1_live")
    fn = sharding.staged_shard_frame(
        tracer, sharding.make_mesh(8, devices=CPU8), batch=1, depth=2,
        routes=routes, hit_group_offset=0, miss_group_offset=0)
    frame = tracer.frame_fn(batch=1, depth=2, routes=routes)
    scene = scenes["city"]
    got = fn(*scene, torch.zeros(N, 3), 0, torch.arange(N))
    _hold_pixels(got, frame(*scene, torch.zeros(N, 3), 0, torch.arange(N)))


def test_sharded_modes_run_unbounded(tracer, scenes, renders):
    import dataclasses
    bounded = dataclasses.replace(tracer, tbound=True)
    got = sharding.render_sharded(bounded, sharding.make_mesh(8, devices=CPU8),
                                  *scenes["city"], torch.zeros(N, 3), 0, W,
                                  H, batch=2, depth=2)
    _hold_pixels(got, renders[("city", 2)])
    assert not bounded._tb_store


def test_mesh_shapes():
    mesh = sharding.make_mesh(3, devices=["cpu"] * 5)
    assert mesh.shape == {"px": 3} and mesh.devices.shape == (3,)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    m2 = sharding.make_mesh2d(3, 2, axes=("a", "b"), devices=["cpu"] * 6)
    assert list(m2.shape.items()) == [("a", 3), ("b", 2)]
    with pytest.raises(ValueError, match="axis names"):
        sharding.Mesh(m2.devices, ("a",))


def test_mesh_raises_without_enough_devices(monkeypatch):
    with pytest.raises(ValueError, match="devices given"):
        sharding.make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="devices given"):
        sharding.make_mesh2d(3, 3, devices=CPU8)
    # no card: the default mesh raises, it does not fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharding.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharding.make_mesh2d(1, 1)
    # one card: a mesh of two raises, it does not shrink
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 devices, but 1 CUDA cards"):
        sharding.make_mesh(2)
    with pytest.raises(ValueError, match="4 devices, but 1 CUDA cards"):
        sharding.make_mesh2d(2, 2)


def test_worker_exception_reaches_the_caller(tracer, scenes):
    import dataclasses
    calls = []

    def raygen(resources, pixel_index, rand_input):
        calls.append(int(pixel_index[0]))
        if int(pixel_index[0]) >= N // 2:
            raise FloatingPointError("shard failed")
        return tracer.ray_generator(resources, pixel_index, rand_input)

    bad = dataclasses.replace(tracer, ray_generator=raygen)
    mesh = sharding.make_mesh(4, devices=["cpu"] * 4)
    with pytest.raises(FloatingPointError, match="shard failed"):
        sharding.render_sharded(bad, mesh, *scenes["cornell"],
                                torch.zeros(N, 3), 0, W, H, batch=1, depth=1)
    # shards run in mesh order on their device's worker: the third failed
    assert calls == [0, N // 4, N // 2]


def test_one_worker_per_distinct_device():
    seen = []
    lock = threading.Lock()

    def job(tag):
        def fn():
            with lock:
                seen.append((tag, threading.current_thread().name))
            return tag
        return fn

    cpu, meta = torch.device("cpu"), torch.device("meta")
    jobs = [(cpu, job(0)), (meta, job(1)), (cpu, job(2)), (meta, job(3))]
    assert sharding._run(jobs) == [0, 1, 2, 3]
    names = dict(seen)
    assert names[0] == names[2] != names[1] == names[3]
    assert names[0] != threading.current_thread().name
    order = [t for t, _ in seen]
    assert order.index(0) < order.index(2) and order.index(1) < order.index(3)


def test_replicate(scenes):
    scene, res = scenes["city"]
    # on its device already: the same objects
    same = sharding.replicate(scene, res, "cpu")
    assert same[0] is scene and same[1] is res
    rs, rr = sharding.replicate(scene, res, "meta")
    assert rs is not scene and rs.multi is None
    assert rs.device == torch.device("meta") and rs.kleaf.is_meta
    assert rs.inst_kblas == scene.inst_kblas
    assert rr["camera"]["z"].is_meta and rr["vertex_data"].is_meta
    assert rr["sampler"] is res["sampler"]
    assert all(t.is_meta for e in (rs.kblas or ()) for t in e)
    # cached per (scene, device) ...
    assert sharding.replicate(scene, res, "meta")[0] is rs
    # ... and copied anew after an in-place update of the source
    scene.inst_transform.add_(0.0)
    assert sharding.replicate(scene, res, "meta")[0] is not rs


def test_replicate_kblas_tuples(scenes):
    scene, res = scenes["cornell"]
    assert scene.kblas is not None
    rs, _ = sharding.replicate(scene, res, "meta")
    assert len(rs.kblas) == len(scene.kblas)
    assert all(t.is_meta and t.shape == s.shape
               for e, es in zip(rs.kblas, scene.kblas)
               for t, s in zip(e, es))


def test_launch_counts_under_threads():
    """count_launch from more threads than cores with a short switch
    interval: no increment is lost."""
    def fake():
        pass
    fake.launches = 0
    fake.forms = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                cuda_build.count_launch(fake)
                cuda_build.count_launch(fake, "forms", key="closest")
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fake.launches == 16 * 2000 and fake.forms == {"closest": 32000}

