"""WavefrontPathTracer.frame_fn and its sample_sum hook on the port.

render is frame_fn over arange(N), so the two must agree bit for bit
(the Cornell box: per-instance sweeps; a 20k-triangle cut of the bench's
city: the stream3 primary, live-masked shadows, argsorted bounces, and
its tbound frames).  sample_sum over a pixel subset equals those rows of
the full sum, and consecutive frame-id ranges add up to the longer
range's sum.  The per-frame routes keyword reaches each wave (primary,
its shadows, bounces, their shadows) and equals the tracer's route
fields where those can say the same.  Port against port: the JAX
engine's frame_fn is held through its sharded functions in
test_torch_sharding_jax.py.
"""

import dataclasses

import pytest
import torch

from radiance_tpu_torch.engine import pathtracer

from test_torch_engine import (  # noqa: F401
    _cornell, _city, _one_torch_thread, tracers)

W = H = 32
N = W * H


@pytest.fixture(scope="module")
def tracer(tracers):  # noqa: F811
    return tracers[1]


@pytest.fixture(scope="module")
def cornell():
    return _cornell(W, H)[1]


@pytest.fixture(scope="module")
def city():
    return _city(W, H)[1]


@pytest.fixture(scope="module")
def city_full_sum(tracer, city):
    frame = tracer.frame_fn(batch=2, depth=2)
    return frame.sample_sum(*city, torch.arange(N), 0, 0)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("which", ["cornell", "city"])
def test_frame_fn_equals_render(request, tracer, which):
    scene, res = request.getfixturevalue(which)
    acc0 = torch.rand(N, 3, generator=torch.Generator().manual_seed(1))
    frame = tracer.frame_fn(batch=2, depth=2)
    for ts in (0, 3):
        acc_r, img_r = tracer.render(scene, res, acc0, ts, W, H, batch=2,
                                     depth=2)
        acc_f, img_f = frame(scene, res, acc0, ts,
                             torch.arange(N, dtype=torch.int64))
        assert torch.equal(acc_f, acc_r)
        assert torch.equal(img_f.reshape(H, W, 4), img_r)
        assert img_r[..., :3].float().std() > 1.0


def test_frame_fn_tbound_equals_bounded_render(tracer, city):
    bounded = dataclasses.replace(tracer, tbound=True)
    frame = tracer.frame_fn(batch=2, depth=2, tbound=True)
    acc_r, img_r = bounded.render(*city, torch.zeros(N, 3), 0, W, H,
                                  batch=2, depth=2)
    acc_f, img_f, tb = frame(*city, torch.zeros(N, 3), 0, torch.arange(N))
    assert torch.equal(acc_f, acc_r) and torch.equal(img_f.reshape(H, W, 4),
                                                     img_r)
    (_, (_, stored)), = bounded._tb_store.items()
    assert torch.equal(tb, stored) and tb.shape == (-(-N // 128),)
    # the stored bounds carry into the next frame as tb does
    acc_r2, _ = bounded.render(*city, acc_r, 2, W, H, batch=2, depth=2)
    acc_f2, _, _ = frame(*city, acc_f, 2, torch.arange(N), tb)
    assert torch.equal(acc_f2, acc_r2)


def test_sample_sum_subset_equals_rows(tracer, city, city_full_sum):
    frame = tracer.frame_fn(batch=2, depth=2)
    # a 100-pixel subset in random order: other packets, other waves
    sub = torch.randperm(N, generator=torch.Generator().manual_seed(0))[:100]
    part = frame.sample_sum(*city, sub, 0, 0)
    assert part.shape == (100, 3)
    torch.testing.assert_close(part, city_full_sum[sub], rtol=1e-5,
                               atol=1e-6)


def test_sample_sum_frame_id_ranges_add_up(tracer, city, city_full_sum):
    one = tracer.frame_fn(batch=1, depth=2)
    pix = torch.arange(N)
    first = one.sample_sum(*city, pix, 0, 0)
    second = one.sample_sum(*city, pix, 1, 0)
    assert torch.equal(first + second, city_full_sum)
    # total_samples0 seeds the rays too: another value, another sample
    assert not torch.equal(one.sample_sum(*city, pix, 1, 1), second)


def test_routes_keyword_equals_route_fields(tracer, city):
    frame = tracer.frame_fn(batch=1, depth=2,
                            routes=("gen1_sort", "gen1_sort", "gen1_sort"))
    fields = dataclasses.replace(tracer, primary_route="gen1_sort",
                                 bounce_route="gen1_sort",
                                 shadow_route="gen1_sort")
    got = frame(*city, torch.zeros(N, 3), 0, torch.arange(N))
    want = fields.render(*city, torch.zeros(N, 3), 0, W, H, batch=1, depth=2)
    assert torch.equal(got[0], want[0])
    four = tracer.frame_fn(batch=1, depth=2, routes=(
        "gen1_sort", "gen1_sort", "gen1_sort", "gen1_sort"))
    assert _equal(four(*city, torch.zeros(N, 3), 0, torch.arange(N)), got)


def test_routes_reach_each_wave(monkeypatch, tracer, cornell, city):
    seen = []
    orig = pathtracer._traced_wavefront

    def spy(*a, route, any_hit_terminate=False, **k):
        seen.append(("shadow" if any_hit_terminate else "closest", route))
        return orig(*a, route=route, any_hit_terminate=any_hit_terminate,
                    **k)

    monkeypatch.setattr(pathtracer, "_traced_wavefront", spy)
    # the closed box: every wave hits, so every wave traces shadows (the
    # spy sees the route asked for; the box's instances then take argsort)
    frame = tracer.frame_fn(batch=1, depth=2, routes=(
        "stream3", "gen1_sort", "stream3", "gen1_live"))
    frame(*cornell, torch.zeros(N, 3), 0, torch.arange(N))
    assert seen == [("closest", "stream3"), ("shadow", "stream3"),
                    ("closest", "gen1_sort"), ("shadow", "gen1_live")]
    seen.clear()
    # None entries and routes=None: the staged defaults of a
    # single-instance scene with kernel tables (the city cut's bounces
    # may hit nothing, and then trace no shadow)
    tracer.frame_fn(batch=1, depth=2, routes=(None, None, None))(
        *city, torch.zeros(N, 3), 0, torch.arange(N))
    defaults = list(seen)
    seen.clear()
    tracer.frame_fn(batch=1, depth=2)(*city, torch.zeros(N, 3), 0,
                                      torch.arange(N))
    assert seen == defaults
    assert defaults[:3] == [("closest", "stream3"), ("shadow", "gen1_live"),
                            ("closest", "argsort")]
    assert defaults[3:] in ([], [("shadow", "argsort")])


@pytest.mark.parametrize("routes", [("stream3", "argsort"),
                                    ("stream3", "bogus", "argsort")])
def test_bad_routes_raise(tracer, cornell, routes):
    frame = tracer.frame_fn(batch=1, depth=1, routes=routes)
    with pytest.raises(ValueError, match="route"):
        frame(*cornell, torch.zeros(N, 3), 0, torch.arange(N))
