"""radiance_tpu_torch's engine wave routes vs radiance_tpu's: "gen1_sort",
"xla" and "stream3" on shadow waves, and the tracer's route fields.

The JAX engine degrades explicit "gen1_sort" and "stream3" routes to
"argsort" off the TPU (reference pathtracer.py:194-207), so each port
wave is held against the JAX composition written out by hand: for
"gen1_sort" reorder.coherence_perm, the live-masked packet kernel in
interpret mode and the inverse gather (as tests/test_reorder.py does);
for a stream3 shadow wave trace_rows_stream3(occl=True) in interpret
mode; "xla" runs on JAX's CPU route as it is.  The images of each route
are held against the JAX engine's staged frame.

Bars: closest-hit waves test_torch_packet_trace.py's (hit and prim
agreement >= 0.999, t rtol 1e-5, barycentrics 1e-4); shadow waves
occluded-or-not agreement >= 0.999 on live lanes, dead lanes a miss;
images the golden tests' u8 RMSE < 2.0 at depth 1, < 3.0 at depth 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu.engine import pathtracer as jpt
from radiance_tpu.ops import packet_trace as jpk
from radiance_tpu.ops import reorder as jre
from radiance_tpu.ops import stream3 as js3
from radiance_tpu.ops import traversal as jtrav

from radiance_tpu_torch.engine import pathtracer as tpt
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.ops.intersect import FLT_MAX

from test_torch_engine import (  # noqa: F401
    RMSE_BAR, _city, _one_torch_thread, tracers)
from test_torch_packet_trace import (TMAX, TMIN, compare, single_scene,
                                     torch_scene)
from test_traversal import gen_rays

# the reference's RADIANCE_ENGINE_STREAM3 and RADIANCE_GEN1_SORT=1: one
# route on every wave
ROUTE_FIELDS = ("primary_route", "bounce_route", "shadow_route")


def _wave(n, seed):
    o, d = gen_rays(np.random.default_rng(seed), n, spread=8.0)
    live = np.random.default_rng(seed + 1).uniform(size=n) < 0.6
    return o, d, live


def _port(tds, o, d, live, route, **kw):
    return tpt._traced_wavefront(tds, torch.from_numpy(o),
                                 torch.from_numpy(d), TMIN, TMAX,
                                 torch.from_numpy(live), route=route, **kw)


def _masked(rec, live):
    miss = ~jnp.asarray(live)
    return jtrav.HitRecord(t=jnp.where(miss, FLT_MAX, rec.t),
                           prim=jnp.where(miss, -1, rec.prim),
                           slot=jnp.where(miss, -1, rec.slot),
                           b1=jnp.where(miss, 0.0, rec.b1),
                           b2=jnp.where(miss, 0.0, rec.b2))


@pytest.mark.parametrize("any_hit", [False, True])
def test_gen1_sort_wave_matches_jax_composition(any_hit):
    """The "gen1_sort" route against reorder.coherence_perm, the JAX
    packet kernel (interpret mode, live-masked) and the inverse gather;
    the port's permutation equals JAX's."""
    jds = single_scene(n_tris=400, seed=21)
    tds = torch_scene(jds)
    o, d, live = _wave(3000, 5)
    perm, inv = jre.coherence_perm(jnp.asarray(d), jnp.asarray(live))
    rec = jpk.trace_rays_packet(jds, jnp.asarray(o)[perm],
                                jnp.asarray(d)[perm], jnp.float32(TMIN),
                                jnp.float32(TMAX), any_hit=any_hit,
                                live=jnp.asarray(live)[perm], interpret=True)
    ref = _masked(jtrav.HitRecord(*(getattr(rec, f)[inv] for f in (
        "t", "prim", "slot", "b1", "b2"))), live)
    got = _port(tds, o, d, live, "gen1_sort", any_hit_terminate=any_hit)
    assert (got.t.numpy()[~live] == np.float32(FLT_MAX)).all()
    if any_hit:
        occ = np.asarray(ref.t) < FLT_MAX
        assert (occ == got.hit.numpy())[live].mean() >= 0.999
        assert occ[live].any()
    else:
        assert compare(ref, got)[live].mean() > 0.05
    # the same hits as the port's argsort route
    base = _port(tds, o, d, live, "argsort", any_hit_terminate=any_hit)
    assert torch.equal(got.hit, base.hit)


def test_xla_route_matches_jax():
    """The "xla" route (dead lanes parked, the two-level walk) against the
    JAX engine's own "xla" route, closest hit and occlusion."""
    jds = single_scene(n_tris=300, seed=22)
    tds = torch_scene(jds)
    o, d, live = _wave(1500, 7)
    ref = jpt._traced_wavefront(jds, jnp.asarray(o), jnp.asarray(d),
                                TMIN, TMAX, jnp.asarray(live), route="xla")
    got = _port(tds, o, d, live, "xla")
    assert compare(ref, got)[live].mean() > 0.05
    assert (got.t.numpy()[~live] == np.float32(FLT_MAX)).all()
    ref = jpt._traced_wavefront(jds, jnp.asarray(o), jnp.asarray(d),
                                TMIN, TMAX, jnp.asarray(live), route="xla",
                                any_hit_terminate=True)
    got = _port(tds, o, d, live, "xla", any_hit_terminate=True)
    assert ((np.asarray(ref.t) < FLT_MAX) == got.hit.numpy()).mean() >= 0.999


def test_stream3_shadow_wave_matches_jax_composition():
    """A shadow wave on the "stream3" route (trace_rows_stream3 with occl,
    live-masked, NaN in dead lanes) against the JAX stream3 occlusion wave
    in interpret mode, and the port's "gen1_live" shadow wave."""
    jds = single_scene(n_tris=600, seed=23)
    tds = torch_scene(jds)
    o, d, live = _wave(4096, 9)
    ref = js3.trace_rows_stream3(jds, js3.rows_from_aos(jnp.asarray(o),
                                                        jnp.asarray(d)),
                                 TMIN, TMAX, precision="f32",
                                 live=jnp.asarray(live), occl=True)
    o_bad, d_bad = o.copy(), d.copy()
    o_bad[~live] = np.inf
    d_bad[~live] = np.nan
    got = _port(tds, o_bad, d_bad, live, "stream3", any_hit_terminate=True)
    occ = np.asarray(ref.t) < FLT_MAX
    assert (occ == got.hit.numpy())[live].mean() >= 0.999
    assert 0.05 < occ[live].mean() < 0.95
    assert not got.hit.numpy()[~live].any()
    assert (got.slot.numpy() >= -1).all()
    g1 = _port(tds, o, d, live, "gen1_live", any_hit_terminate=True)
    assert (g1.hit == got.hit).float().mean() >= 0.999


def test_wave_route_fields(monkeypatch, tracers):  # noqa: F811
    """wave_route's choice (the wave's field, else the staged default),
    its refusal of an unknown route, and the routes render hands
    _traced_wavefront on the city."""
    _, tt = tracers
    t = tpt.WavefrontPathTracer(ray_generator=tt.ray_generator, sbt=tt.sbt)
    assert t.wave_route("bounce", "argsort") == "argsort"
    t.bounce_route = "gen1_sort"
    assert t.wave_route("bounce", "argsort") == "gen1_sort"
    assert t.wave_route("primary", "stream3") == "stream3"
    t.shadow_route = "xla"
    assert t.wave_route("shadow", "gen1_live") == "xla"
    t.bounce_route = "sorted"
    with pytest.raises(ValueError):
        t.wave_route("bounce", "argsort")
    with pytest.raises(ValueError):
        tpt._traced_wavefront(None, None, None, TMIN, TMAX, None,
                              route="sorted")

    seen = []
    real = tpt._traced_wavefront

    def spy(*a, route, any_hit_terminate=False, **kw):
        seen.append((route, any_hit_terminate))
        return real(*a, route=route, any_hit_terminate=any_hit_terminate,
                    **kw)

    monkeypatch.setattr(tpt, "_traced_wavefront", spy)
    _, (tds, tres) = _city(16, 16)
    t = tpt.WavefrontPathTracer(ray_generator=tt.ray_generator, sbt=tt.sbt,
                                bounce_route="gen1_sort",
                                shadow_route="stream3")
    t.render(tds, tres, torch.zeros(256, 3), 0, 16, 16, batch=1, depth=2)
    assert seen[0] == ("stream3", False) and ("gen1_sort", False) in seen
    assert {r for r, occl in seen if occl} == {"stream3"}


@pytest.fixture(scope="module")
def city():
    return _city(64, 64)


@pytest.fixture(scope="module")
def jax_frames(city, tracers):  # noqa: F811
    """The JAX engine's staged frames of the city at depth 1 and 2."""
    (jds, jres), _ = city
    jt, _ = tracers
    mp = pytest.MonkeyPatch()
    mp.setenv("RADIANCE_ENGINE_STAGED", "1")
    try:
        return {depth: np.asarray(jt.render(
            jds, jres, jnp.zeros((4096, 3), jnp.float32), 0, 64, 64,
            batch=2, depth=depth)[1])[..., :3].astype(np.float64)
            for depth in (1, 2)}
    finally:
        mp.undo()


@pytest.mark.parametrize("fields,depth", [
    (dict(bounce_route="gen1_sort", shadow_route="gen1_sort"), 1),
    (dict(bounce_route="gen1_sort", shadow_route="gen1_sort"), 2),
    (dict.fromkeys(ROUTE_FIELDS, "gen1_sort"), 2),
    (dict(bounce_route="xla"), 2),
    (dict(shadow_route="stream3"), 1),
    (dict.fromkeys(ROUTE_FIELDS, "stream3"), 2),
], ids=["gen1_sort-d1", "gen1_sort-d2", "gen1_sort_all-d2", "xla-d2",
        "stream3_shadow-d1", "stream3_all-d2"])
def test_route_images_match_jax(city, tracers, jax_frames,  # noqa: F811
                                fields, depth):
    """64x64 city frames (batch 2) with the routes set by the tracer's
    fields against the JAX engine's staged frame."""
    _, (tds, tres) = city
    _, tt = tracers
    t = tpt.WavefrontPathTracer(ray_generator=tt.ray_generator, sbt=tt.sbt,
                                **fields)
    acc, img = t.render(tds, tres, torch.zeros(4096, 3), 0, 64, 64, batch=2,
                        depth=depth)
    assert torch.isfinite(acc).all()
    got = img.numpy()[..., :3].astype(np.float64)
    assert got.std() > 1.0
    rmse = float(np.sqrt(np.mean((got - jax_frames[depth]) ** 2)))
    assert rmse < RMSE_BAR[depth], rmse
    assert ts3.supports(tds)
