"""radiance_tpu_torch's stream3 pipeline end to end vs radiance_tpu's.

trace_rows_stream3 of the port (plain versions of its kernels on the
CPU) against the JAX entry with its Pallas kernels in interpret mode, or
against the JAX per-ray traversal walk as an exact oracle, and the port
engine's primary route.  Scenes and rays as in test_torch_stream3.py
(each package builds its own scene from the same mesh).

Bar: hit agreement >= 0.999, prim agreement >= 0.999 on rays both hit,
t rtol 1e-5 atol 1e-6 there (the leaf products sum their terms in
another order than the JAX kernel's).
"""

import numpy as np
import torch

import jax.numpy as jnp

from radiance_tpu.ops import stream3 as js3
from radiance_tpu.ops import traversal
from radiance_tpu.ops.intersect import FLT_MAX

from radiance_tpu_torch.api.sbt import ShaderBindingTable
from radiance_tpu_torch.core import types as ttypes
from radiance_tpu_torch.engine import shaders
from radiance_tpu_torch.engine.pathtracer import WavefrontPathTracer
from radiance_tpu_torch.ops import stream3 as ts3
from radiance_tpu_torch.scene import procedural
from radiance_tpu_torch.shading import camera

from test_bvh import random_mesh
from test_torch_stream3 import (  # noqa: F401
    TMAX, TMIN, _one_torch_thread, camera_wave, hold, jrows, mini_city_pair,
    soup_pair, trows)
from test_traversal import gen_rays


def test_trace_rows_stream3_mini_city_matches_jax():
    jds, tds = mini_city_pair()
    o, d = camera_wave(4 * js3.PKT, 128, 60.0)
    ref = js3.trace_rows_stream3(jds, jrows(o, d), TMIN, 1e4,
                                 precision="f32")
    got, diag = ts3.trace_rows_stream3(tds, trows(o, d), TMIN, 1e4,
                                       with_diag=True)
    hit = hold(ref.t, ref.prim, got.t.numpy(), got.prim.numpy())
    assert hit.sum() >= 20 and diag["flagged"] == 0  # tiny triangles
    assert (got.slot.numpy() == np.where(hit, 0, -1)).all()


def test_trace_rows_stream3_live_mask_matches_jax():
    """A mixed wave with half its lanes dead, NaN in the dead lanes of
    the port's input: live lanes hold the bars, dead lanes miss."""
    jds, tds = soup_pair(600, 3)
    o, d = gen_rays(np.random.default_rng(9), 3000, spread=8.0)
    live = np.random.default_rng(10).uniform(size=len(o)) < 0.5
    ref = js3.trace_rows_stream3(jds, jrows(o, d), TMIN, TMAX,
                                 precision="f32", live=jnp.asarray(live))
    o_bad, d_bad = o.copy(), d.copy()
    o_bad[~live] = np.inf
    d_bad[~live] = np.nan
    got = ts3.trace_rows_stream3(tds, trows(o_bad, d_bad), TMIN, TMAX,
                                 live=torch.from_numpy(live))
    hold(np.asarray(ref.t)[live], np.asarray(ref.prim)[live],
         got.t.numpy()[live], got.prim.numpy()[live])
    assert (got.t.numpy()[~live] == np.float32(FLT_MAX)).all()
    assert (got.prim.numpy()[~live] == -1).all()


def test_forced_residual_rewalks_every_packet(monkeypatch):
    """With the walk cut after its first step window (8 node rows) every
    packet is flagged and re-traced exactly; the result still holds the
    end-to-end bar against the JAX traversal walk (an exact oracle)."""
    monkeypatch.setattr(ts3, "STEP_CAP", 1)
    jds, tds = soup_pair(900, 3)
    o, d = camera_wave(2 * js3.PKT, 64, 12.0)
    ref = traversal.trace_rays(jds, jnp.asarray(o), jnp.asarray(d), TMIN,
                               TMAX)
    got, diag = ts3.trace_rows_stream3(tds, trows(o, d), TMIN, TMAX,
                                       with_diag=True)
    # every packet of the padded wave, of which the first 2 hold rays
    assert diag["flagged"] == diag["pkt_flag"].numel() == js3.G
    assert diag["residual_rays"] == 2 * js3.PKT
    assert int(diag["capped"]) > 0
    hold(ref.t, ref.prim, got.t.numpy(), got.prim.numpy())


def test_zero_direction_rays_miss():
    _, tds = soup_pair(200, 2)
    z = torch.zeros(256, 3)
    rec = ts3.trace_rays_stream3(tds, z, z, TMIN, TMAX)
    assert (rec.t.numpy() == np.float32(FLT_MAX)).all()
    assert (rec.prim.numpy() == -1).all()


def test_engine_primary_wave_takes_stream3(monkeypatch):
    """On a single-instance scene the port's engine traces each primary
    wave (and only it) through trace_rows_stream3, live-masked."""
    calls = []
    real = ts3.trace_rows_stream3

    def spy(scene, rows, tmin, tmax, live=None, **kw):
        calls.append(None if live is None else int(live.sum()))
        return real(scene, rows, tmin, tmax, live=live, **kw)

    monkeypatch.setattr(ts3, "trace_rows_stream3", spy)
    m = random_mesh(np.random.default_rng(9), 600, spread=5.0)
    host = procedural.assemble_scene(
        [(m.vertices, m.triangles, np.tile([[0, 0, 1.0]],
                                           (len(m.vertices), 1))
          .astype(np.float32), np.zeros_like(m.vertices), 0)],
        [ttypes.Material()], ttypes.SceneProperties(lights=[
            ttypes.DirLight(direction=(0.3, -1.0, -0.4, 0.0))]),
        device="cpu")
    scene = host.device_scene("cpu")
    assert ts3.supports(scene)
    w = 24
    res = dict(host.resources)
    res["camera"] = camera.camera_params(ttypes.PhysicalCamera(
        width_pixel=float(w), height_pixel=float(w), focal_length=0.035,
        sensor_width=0.05, focal_distance=8.0, z=20.0), "cpu")
    tracer = WavefrontPathTracer(
        ray_generator=camera.physical_camera_raygen,
        sbt=ShaderBindingTable.from_json(shaders.DEFAULT_SBT_RECORDS,
                                         shaders.SHADER_REGISTRY))
    acc, img = tracer.render(scene, res, torch.zeros(w * w, 3), 0, w, w,
                             batch=2, depth=2)
    assert calls == [w * w, w * w]          # one per sample, all lanes live
    assert torch.isfinite(acc).all() and img[..., :3].float().std() > 1.0
