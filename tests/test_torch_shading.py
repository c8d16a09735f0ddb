"""radiance_tpu_torch shading and image ops vs radiance_tpu's.

Camera rays, PBR evaluation and sampling, tonemapping (u8 quantization
bit-exact), texture sampling in every addressing/filter mode, and the
compaction permutations, each on the same numpy inputs.  Float results
agree within 1e-5 (transcendentals differ by an ulp between the two
libraries); integer results exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiance_tpu import config
from radiance_tpu.ops import compaction as jcomp
from radiance_tpu.ops import texture as jtex
from radiance_tpu.ops import tonemap as jtone
from radiance_tpu.shading import camera as jcam
from radiance_tpu.shading import pbr as jpbr

from radiance_tpu_torch.ops import compaction as tcomp
from radiance_tpu_torch.ops import texture as ttex
from radiance_tpu_torch.ops import tonemap as ttone
from radiance_tpu_torch.shading import camera as tcam
from radiance_tpu_torch.shading import pbr as tpbr


def _close(got, ref, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("f_stop", [0.0, 2.8])
def test_camera_rays(f_stop):
    w, h = 24, 16
    fields = dict(width_pixel=w, height_pixel=h, focal_length=0.035,
                  sensor_width=0.05, focal_distance=8.0, f_stop=f_stop,
                  x=0.5, y=-0.25, z=4.0, wx=0.1, wy=-0.2, wz=0.05)

    class Cam:
        pass

    cam = Cam()
    cam.__dict__.update(fields)
    n = w * h
    pix = np.arange(n, dtype=np.int32)
    rnd = np.stack([np.full(n, 7, np.uint32), np.full(n, 3, np.uint32),
                    pix.astype(np.uint32)], -1)
    jo, jd = jcam.generate_rays(jcam.camera_params(cam), jnp.asarray(pix),
                                jnp.asarray(rnd))
    to, td = tcam.generate_rays(tcam.camera_params(cam, "cpu"),
                                torch.from_numpy(pix.astype(np.int64)),
                                torch.from_numpy(rnd.astype(np.int64)))
    _close(to, jo)
    _close(td, jd)


def _material_inputs(seed=0, n=512):
    rng = np.random.default_rng(seed)
    nrm = _unit(rng, n)
    v = _unit(rng, n)
    v = np.where((np.sum(v * nrm, -1) < 0)[:, None], -v, v)
    return dict(
        v=v, n=nrm, l=_unit(rng, n),
        albedo=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        metallic=rng.uniform(0, 1, n).astype(np.float32),
        roughness=rng.uniform(0.05, 1, n).astype(np.float32),
        transmission=(rng.uniform(0, 1, n) < 0.3).astype(np.float32),
        ior=rng.uniform(1.0, 2.0, n).astype(np.float32),
        random=rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _both(fn_name, names, inp):
    ref = getattr(jpbr, fn_name)(*(jnp.asarray(inp[k]) for k in names))
    got = getattr(tpbr, fn_name)(*(torch.from_numpy(inp[k]) for k in names))
    return ref, got


def test_pbr_eval():
    inp = _material_inputs()
    ref, got = _both("microfacet_brdf", ["l", "v", "n", "albedo", "metallic",
                                         "roughness", "transmission", "ior"],
                     inp)
    _close(got, ref, atol=1e-4)
    ref, got = _both("brdf", ["l", "v", "n", "metallic", "roughness",
                              "albedo"], inp)
    _close(got, ref, atol=1e-4)


@pytest.mark.parametrize("sampler", ["sample_microfacet_brdf_transm",
                                     "sample_microfacet_brdf"])
def test_pbr_sampling(sampler):
    inp = _material_inputs(seed=1)
    names = (["v", "n", "albedo", "metallic", "roughness", "transmission",
              "ior", "random"] if sampler.endswith("transm") else
             ["v", "n", "albedo", "metallic", "roughness", "random"])
    (jl, jf), (tl, tf) = _both(sampler, names, inp)
    ok = np.isfinite(np.asarray(jl)).all(-1) & np.isfinite(
        np.asarray(jf)).all(-1)
    assert ok.mean() > 0.95
    np.testing.assert_allclose(tl.numpy()[ok], np.asarray(jl)[ok],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tf.numpy()[ok], np.asarray(jf)[ok],
                               rtol=1e-4, atol=1e-4)


def test_tonemap_and_quantize():
    rng = np.random.default_rng(3)
    rgb = rng.uniform(-0.5, 4.0, (4096, 3)).astype(np.float32)
    rgb[:3] = [[0.0, 1.0, 255.0 / 255.0], [np.inf, -np.inf, 0.5], [1e-8] * 3]
    # quantization alone: bit-exact on the same floats
    q_ref = np.asarray(jtone.quantize_rgba8(jnp.asarray(rgb)))
    q_got = ttone.quantize_rgba8(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(q_got, q_ref)
    for name in ("tonemap_sample1", "tonemap_sample2", "aces_approx",
                 "uncharted2_filmic", "reinhard"):
        x = rgb[3:]
        _close(getattr(ttone, name)(torch.from_numpy(x)),
               getattr(jtone, name)(jnp.asarray(x)))
    # the full tonemap -> u8 path agrees except where pow lands an ulp
    # across a quantization step
    t_ref = np.asarray(jtone.quantize_rgba8(
        jtone.tonemap_sample1(jnp.asarray(rgb[3:]))))
    t_got = ttone.quantize_rgba8(
        ttone.tonemap_sample1(torch.from_numpy(rgb[3:]))).numpy()
    assert np.abs(t_got.astype(int) - t_ref.astype(int)).max() <= 1
    assert (t_got == t_ref).mean() > 0.999


@pytest.mark.parametrize("addressing", [config.ADDRESS_CLAMP_TO_EDGE,
                                        config.ADDRESS_CLAMP,
                                        config.ADDRESS_REPEAT,
                                        config.ADDRESS_MIRRORED_REPEAT])
@pytest.mark.parametrize("filt", [config.FILTER_NEAREST, config.FILTER_LINEAR])
def test_texture_sampling(addressing, filt):
    rng = np.random.default_rng(addressing * 2 + filt)
    tex = rng.integers(0, 256, (3, 7, 5, 4), dtype=np.uint8)
    u = rng.uniform(-1.5, 2.5, 300).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, 300).astype(np.float32)
    layer = rng.integers(-1, 4, 300).astype(np.int32)
    ref = jtex.sample_image_array(jnp.asarray(tex), jnp.asarray(u),
                                  jnp.asarray(v), jnp.asarray(layer),
                                  addressing=addressing, filter_mode=filt)
    got = ttex.sample_image_array(torch.from_numpy(tex), torch.from_numpy(u),
                                  torch.from_numpy(v), torch.from_numpy(layer),
                                  addressing=addressing, filter_mode=filt)
    _close(got, ref, atol=1e-3)


def test_compaction():
    rng = np.random.default_rng(5)
    mask = rng.uniform(size=1000) < 0.4
    jp, jn = jcomp.compact_mask(jnp.asarray(mask))
    tp, tn = tcomp.compact_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert int(tn) == int(jn)
    perm = rng.permutation(1000).astype(np.int32)
    np.testing.assert_array_equal(
        tcomp.invert_perm(torch.from_numpy(perm)).numpy(),
        np.asarray(jcomp.invert_perm(jnp.asarray(perm))))
    keys = rng.integers(0, 5, 1000).astype(np.int32)
    jperm, jsorted = jcomp.sort_by_key(jnp.asarray(keys))
    tperm, tsorted = tcomp.sort_by_key(torch.from_numpy(keys))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(
        tcomp.segment_bounds(tsorted, 5).numpy(),
        np.asarray(jcomp.segment_bounds(jsorted, 5)))


@pytest.mark.parametrize("debug", list(range(18)))
def test_material_shader_matches_jax(debug):
    """The built-in closest-hit shader, every debug mode (0 = shaded),
    on the same hits over the Cornell box's bindings; the occlusion
    query is a fixed mask handed to both."""
    from radiance_tpu.engine import context as jctx
    from radiance_tpu.engine import shaders as jsh
    from radiance_tpu.scene import procedural as jproc
    from radiance_tpu_torch.engine import context as tctx
    from radiance_tpu_torch.engine import shaders as tsh
    from radiance_tpu_torch.scene import procedural as tproc

    rng = np.random.default_rng(100 + debug)
    n = 256
    b = rng.uniform(0, 0.5, (n, 2)).astype(np.float32)
    inp = dict(
        hit=np.ones(n, bool),
        t=rng.uniform(1, 5, n).astype(np.float32),
        prim=rng.integers(0, 2, n).astype(np.int32),
        instance_id=rng.integers(0, 7, n).astype(np.int32),
        custom_id=np.zeros(n, np.int32), sbt_offset=np.zeros(n, np.int32),
        bary=np.stack([1 - b[:, 0] - b[:, 1], b[:, 0], b[:, 1]], -1),
        hit_point=rng.uniform(-4, 4, (n, 3)).astype(np.float32),
        transform=np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)),
        ray_origin=np.tile(np.float32([0, 0, 4]), (n, 1)),
        ray_dir=_unit(rng, n), pixel_index=np.arange(n, dtype=np.int32))
    occluded = rng.uniform(size=n) < 0.4

    jres = jproc.cornell_box().resources
    jc = jctx.ShadeContext(
        **{k: jnp.asarray(v) for k, v in inp.items()},
        frame_id=jnp.uint32(3), depth=jnp.int32(1), active=None,
        resources=jres, debug=debug,
        trace_occlusion=lambda *a, **k: jnp.asarray(occluded))
    zeros = np.zeros((n, 3), np.float32)
    jp = jsh.material(jc, jctx.Payload(
        color=jnp.asarray(zeros), hit=jnp.zeros(n, bool),
        next_factor=jnp.ones((n, 3)), next_origin=jnp.asarray(zeros),
        next_dir=jnp.asarray(zeros)))

    tres = tproc.cornell_box(device="cpu").resources
    tc = tctx.ShadeContext(
        **{k: torch.from_numpy(v) for k, v in inp.items()},
        frame_id=3, depth=1, resources=tres, debug=debug,
        trace_occlusion=lambda *a, **k: torch.from_numpy(occluded))
    tp = tsh.material(tc, tctx.Payload(
        color=torch.zeros(n, 3), hit=torch.zeros(n, dtype=torch.bool),
        next_factor=torch.ones(n, 3), next_origin=torch.zeros(n, 3),
        next_dir=torch.zeros(n, 3)))

    for field in ("color", "next_origin", "next_dir", "next_factor"):
        ref = np.asarray(getattr(jp, field))
        got = getattr(tp, field).numpy()
        ok = np.isfinite(ref).all(-1)
        assert ok.mean() > 0.95, field
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-4, atol=1e-4,
                                   err_msg=field)
    assert tp.hit.all()
