"""The fused material wave (shading/material_cuda.py, csrc/shade_material.cu)
against the SBT path it replaces, on the card, on the same inputs.

One engine wave (engine/pathtracer._sample_step) at depth 0 and at a later
bounce is run twice from the same path state: by the fused kernels and by
the SBT path (the tracer's route rule switched off), the state of the
earlier waves made by the SBT path.  Scenes: a single-mesh interior-like
hall, the Cornell box (7 instances), three transformed boxes in a room (4
instances), a textured scene (albedo, normal and metallic-roughness maps)
under nearest and linear filtering and two addressing modes, a
transmission material (0.8, ior 1.45) and a metallic one; in each case
more than 2% of the lanes still shade after the wave.  Held: alive, hit
and the shadow trace's occlusion equal; the path state within the
tolerance below (next_dir is drawn from the wave's PCG3D words, so its
bit-equal lanes hold the kernel's uint32 PCG3D to rmath.pcg3d_words); a
b4 d4 frame's u8 image from the two routes equal on >= 99.9% of bytes.

Tolerance: the kernels repeat the torch path's float32 operations in its
order (the card's three-term sum order, no FMA contraction, IEEE division
and square root, the libdevice functions ATen calls), and every case here
agrees bit for bit on an H100 with torch 2.11; another torch build may
compile one of ATen's kernels otherwise and move a lane's last bits, which
a bounce amplifies through acos near 1 and the tangent frame.  So:
bit-equal on >= 99.9% of the floats, and every lane within 1e-3 relative +
1e-5 absolute.

Every case is marked `gpu` and skips where no card is present (the
fixture decides at run time).  This file imports nothing of JAX:

    python -m pytest tests/test_torch_cuda_shade.py -m gpu --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from radiance_tpu_torch import config
from radiance_tpu_torch.api.sbt import ShaderBindingTable
from radiance_tpu_torch.core import math as rmath
from radiance_tpu_torch.core import types
from radiance_tpu_torch.engine import pathtracer as pt
from radiance_tpu_torch.engine import shaders
from radiance_tpu_torch.scene import bindings, procedural
from radiance_tpu_torch.shading import camera
from radiance_tpu_torch.shading import material_cuda as mc

pytestmark = pytest.mark.gpu

W = 96
EXACT_SHARE = 0.999
CLOSE_SHARE = 1.0
RTOL, ATOL = 1e-3, 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the fused material wave runs only on the "
                    "GPU (CPU waves take the SBT path, tested in "
                    "test_torch_shade_fused.py)")
    mc.load_kernel()
    return torch.device("cuda")


def _tracer():
    sbt = ShaderBindingTable.from_json(shaders.DEFAULT_SBT_RECORDS,
                                       shaders.SHADER_REGISTRY)
    return pt.WavefrontPathTracer(
        ray_generator=camera.physical_camera_raygen, sbt=sbt)


def _plain(tracer):
    """The same tracer with the fused route switched off: the SBT path."""
    plain = dataclasses.replace(tracer)
    plain.fuses_material = lambda *a, **k: False
    return plain


def _light():
    return types.SceneProperties(lights=[types.DirLight(
        direction=(0.3, -1.0, -0.4, 0.0), color=(3.0, 3.0, 3.0, 1.0))])


def _uv_grid(verts, scale):
    return np.stack([verts[:, 0] * scale, verts[:, 1] * scale,
                     np.zeros(len(verts))], -1).astype(np.float32)


def _hall(dev, material=types.Material(albedo=(0.7, 0.7, 0.7, 1.0),
                                       roughness=0.6)):
    """A 20k-triangle cut of the interior hall (unshared vertices: one face
    normal a vertex), its camera origin."""
    verts, tris, meta = procedural.interior_hall(20_000, seed=11)
    fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                  verts[tris[:, 2]] - verts[tris[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-9)
    normals = np.repeat(fn, 3, axis=0).astype(np.float32)
    host = procedural.assemble_scene(
        [(verts, tris, normals, _uv_grid(verts, 0.1), 0)], [material],
        _light(), device=dev)
    x, y, z = meta["camera_origin"]
    return host, dict(x=float(x), y=float(y), z=float(z))


def _textured(dev, filt, addressing):
    rng = np.random.default_rng(3)
    tex = rng.integers(0, 256, (3, 17, 23, 4), dtype=np.uint8)
    mat = types.Material(albedo=(0.5, 0.5, 0.5, 1.0), roughness=0.5,
                         albedo_tex=0, normal_tex=1, metallic_tex=2,
                         roughness_tex=2)
    plain = types.Material(albedo=(0.8, 0.3, 0.2, 1.0), roughness=0.4)
    meshes = []
    for k, (c, s) in enumerate((([-2.0, 0, -6], 2.5), ([2.0, 0, -7], 3.0))):
        v, t, n, _ = procedural._box(c, [s, s, s])
        meshes.append((v, t, n, _uv_grid(v, 0.37) - 0.6, k))
    floor = procedural._quad([-9, -3, 2], [9, -3, 2], [9, -3, -14],
                             [-9, -3, -14])
    meshes.append((floor[0], floor[1], floor[2], _uv_grid(floor[0], 0.2), 0))
    host = procedural.assemble_scene(
        meshes, [mat, plain], _light(), textures=tex,
        sampler=bindings.Sampler(addressing=addressing, filter=filt),
        device=dev)
    return host, dict(z=4.0)


def _room():
    """Floor, back wall and side walls in one mesh, facing inwards."""
    quads = [procedural._quad([-8, -3, 2], [8, -3, 2], [8, -3, -14],
                              [-8, -3, -14]),
             procedural._quad([-8, -3, -14], [8, -3, -14], [8, 9, -14],
                              [-8, 9, -14]),
             procedural._quad([-8, -3, 2], [-8, -3, -14], [-8, 9, -14],
                              [-8, 9, 2]),
             procedural._quad([8, -3, -14], [8, -3, 2], [8, 9, 2],
                              [8, 9, -14])]
    v = np.concatenate([q[0] for q in quads])
    t = np.concatenate([q[1] + 4 * k for k, q in enumerate(quads)])
    n = np.concatenate([q[2] for q in quads])
    uv = np.concatenate([q[3] for q in quads])
    return v, t.astype(np.uint32), n, uv


def _instanced(dev):
    """Three transformed instances of distinct boxes (per-lane rows) in a
    translated room, so that most paths still shade at depth 2."""
    rng = np.random.default_rng(5)
    meshes, tfs = [], []
    for k in range(3):
        v, t, n, uv = procedural._box([0, 0, 0], [2.6, 3.0, 2.0])
        meshes.append((v, t, n, uv, k))
        a = rng.uniform(-0.6, 0.6, 3)
        rot = (rmath.euler_x(torch.tensor(a[0], dtype=torch.float32))
               @ rmath.euler_y(torch.tensor(a[1], dtype=torch.float32))
               ).numpy()
        rot[:3, 3] = [(k - 1) * 3.0, 0.3 * k, -6.0 - k]
        tfs.append(rot.astype(np.float32))
    meshes.append(_room() + (3,))
    room = np.eye(4, dtype=np.float32)
    room[:3, 3] = [0.2, -0.1, 0.3]
    tfs.append(room)
    mats = [types.Material(albedo=(0.9, 0.4, 0.2, 1.0), roughness=0.3),
            types.Material(albedo=(0.2, 0.7, 0.3, 1.0), roughness=0.8,
                           metallic=0.5),
            types.Material(albedo=(0.6, 0.6, 0.9, 1.0), roughness=0.2,
                           transmission=0.8, ior=1.45),
            types.Material(albedo=(0.75, 0.75, 0.7, 1.0), roughness=0.9)]
    host = procedural.assemble_scene(meshes, mats, _light(), transforms=tfs,
                                     device=dev)
    return host, dict(z=4.0)


SCENES = {
    "hall": lambda dev: _hall(dev),
    "cornell": lambda dev: (procedural.cornell_box(device=dev), dict(z=4.0)),
    "instanced": _instanced,
    "tex_nearest_repeat": lambda dev: _textured(
        dev, config.FILTER_NEAREST, config.ADDRESS_REPEAT),
    "tex_linear_mirrored": lambda dev: _textured(
        dev, config.FILTER_LINEAR, config.ADDRESS_MIRRORED_REPEAT),
    "tex_linear_clamp": lambda dev: _textured(
        dev, config.FILTER_LINEAR, config.ADDRESS_CLAMP),
    "transmission": lambda dev: _hall(dev, types.Material(
        albedo=(0.9, 0.9, 0.9, 1.0), roughness=0.3, transmission=0.8,
        ior=1.45)),
    "metallic": lambda dev: _hall(dev, types.Material(
        albedo=(0.95, 0.8, 0.5, 1.0), roughness=0.25, metallic=1.0)),
}


def _inputs(name, dev):
    host, eye = SCENES[name](dev)
    res = dict(host.resources)
    cam = types.PhysicalCamera(width_pixel=float(W), height_pixel=float(W),
                               focal_length=0.035, sensor_width=0.05,
                               focal_distance=8.0, **eye)
    res["camera"] = camera.camera_params(cam, dev)
    return host.device_scene(dev), res


def _step(tracer, scene, res, pixel, fid, b, state):
    primary, p_shadow, bounce, b_shadow = tracer._routes(scene, None)
    return pt._sample_step(
        tracer, scene, res, pixel, fid, b, state, debug=0,
        hit_offset=tracer.hit_offset, miss_index=tracer.miss_index,
        route=primary if b == 0 else bounce,
        shadow_route=p_shadow if b == 0 else b_shadow)


def _trace_spy(monkeypatch):
    """Record the hit mask of every closest-hit and every occlusion wave:
    {"closest": [...], "occluded": [...]}."""
    seen = {"closest": [], "occluded": []}
    real = pt._traced_wavefront

    def spy(*a, **k):
        rec = real(*a, **k)
        kind = "occluded" if k.get("any_hit_terminate") else "closest"
        seen[kind].append(rec.hit.clone())
        return rec
    monkeypatch.setattr(pt, "_traced_wavefront", spy)
    return seen


def _share(mask):
    """The share of True in `mask`, from exact counts (a float32 mean can
    round an all-True mask below 1)."""
    return int(mask.sum()) / mask.numel()


def _close(got, ref):
    """(share of floats bit-equal, share of lanes within the tolerance)."""
    exact = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    ok = torch.isclose(got, ref, rtol=RTOL, atol=ATOL, equal_nan=True)
    return _share(exact), _share(ok.reshape(ok.shape[0], -1).all(dim=1))


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("name", list(SCENES))
def test_fused_wave_matches_sbt_path(cuda, monkeypatch, name, depth):
    scene, res = _inputs(name, cuda)
    tracer = _tracer()
    plain = _plain(tracer)
    assert tracer.fuses_material(scene, tracer.hit_offset,
                                 tracer.miss_index, 0)
    n = W * W
    pixel = torch.arange(n, dtype=torch.int64, device=cuda)
    fid = 5
    state = pt._sample_init(tracer, res, pixel, fid, 0)
    for b in range(depth):
        state = _step(plain, scene, res, pixel, fid, b, state)
    seen = _trace_spy(monkeypatch)
    ref = _step(plain, scene, res, pixel, fid, depth,
                tuple(x.clone() for x in state))
    before = mc.material_prep.launches, mc.material_finish.launches
    got = _step(tracer, scene, res, pixel, fid, depth,
                tuple(x.clone() for x in state))
    assert (mc.material_prep.launches, mc.material_finish.launches) == (
        before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    for kind in ("closest", "occluded"):                   # hit, occluded
        assert len(seen[kind]) == 2, kind
        assert torch.equal(seen[kind][0], seen[kind][1]), kind
    assert torch.equal(got[2], ref[2])                      # alive
    assert int(ref[2].sum()) > n // 50, "too few paths shade"
    for i, what in enumerate(("color", "contribution", "alive",
                              "next_origin", "next_dir")):
        if what == "alive":
            continue
        g, r = got[i], ref[i]
        if what.startswith("next"):     # only live paths carry a ray
            g, r = g[ref[2]], r[ref[2]]
        exact, close = _close(g, r)
        print(f"{name} depth {depth} {what}: bit-equal {exact:.6f}, "
              f"close {close:.6f}")
        assert exact >= EXACT_SHARE, (what, exact)
        assert close >= CLOSE_SHARE, (what, close)


@pytest.mark.parametrize("name", ["hall", "cornell", "tex_linear_mirrored"])
def test_fused_frame_image_matches_sbt_path(cuda, name):
    scene, res = _inputs(name, cuda)
    tracer = _tracer()
    imgs = []
    for t in (tracer, _plain(tracer)):
        _, img = t.render(scene, res, torch.zeros(W * W, 3, device=cuda), 0,
                          W, W, batch=4, depth=4)
        imgs.append(img.cpu())
    same = _share(imgs[0] == imgs[1])
    print(f"{name} b4 d4 frame: u8 bytes equal {same:.6f}")
    assert same >= 0.999
    assert imgs[0][..., :3].float().std() > 1.0


def test_wrappers_raise_on_cpu_tensors(cuda):
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        mc.material_finish(x[:, 0], x[:, 0].bool(), torch.zeros(4, 16), x, x,
                           torch.arange(4), x[0], x[0], 0, 0, x, x,
                           x[:, 0].bool())
