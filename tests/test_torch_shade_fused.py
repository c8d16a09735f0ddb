"""The fused material wave's route rule and counters, on the CPU.

WavefrontPathTracer.fuses_material sends a closest-hit wave to the fused
kernels (shading/material_cuda.py) only on CUDA, without a debug mode, when
every SBT record the scene's instances reach at hit_offset names the
built-in material shader and the miss record the built-in environment
shader; the decision is kept per (SBT, instance table).  engine.shade notes
the wave's lanes and the fused ones.  The kernels themselves run on the
card only (tests/test_torch_cuda_shade.py); here their wrappers refuse CPU
tensors and the prep arguments' ctypes layout is held to the CUDA source's
struct."""

import ctypes
import os
import re
import types

import pytest
import torch

from radiance_tpu_torch.api.sbt import ShaderBindingTable
from radiance_tpu_torch.core import types as rtypes
from radiance_tpu_torch.engine import pathtracer as pt
from radiance_tpu_torch.engine import shaders
from radiance_tpu_torch.scene import procedural
from radiance_tpu_torch.shading import camera
from radiance_tpu_torch.shading import material_cuda as mc
from radiance_tpu_torch.utils import profiling


def _tracer(records=None, registry=None):
    sbt = ShaderBindingTable.from_json(
        records or shaders.DEFAULT_SBT_RECORDS,
        {**shaders.SHADER_REGISTRY, **(registry or {})})
    return pt.WavefrontPathTracer(
        ray_generator=camera.physical_camera_raygen, sbt=sbt)


def _card_scene(offsets):
    """What the route rule reads of a scene on the card: its device and
    its instances' SBT offsets."""
    return types.SimpleNamespace(device=torch.device("cuda"),
                                 inst_sbt=torch.tensor(offsets,
                                                       dtype=torch.int32))


def _records(**change):
    recs = [dict(r) for r in shaders.DEFAULT_SBT_RECORDS]
    for index, (kind, name) in change.items():
        recs[int(index[1:])][kind] = name
    return recs


def _custom(ctx, payload):
    return payload


def test_default_sbt_takes_the_fused_route():
    tracer = _tracer()
    cornell = procedural.cornell_box(device="cpu").device_scene("cpu")
    # sample1's Cornell box (7 instances): on the card, not on the CPU
    assert tracer.fuses_material(_card_scene(cornell.inst_sbt.tolist()), 1,
                                 3, 0)
    assert not tracer.fuses_material(cornell, 1, 3, 0)


@pytest.mark.parametrize("debug", [1, 6, 17])
def test_debug_modes_keep_the_sbt_path(debug):
    assert not _tracer().fuses_material(_card_scene([0]), 1, 3, debug)


def test_custom_closest_hit_reached_keeps_the_sbt_path():
    recs = _records() + [{"closestHit": "custom"}]
    tracer = _tracer(recs, {"custom": _custom})
    # offset 4 reaches record 5 at hit_offset 1
    assert not tracer.fuses_material(_card_scene([0, 4]), 1, 3, 0)
    # a record no instance reaches does not matter
    assert tracer.fuses_material(_card_scene([0, 0]), 1, 3, 0)
    # nor does an offset past the table: it shades nothing either way
    assert not tracer.fuses_material(_card_scene([0, 9]), 1, 3, 0)


def test_replaced_builtin_names_keep_the_sbt_path():
    # "material" registered as another function is not the built-in
    tracer = _tracer(registry={"material": _custom})
    assert not tracer.fuses_material(_card_scene([0]), 1, 3, 0)
    tracer = _tracer(_records(r3=("miss", "custom")), {"custom": _custom})
    assert not tracer.fuses_material(_card_scene([0]), 1, 3, 0)
    tracer = _tracer(registry={"environment": _custom})
    assert not tracer.fuses_material(_card_scene([0]), 1, 3, 0)


def test_unregistered_name_keeps_the_sbt_path_and_its_error():
    tracer = _tracer(_records(r4=("miss", "nowhere")))
    assert not tracer.fuses_material(_card_scene([0]), 1, 3, 0)


def test_decision_is_kept_and_follows_a_refit(monkeypatch):
    recs = _records() + [{"closestHit": "custom"}]
    tracer = _tracer(recs, {"custom": _custom})
    scene = _card_scene([0, 0])
    assert tracer.fuses_material(scene, 1, 3, 0)
    reads = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda t: reads.append(1) or real(t))
    assert tracer.fuses_material(scene, 1, 3, 0)
    assert reads == []                     # kept: no device read a wave
    scene.inst_sbt.copy_(torch.tensor([0, 4], dtype=torch.int32))
    assert not tracer.fuses_material(scene, 1, 3, 0)
    assert reads == [1]                    # an in-place refit reads again


def test_engine_shade_notes_rays_and_fused_rays():
    torch.set_num_threads(2)
    host = procedural.cornell_box(device="cpu")
    res = dict(host.resources)
    w = 12
    res["camera"] = camera.camera_params(rtypes.PhysicalCamera(
        width_pixel=float(w), height_pixel=float(w), focal_length=0.035,
        sensor_width=0.05, focal_distance=8.0, z=4.0), "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _tracer().render(host.device_scene("cpu"), res,
                         torch.zeros(w * w, 3), 0, w, w, batch=1, depth=2)
    shade = [r for r in profiling.spans().records if r.name == "engine.shade"]
    assert len(shade) == 2
    assert all(r.counts == {"rays": w * w, "fused_rays": 0} for r in shade)


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, 3)
    alive = torch.ones(4, dtype=torch.bool)
    hits = types.SimpleNamespace(t=x[:, 0], prim=alive.int(), slot=alive.int(),
                                 b1=x[:, 0], b2=x[:, 0])
    with pytest.raises(ValueError):
        mc.material_prep(None, {}, hits, x, x, alive)
    with pytest.raises(ValueError):
        mc.material_finish(x[:, 0], alive, torch.zeros(4, mc.REC_WIDTH), x, x,
                           torch.arange(4), x[0], x[0], 0, 0, x, x, alive)


def test_prep_args_match_the_cuda_struct():
    src = open(os.path.join(os.path.dirname(mc.__file__), "..", "csrc",
                            "shade_material.cu")).read()
    body = re.search(r"struct MaterialPrepArgs \{(.*?)\};", src,
                     re.S).group(1)
    decls = re.findall(r"^\s*(?:const )?(float|int|unsigned char|long long)"
                       r"(\*?) (\w+);", body, re.M)
    want = [(name, 8 if star else {"int": 4, "long long": 8}[ty])
            for ty, star, name in decls]
    got = [(name, ctypes.sizeof(ct)) for name, ct in mc.PrepArgs._fields_]
    assert want == got
