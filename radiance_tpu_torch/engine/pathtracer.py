"""Wavefront path-tracing engine: WavefrontPathTracer.render.

Port of radiance_tpu/engine/pathtracer.py's staged per-wave scheduler
(`_render_staged`, :694-750; reference: samples/shader.cl:175-305).  One
frame is a host loop over waves, each a sequence of tensor ops and
kernel launches on the scene's device (no host sync inside a wave except
the SBT's skip of shaders no lane selects):

  for each sample in the batch:
    raygen (PCG3D-jittered camera rays)
    a primary wave and depth-1 bounce waves, each: closest-hit trace,
      SBT shading (the material shader traces its shadow rays inline),
      colour/throughput/alive update (shader.cl:233-260)
  running average into the accumulation image, tonemap, u8 quantize

A wave on CUDA whose shading is the built-in material and environment
shaders alone (WavefrontPathTracer.fuses_material, decided from the SBT
and the scene's instance table) shades and updates in two CUDA kernels
around the same shadow trace (shading/material_cuda.py), with no host
sync; other waves (custom shaders, debug modes, the CPU) take the SBT.

Wave routes (_traced_wavefront; reference :151-335):
  "stream3"    the stream3 pipeline (ops/stream3.py: emit walk, exact
               refine, pair intersection) on rays in pixel order, dead
               lanes masked out of every frustum; closest hit or, on
               shadow waves, occlusion;
  "gen1_live"  the live-masked packet kernel on rays in pixel order;
  "gen1_sort"  the live-masked packet kernel on rays bucket-sorted by
               direction octant, dead lanes last (ops/reorder.py's
               coherence_perm, a stable sort of 9 bucket keys), gathered
               back after;
  "argsort"    live rays argsorted by coherence_key, dead lanes parked,
               through the scene's dispatch (_trace_dispatch), unsorted
               after;
  "xla"        dead lanes parked in place, the two-level walk
               (ops/traversal.py) on the whole wave.
Routes that need the single-instance tables ("stream3", "gen1_*") fall
back to "argsort" elsewhere, and a custom any-hit program forces
"argsort", as the reference's explicit routes do (:194-207); unlike the
reference, they run on the CPU too (every kernel's plain version).

Each wave's route is a field of WavefrontPathTracer: primary_route,
bounce_route and shadow_route (the reference's
RADIANCE_ENGINE_{PRIMARY,BOUNCE,SHADOW}, route names here).  The
reference's RADIANCE_ENGINE_STREAM3 and RADIANCE_GEN1_SORT=1, one route
on every wave, are the three fields set to "stream3" or "gen1_sort".
Unset, the staged defaults, as the JAX engine picks them on its
accelerator (:722-726):
  * single-instance scenes with kernel tables: the primary wave's
    closest-hit trace takes "stream3"; its shadow rays take "gen1_live";
    bounce waves and their shadow rays take "argsort";
  * multi-instance scenes: every wave takes "argsort".  A scene with
    more than 8 instances (and per-BLAS kernel tables) is traced, closest
    hits and shadows alike, by ops/stream3_multi.trace_rows_multi (as the
    JAX engine's _trace_dispatch does, :99-120), with its tables built
    once per scene, on one of two routes: the tracer's `multi_route`,
    "scan" (the instance scan, the reference's default) or "native" (the
    TLAS-native slots, trace_rows_tlas, where the reference's
    RADIANCE_MULTI=native takes them); a scene with 2-8 instances by one
    packet sweep per instance (trace_rays_packet_multi);
  * the two-level walk (ops/traversal.py) takes every trace that carries
    a custom any-hit program (its wave is argsorted) and every trace of a
    scene without kernel tables (more than MAX_KERNEL_INSTANCES
    instances, the on-device LBVH), as the JAX engine's dispatch does
    (:94-125).

Temporal t-bounds (WavefrontPathTracer.tbound, the reference's
RADIANCE_ENGINE_TBOUND=1 and its frame_fn(tbound=True), :518-631,
:792-859): sample s's primary wave is bounded per 128-ray block by
stream3.block_bound_from_t of sample s-1's primary t, and the bounds
carry across render calls in a per-tracer store (at most _TB_CAP entries
keyed by scene and block count, the oldest evicted), reset to FLT_MAX
whenever total_samples is 0.  The bound reaches the stream3 primary of a
single-instance scene and, in pixel order, trace_rows_multi of a scene
with MULTI_SCAN_MIN_INSTANCES or more instances (the reference's engine
bounds only the stream3 route; elsewhere the bounds pass through inert,
as they do here on every other route).  Every ray such a trace marks
slot == -2 (a temporal residual past its cap, or the scan's poisoned
rays) is re-traced exactly before anything reads the record: through
_trace_dispatch (the packet kernel) on one instance, the per-instance
packet sweeps on many.  A bounded frame keeps the staged scheduler's
wave routes and, as frame_fn does, stops a sample's bounce loop once no
path is alive (a host read a bounce).

The stream3 routes' word format is the tracer's tq_bits (5..9, default
9; the reference's import-time RADIANCE_TQ_BITS): a scene built with a
leaf cap of 64 (its LEAF64 configuration) has more leaves than a 9-bit
word reaches on a 1M-triangle scene, and takes stream3 and the native
route only at tq_bits <= 8 (stream3.supports, stream3_multi.
supports_native); elsewhere its waves take the routes the reference
sends them to.

WavefrontPathTracer.frame_fn is the reference's frame_fn (:518-631)
without its jit: a frame over any pixel_index, and its sample_sum hook,
the sum of a range of frame ids' samples, on which parallel/sharding.py
builds; render is frame_fn over every pixel.  Its max_batch_per_dispatch
(samples a device program, which changes where the running average
rounds) has no counterpart: a frame averages all its samples at once.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from radiance_tpu_torch.api.sbt import ShaderBindingTable
from radiance_tpu_torch.bvh.device import DeviceScene
from radiance_tpu_torch.core import math as rmath
from radiance_tpu_torch.engine import shaders
from radiance_tpu_torch.engine.context import (Payload, ShadeContext,
                                              get_light_direction)
from radiance_tpu_torch.ops import (compaction, packet_trace, reorder,
                                    stream3, stream3_multi, traversal)
from radiance_tpu_torch.ops import tonemap as tonemap_ops
from radiance_tpu_torch.ops.intersect import FLT_MAX
from radiance_tpu_torch.ops.traversal import HitRecord
from radiance_tpu_torch.shading import material_cuda
from radiance_tpu_torch.utils import profiling

# Parking spot for lanes that must not trace: a ray starting here misses
# the scene root box on its first step.
_PARK_ORIGIN = 1e30
_INT32_MAX = 2 ** 31 - 1
# Scenes with at least this many instances take the instance scan: the
# JAX engine's threshold (more than 8, pathtracer.py:772-790), a trade
# made on the TPU and not yet measured on the card.
MULTI_SCAN_MIN_INSTANCES = 9


MULTI_ROUTES = ("scan", "native")
ROUTES = ("stream3", "gen1_live", "gen1_sort", "argsort", "xla")


def _trace_dispatch(scene, o, d, tmin, tmax, *, any_hit_terminate=False,
                    any_hit_program=None, live=None,
                    multi_route: str = "scan",
                    tq_bits: int = stream3.W_TQ_BITS) -> HitRecord:
    """Without a custom any-hit program: single-instance scenes with
    kernel tables go through the packet kernel (live masks honoured);
    scenes with MULTI_SCAN_MIN_INSTANCES or more instances through
    trace_rows_multi, on the instance scan or, with multi_route "native",
    the TLAS-native slots, in words of tq_bits; others with several
    instances through one packet sweep per instance.  A program, or a scene without kernel
    tables, takes the two-level walk.  Only the packet kernel reads
    `live`: callers mask dead lanes."""
    if multi_route not in MULTI_ROUTES:
        raise ValueError(f"multi_route must be one of {MULTI_ROUTES}")
    if any_hit_program is None:
        if packet_trace.supports(scene):
            return packet_trace.trace_rays_packet(
                scene, o, d, tmin, tmax, any_hit=any_hit_terminate, live=live)
        if packet_trace.supports_multi(scene):
            if _many_instances(scene):
                return stream3_multi.trace_rows_multi(
                    scene, stream3_multi.multi_tables(scene),
                    stream3.rows_from_aos(o, d), tmin, tmax,
                    occl=any_hit_terminate,
                    native=multi_route == "native", tq_bits=tq_bits)
            return packet_trace.trace_rays_packet_multi(
                scene, o, d, tmin, tmax, any_hit=any_hit_terminate)
    return traversal.trace_rays(scene, o, d, tmin, tmax,
                                any_hit_terminate=any_hit_terminate,
                                any_hit_program=any_hit_program)


def _many_instances(scene) -> bool:
    """The scene takes trace_rows_multi (per-BLAS tables, at least
    MULTI_SCAN_MIN_INSTANCES instances)."""
    return (stream3_multi.supports(scene)
            and len(scene.inst_kblas) >= MULTI_SCAN_MIN_INSTANCES)


def _retrace_distrusted(scene, rec, o, d, tmin, tmax, alive, *, occl: bool,
                        many: bool):
    """Re-trace exactly, in place, every live ray that a bounded trace
    marked slot == -2 (reference pathtracer.py:240-263, there through its
    walk): through _trace_dispatch (the packet kernel) on one instance,
    the per-instance packet sweeps on many (_trace_dispatch would take
    the scan again); on occlusion waves t is normalised to 0 / FLT_MAX.
    It must run before the slot clamp, which would make the marker a
    silent miss and erase geometry from the accumulation."""
    with profiling.span("engine.retrace"):
        bad = torch.nonzero((rec.slot == -2) & alive).squeeze(1)
        if bad.numel() == 0:
            return
        if many:
            sub = packet_trace.trace_rays_packet_multi(
                scene, o[bad], d[bad], tmin, tmax, any_hit=occl)
        else:
            sub = _trace_dispatch(scene, o[bad], d[bad], tmin, tmax,
                                  any_hit_terminate=occl)
        stream3.patch_retraced(rec, bad, sub, occl)


def _traced_wavefront(scene, o, d, tmin, tmax, alive, *, route: str,
                      any_hit_terminate: bool = False,
                      any_hit_program=None,
                      multi_route: str = "scan",
                      blk_bound=None,
                      tq_bits: int = stream3.W_TQ_BITS) -> HitRecord:
    """Trace only the live rays of a wave on `route` (module docstring);
    dead lanes report a miss.  "stream3" takes single-instance scenes
    where stream3.supports holds, "gen1_live" and "gen1_sort" those where
    packet_trace.supports does; elsewhere, and under a custom any-hit
    program (reference :196-199), they fall back to "argsort".
    multi_route goes to _trace_dispatch; tq_bits, the word format of the
    stream3 routes, to both (a scene past its leaf reach takes
    "argsort").

    blk_bound ([ceil(N / 128)] f32 per-block upper bounds on t, pixel
    order): the temporal cull and residual of the stream3 route, and of a
    scene with MULTI_SCAN_MIN_INSTANCES or more instances, which then
    traces its live rays in pixel order through trace_rows_multi (on
    multi_route) whatever `route` says.  Rays those traces mark
    slot == -2 are re-traced exactly (_retrace_distrusted).  Other routes
    ignore the bound, as the reference's do.
    """
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}")
    if any_hit_program is not None:
        route = "argsort"
    elif route == "stream3" and not stream3.supports(scene, tq_bits):
        route = "argsort"
    elif route in ("gen1_live", "gen1_sort") and not packet_trace.supports(
            scene):
        route = "argsort"
    if route == "stream3":
        rows = stream3.rows_from_aos_fast(o, d)
        rec = stream3.trace_rows_stream3(scene, rows, tmin, tmax,
                                         live=alive, occl=any_hit_terminate,
                                         blk_bound=blk_bound, tq_bits=tq_bits)
        if blk_bound is not None:
            _retrace_distrusted(scene, rec, o, d, tmin, tmax, alive,
                                occl=any_hit_terminate, many=False)
        rec.slot = torch.clamp(rec.slot, min=-1)
        return rec
    if (blk_bound is not None and any_hit_program is None
            and _many_instances(scene)):
        rec = stream3_multi.trace_rows_multi(
            scene, stream3_multi.multi_tables(scene),
            stream3.rows_from_aos(o, d), tmin, tmax, live=alive,
            occl=any_hit_terminate, native=multi_route == "native",
            blk_bound=blk_bound, tq_bits=tq_bits)
        _retrace_distrusted(scene, rec, o, d, tmin, tmax, alive,
                            occl=any_hit_terminate, many=True)
        return rec.masked_miss(~alive)
    if route == "xla":
        o_c = torch.where(alive[:, None], o, _PARK_ORIGIN)
        d_c = torch.where(alive[:, None], d, 1.0)
        rec = traversal.trace_rays(scene, o_c, d_c, tmin, tmax,
                                   any_hit_terminate=any_hit_terminate)
        return rec.masked_miss(~alive)
    if route == "gen1_live":
        rec = _trace_dispatch(scene, o, d, tmin, tmax, live=alive,
                              any_hit_terminate=any_hit_terminate,
                              multi_route=multi_route, tq_bits=tq_bits)
        return rec.masked_miss(~alive)
    if route == "gen1_sort":
        perm, inv = reorder.coherence_perm(d, alive)
        rec = _trace_dispatch(scene, o[perm], d[perm], tmin, tmax,
                              live=alive[perm],
                              any_hit_terminate=any_hit_terminate,
                              multi_route=multi_route, tq_bits=tq_bits)
        return rec.take(inv).masked_miss(~alive)
    key = torch.where(alive, packet_trace.coherence_key(o, d), _INT32_MAX)
    perm = torch.argsort(key, stable=True)
    parked = ~alive[perm]
    o_c = torch.where(parked[:, None], _PARK_ORIGIN, o[perm])
    d_c = torch.where(parked[:, None], 1.0, d[perm])
    rec = _trace_dispatch(scene, o_c, d_c, tmin, tmax,
                          any_hit_terminate=any_hit_terminate,
                          any_hit_program=any_hit_program,
                          multi_route=multi_route, tq_bits=tq_bits)
    rec = rec.take(compaction.invert_perm(perm))
    return rec.masked_miss(~alive)


def _make_context(scene: DeviceScene, hits: HitRecord, origin, direction,
                  pixel_index, frame_id, depth, resources, debug,
                  trace_occlusion, trace_full) -> ShadeContext:
    n_inst = scene.inst_id.shape[0]
    slot = torch.clamp(hits.slot, 0, n_inst - 1).to(torch.int64)
    bary = torch.stack([1.0 - hits.b1 - hits.b2, hits.b1, hits.b2], dim=-1)
    n = origin.shape[0]
    if n_inst == 1:
        # single instance: broadcast its rows instead of per-ray gathers
        inv = scene.inst_inv[0]
        transform = scene.inst_transform[0].expand(n, 4, 4)
        instance_id = scene.inst_id[0].expand(n)
        custom_id = scene.inst_custom[0].expand(n)
        sbt_offset = scene.inst_sbt[0].expand(n)
    else:
        inv = scene.inst_inv[slot]
        transform = scene.inst_transform[slot]
        instance_id = scene.inst_id[slot]
        custom_id = scene.inst_custom[slot]
        sbt_offset = scene.inst_sbt[slot]
    # object-space hit point = inv(M) . o + t * inv(M) . d
    o_l = rmath.mat4_transform_point(inv, origin)
    d_l = rmath.mat4_transform_dir(inv, direction)
    return ShadeContext(
        hit=hits.hit, t=hits.t, prim=hits.prim,
        instance_id=instance_id, custom_id=custom_id, sbt_offset=sbt_offset,
        bary=bary, hit_point=o_l + hits.t[:, None] * d_l,
        transform=transform, ray_origin=origin, ray_dir=direction,
        pixel_index=pixel_index, frame_id=frame_id, depth=depth,
        resources=resources, debug=debug,
        trace_occlusion=trace_occlusion, trace_rays=trace_full)


def _material_only(sbt, offsets, hit_offset: int, miss_index: int) -> bool:
    """Whether every record the instance SBT offsets `offsets` reach at
    hit_offset names the built-in shaders.material as its closest hit and
    the record at miss_index shaders.environment as its miss, with every
    closest-hit and miss name of the table registered (else the SBT path
    raises its KeyError)."""
    recs = sbt.records
    names = [getattr(r, k) for r in recs for k in ("closest_hit", "miss")]
    if any(nm and nm not in sbt.shaders for nm in names):
        return False

    def shader(index, kind):
        name = getattr(recs[index], kind) if 0 <= index < len(recs) else ""
        return sbt.shaders.get(name) if name else None

    return (all(shader(off + hit_offset, "closest_hit") is shaders.material
                for off in offsets)
            and shader(miss_index, "miss") is shaders.environment)


def _sample_step(tracer, scene, resources, pixel_index, frame_id, b, state,
                 *, debug, hit_offset, miss_index, route, shadow_route,
                 blk_bound=None, want_t: bool = False):
    """One engine wave: closest-hit trace, SBT shading (shaders trace
    occlusion rays inline), colour/throughput/alive update
    (shader.cl:233-260).  blk_bound bounds the wave's closest-hit trace
    (_traced_wavefront); want_t also returns its t (reference :338-415).

    Where tracer.fuses_material holds, the shading and the update run as
    the fused material wave (shading/material_cuda.shade_wave: two CUDA
    kernels around the same shadow trace) instead of the context, the SBT
    calls and the torch update below, which are its plain version.  The
    engine.shade span notes the wave's lanes (rays) and, on that route,
    fused_rays."""
    sbt = tracer.sbt
    color, contribution, alive, o, d = state
    n = pixel_index.shape[0]
    dev = o.device

    def trace_occlusion(origin, direction, tmin, tmax, active=None):
        # a custom any-hit program at the shadow offset (an alpha test)
        # rides into the walk; the canonical terminate-on-first anyShadow
        # is the tracers' any-hit mode
        prog = sbt.make_any_hit_program(tracer.shadow_hit_offset, resources)
        kw = dict(any_hit_terminate=prog is None, any_hit_program=prog,
                  multi_route=tracer.multi_route, tq_bits=tracer.tq_bits)
        with profiling.span("engine.trace.shadow"):
            if active is None:
                rec = _trace_dispatch(scene, origin, direction, tmin, tmax,
                                      **kw)
            else:
                rec = _traced_wavefront(scene, origin, direction, tmin, tmax,
                                        active, route=shadow_route, **kw)
        return rec.hit

    with profiling.span("engine.trace.primary" if b == 0
                        else "engine.trace.bounce"):
        hits = _traced_wavefront(
            scene, o, d, tracer.tmin, tracer.tmax, alive, route=route,
            any_hit_program=sbt.make_any_hit_program(hit_offset, resources),
            multi_route=tracer.multi_route, blk_bound=blk_bound,
            tq_bits=tracer.tq_bits)
    fused = tracer.fuses_material(scene, hit_offset, miss_index, debug)
    with profiling.span("engine.shade") as sp:
        sp.note(rays=n, fused_rays=n if fused else 0)
        if fused:
            st_out = material_cuda.shade_wave(
                scene, resources, hits, state, pixel_index, frame_id, b,
                get_light_direction(resources), trace_occlusion)
            return (st_out, hits.t) if want_t else st_out
        ctx = _make_context(scene, hits, o, d, pixel_index, frame_id, b,
                            resources, debug, trace_occlusion,
                            functools.partial(_trace_dispatch, scene,
                                              multi_route=tracer.multi_route,
                                              tq_bits=tracer.tq_bits))
        payload = Payload(
            color=torch.zeros(n, 3, dtype=torch.float32, device=dev),
            hit=torch.zeros(n, dtype=torch.bool, device=dev),
            next_factor=torch.ones(n, 3, dtype=torch.float32, device=dev),
            next_origin=o,
            next_dir=d)
        payload = sbt.call_hit(hit_offset, ctx, payload, alive & hits.hit)
        payload = sbt.call_miss(miss_index, ctx, payload, alive & ~hits.hit)

        # accumulation logic of shader.cl:238-252
        hit = payload.hit
        add = alive & hit
        color = color + torch.where(add[:, None],
                                    contribution * payload.color, 0.0)
        # first-bounce miss paints the background
        bg = alive & ~hit & (b == 0)
        color = torch.where(bg[:, None], payload.color, color)
        contribution = torch.where(add[:, None],
                                   contribution * payload.next_factor,
                                   contribution)
    st_out = (color, contribution, alive & hit, payload.next_origin,
              payload.next_dir)
    return (st_out, hits.t) if want_t else st_out


def _sample_init(tracer, resources, pixel_index, frame_id, total_samples0):
    """Fresh per-sample path state: PCG-seeded raygen + unit throughput
    (shader.cl:197-231)."""
    n = pixel_index.shape[0]
    dev = pixel_index.device
    with profiling.span("engine.raygen"):
        rand_input = torch.stack([
            torch.full((n,), frame_id, dtype=torch.int64, device=dev),
            torch.full((n,), total_samples0, dtype=torch.int64, device=dev),
            pixel_index.to(torch.int64)], dim=-1)
        origin, direction = tracer.ray_generator(resources, pixel_index,
                                                 rand_input)
    return (torch.zeros(n, 3, dtype=torch.float32, device=dev),
            torch.ones(n, 3, dtype=torch.float32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev), origin, direction)


def _finish_frame(tracer, batch, debug, accum, colors, total_samples):
    """Running average + tonemap + quantize (shader.cl:262-305)."""
    with profiling.span("engine.finish"):
        f = torch.tensor(float(total_samples), dtype=torch.float32,
                         device=accum.device)
        accum = (f * accum + colors) / (f + float(batch))
        rgb = accum if debug else tracer.tonemap(accum)
        return accum, tonemap_ops.quantize_rgba8(rgb)


@dataclasses.dataclass(eq=False)
class WavefrontPathTracer:
    """A configured raygen program.

    ray_generator: (resources, pixel_index [N], rand_input [N,3] uint32
                   values as int64) -> (origin [N,3], dir [N,3])
    sbt: ShaderBindingTable with registered shader callables
    hit_offset/miss_index/shadow_hit_offset: the traceRay group indices
      (the reference hardcodes 1/3 for primary and 2/4 for shadow in
      shader.cl:235 and :500)
    tonemap: float rgb -> float rgb display transform
    tmin/tmax: traceRay accept window (shader.cl:236)
    multi_route: the route of scenes with MULTI_SCAN_MIN_INSTANCES or
      more instances, "scan" (the reference's default) or "native" (the
      TLAS-native slots; the reference's RADIANCE_MULTI=native)
    tbound: carry temporal t-bounds through the primary waves (the
      reference's RADIANCE_ENGINE_TBOUND=1; module docstring)
    tq_bits: the stream3 routes' tq word width, 5..9 (the reference's
      RADIANCE_TQ_BITS; 7 with a scene built at leaf_cap=64 is its LEAF64
      configuration)
    primary_route, bounce_route, shadow_route: a route of ROUTES for
      the primary waves, the bounce waves and every shadow wave (the
      reference's RADIANCE_ENGINE_{PRIMARY,BOUNCE,SHADOW}); None keeps
      the staged default.  The reference's RADIANCE_ENGINE_STREAM3 and
      RADIANCE_GEN1_SORT=1 set all three to "stream3" or "gen1_sort"
    """
    ray_generator: Callable
    sbt: ShaderBindingTable
    tonemap: Callable = tonemap_ops.tonemap_sample1
    hit_offset: int = 1
    miss_index: int = 3
    shadow_hit_offset: int = 2
    tmin: float = 0.001
    tmax: float = 1000.0
    multi_route: str = "scan"
    tbound: bool = False
    tq_bits: int = stream3.W_TQ_BITS
    primary_route: Optional[str] = None
    bounce_route: Optional[str] = None
    shadow_route: Optional[str] = None
    # the bounds carried between render calls: (id(scene), blocks) ->
    # (scene, bounds), per tracer (two tracers with different cameras
    # must not share them), oldest evicted past _TB_CAP (reference
    # :756-770)
    _tb_store: dict = dataclasses.field(default_factory=dict, init=False,
                                        repr=False)
    _TB_CAP = 8
    # fuses_material's decisions: (id(sbt), id(inst_sbt), its version,
    # hit_offset, miss_index) -> (sbt, inst_sbt, decision), oldest evicted
    # past _FUSE_CAP
    _fuse_store: dict = dataclasses.field(default_factory=dict, init=False,
                                          repr=False)
    _FUSE_CAP = 8

    def __post_init__(self):
        stream3.word_format(self.tq_bits)    # 5..9, or ValueError

    def fuses_material(self, scene, hit_offset: int, miss_index: int,
                       debug: int) -> bool:
        """The fused material wave's route (_sample_step): a wave on CUDA,
        without a debug mode, whose shading is the built-in material and
        environment shaders alone (_material_only over the scene's instance
        SBT offsets).  The offsets are read from the device once per
        instance table (and again after an in-place refit), the decision
        kept per (SBT, table, hit_offset, miss_index): no wave reads the
        device for it."""
        if debug or scene.device.type != "cuda":
            return False
        inst_sbt = scene.inst_sbt
        key = (id(self.sbt), id(inst_sbt), inst_sbt._version, hit_offset,
               miss_index)
        held = self._fuse_store.get(key)
        if held is None:
            held = (self.sbt, inst_sbt,
                    _material_only(self.sbt, set(inst_sbt.tolist()),
                                   hit_offset, miss_index))
            self._fuse_store[key] = held
            while len(self._fuse_store) > self._FUSE_CAP:
                # (None: a sharded frame's other thread may pop it first)
                self._fuse_store.pop(next(iter(self._fuse_store)), None)
        return held[2]

    def wave_route(self, wave: str, default: str) -> str:
        """The route of `wave` ("primary", "bounce" or "shadow"): its
        field, else the staged `default` (the reference's _staged_route,
        :678-692)."""
        route = getattr(self, f"{wave}_route") or default
        if route not in ROUTES:
            raise ValueError(f"{wave}_route must be one of {ROUTES}")
        return route

    def _routes(self, scene, routes):
        """(primary, primary shadows, bounce, bounce shadows) routes of a
        frame on `scene`: `routes` is None or (primary, bounce, shadow[,
        shadow_bounce]), shadow covering both shadow waves when
        shadow_bounce is left out; a None entry, like routes=None, takes
        the wave's field, else its staged default (module docstring)."""
        single = packet_trace.supports(scene)
        if routes is None:
            routes = (None, None, None)
        if len(routes) not in (3, 4):
            raise ValueError("routes must be (primary, bounce, shadow[, "
                             "shadow_bounce])")
        primary, bounce, shadow = routes[:3]
        shadow_bounce = routes[3] if len(routes) == 4 else shadow

        def pick(route, wave, default):
            if route is None:
                return self.wave_route(wave, default)
            if route not in ROUTES:
                raise ValueError(f"{wave} route must be one of {ROUTES}")
            return route

        return (pick(primary, "primary",
                     "stream3" if stream3.supports(scene, self.tq_bits)
                     else ("gen1_live" if single else "argsort")),
                pick(shadow, "shadow", "gen1_live" if single else "argsort"),
                pick(bounce, "bounce", "argsort"),
                pick(shadow_bounce, "shadow", "argsort"))

    def frame_fn(self, *, batch: int, depth: int, debug: int = 0,
                 hit_group_offset: int = 0, miss_group_offset: int = 0,
                 tbound: bool = False, routes=None):
        """The frame for static (batch, depth, debug): the reference's
        frame_fn (:518-631) without its jit.

        Returns frame(scene, resources, accum [N,3] f32, total_samples,
        pixel_index [N] int[, tb]) -> (accum', image u8 [N,4][, tb']): frame
        ids run from total_samples over the pixels `pixel_index` names
        (shader.cl:197-281), on their tensors' device.
        frame.sample_sum(scene, resources, pixel_index, first_frame_id,
        total_samples0[, tb]) -> the sum of the sample colours [N,3] of
        frame ids [first_frame_id, first_frame_id + batch) ([, tb']); the
        raygen seeds each ray from its frame id, total_samples0 and pixel
        (the sharded sample modes, parallel/sharding.py, give each device
        its own first_frame_id).

        tbound bounds each sample's primary wave by the previous sample's
        per-block t (tb [ceil(N / 128)] f32 in, tb' out; FLT_MAX on every
        block when tb is None), and stops a sample's bounce loop once no
        path is alive (a host read a bounce).  routes: None, or
        (primary, bounce, shadow[, shadow_bounce]) for this frame's waves
        (_routes: shadow_bounce is the bounce waves' shadows, shadow the
        primary wave's, or both's when shadow_bounce is left out), each
        entry a route of ROUTES or None for the tracer's field or the
        staged default.
        """
        effective_depth = 1 if debug else depth
        hit_offset = self.hit_offset + hit_group_offset
        miss_index = self.miss_index + miss_group_offset

        def sample_sum(scene, resources, pixel_index, first_frame_id,
                       total_samples0, tb=None):
            primary, primary_shadow, bounce, bounce_shadow = self._routes(
                scene, routes)
            step = functools.partial(_sample_step, self, scene, resources,
                                     pixel_index, debug=debug,
                                     hit_offset=hit_offset,
                                     miss_index=miss_index)
            n = pixel_index.shape[0]
            dev = pixel_index.device
            if tbound and tb is None:
                tb = torch.full((-(-n // stream3.BLK),), FLT_MAX,
                                dtype=torch.float32, device=dev)
            colors = torch.zeros(n, 3, dtype=torch.float32, device=dev)
            for s in range(int(batch)):
                fid = int(first_frame_id) + s
                state = _sample_init(self, resources, pixel_index, fid,
                                     int(total_samples0))
                for b in range(effective_depth):
                    if b == 0 and tbound:
                        state, t1 = step(fid, b, state, route=primary,
                                         shadow_route=primary_shadow,
                                         blk_bound=tb, want_t=True)
                        tb = stream3.block_bound_from_t(t1)
                    elif b == 0:
                        state = step(fid, b, state, route=primary,
                                     shadow_route=primary_shadow)
                    elif tbound and not bool(state[2].any()):
                        break           # the reference's early exit (:572-575)
                    else:
                        state = step(fid, b, state, route=bounce,
                                     shadow_route=bounce_shadow)
                colors = colors + state[0]
            return (colors, tb) if tbound else colors

        def frame(scene, resources, accum, total_samples, pixel_index,
                  tb=None):
            ts = int(total_samples)
            with profiling.span("engine.frame"):
                if tbound:
                    colors, tb = sample_sum(scene, resources, pixel_index, ts,
                                            ts, tb)
                else:
                    colors = sample_sum(scene, resources, pixel_index, ts,
                                        ts)
                accum, image = _finish_frame(self, int(batch), debug, accum,
                                             colors, ts)
            return (accum, image, tb) if tbound else (accum, image)

        frame.sample_sum = sample_sum
        return frame

    def render(self, scene: DeviceScene, resources: Dict, accum,
               total_samples: int, width: int, height: int,
               *, batch: int, depth: int, debug: int = 0,
               hit_group_offset: int = 0, miss_group_offset: int = 0):
        """Run one frame: returns (accum' [N,3] f32, image u8 [H, W, 4]).

        frame_fn over every pixel (arange(N)).  Frame ids run from
        total_samples (shader.cl:197-281); callers own the totalSamples
        counter (sample1.cpp:479-490).  All tensors live on the scene's
        device.  With tbound, each sample's primary wave is bounded by the
        previous sample's (the first by the bounds this tracer stored for
        the scene at the end of its last frame, unless total_samples is 0:
        bounds share the accumulation's invalidation, so a camera change
        must reset total_samples), and a sample stops bouncing once no
        path is alive.
        """
        dev = scene.device
        n = width * height
        pixel_index = torch.arange(n, dtype=torch.int64, device=dev)
        frame = self.frame_fn(batch=batch, depth=depth, debug=debug,
                              hit_group_offset=hit_group_offset,
                              miss_group_offset=miss_group_offset,
                              tbound=self.tbound)
        if not self.tbound:
            accum, image = frame(scene, resources, accum, total_samples,
                                 pixel_index)
            return accum, image.reshape(height, width, 4)
        key = (id(scene), -(-n // stream3.BLK))
        held = self._tb_store.get(key) if total_samples > 0 else None
        tb = held[1] if held is not None and held[0] is scene else None
        accum, image, tb = frame(scene, resources, accum, total_samples,
                                 pixel_index, tb)
        self._tb_store.pop(key, None)      # refresh insertion order
        self._tb_store[key] = (scene, tb)
        while len(self._tb_store) > self._TB_CAP:
            self._tb_store.pop(next(iter(self._tb_store)))
        return accum, image.reshape(height, width, 4)
