#!/usr/bin/env python3
"""Where the time goes in one engine frame of the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_profile.py            # the city, batch 4, depth 4
    python3 chip_profile.py --multi    # bench.py --multi's 64 instances
    python3 chip_profile.py --native   # the same on the TLAS-native route

It renders the city scene (bench.scene_geometry("city"), 1M triangles)
with WavefrontPathTracer.render at 1920x1080, batch=4, depth=4, as
chip_smoke.py's main path does -- or, with --multi, the 64-instance,
1M-triangle scene of chip_smoke.multi64_scene at 1920x1080, batch=1,
depth=2, every wave through the instance scan (ops/stream3_multi), or
with --native through the TLAS-native route (trace_rows_tlas, the
tracer's multi_route="native") -- and prints:
  * the card's name and power limit;
  * the host-clock ms of two warm frames;
  * by layer (CUDA events in one frame): the traced wavefronts (stream3
    primary waves or instance scans; coherence sort, packet kernel,
    epilogue, un-permute; every outermost call of _traced_wavefront or
    _trace_dispatch) against the rest of the frame (shading and
    accumulation);
  * the stream3 pipelines by stage (CUDA events in one more frame,
    summed over its pipeline runs): rows transpose, prep, emit, refine,
    features transpose, isect, glue, and (city, --native) the residual;
    and the diagnostics of one primary wave (city: words, kept words,
    steps, capped slots, flagged packets, rays re-walked; --multi:
    instances run, overlapping (block, instance) pairs, flagged sub-wave
    packets, poisoned rays; --native: slots alive and the pool, pool-
    overflowed and flagged packets, rays re-traced, words, steps);
  * by kernel kind (torch.profiler over one more frame): device ms per
    kind, the device's busy ms (union of its kernel and copy intervals)
    and its idle share of the profiled frame's host-clock time;
  * the 30 kernels with the most device time;
  * the packet kernel's device ms and launches per variant (and packet
    size), and kernel D's per kernel (its key fill, pair kernel and
    finishing pass);
  * kernels B and C in the profiled frame: launches, device ms, the
    longest slot walk and capped slots (B), the longest list, words and
    kept words (C);
  * as its last line, one JSON object with those numbers.

Writes nothing to disk but the kernel build in radiance_tpu_torch/_build/.
Exits 2 without a CUDA card, 1 if the profiler saw no device activity.
"""

import dataclasses
import json
import os
import re
import sys
import time

import numpy as np
import torch

import chip_smoke

NATIVE = "--native" in sys.argv[1:]
MULTI = "--multi" in sys.argv[1:] or NATIVE
W, H = chip_smoke.W, chip_smoke.H
BATCH, DEPTH = (1, 2) if MULTI else (4, 4)
KINDS = (  # (kind, substrings of a kernel's name), first match wins
    ("packet_trace", ("packet_trace",)),
    ("stream3_emit", ("emit_window_kernel",)),
    ("stream3_refine", ("refine_scan_kernel", "refine_test_kernel",
                        "refine_compact_kernel")),
    ("stream3_isect_occl", ("isect_occl_kernel", "fill_miss")),
    ("stream3_isect", ("isect_kernel", "isect_keys", "isect_finish")),
    ("stream3_oscal", ("oscal_kernel",)),
    ("stream3_transpose", ("aos_rows_kernel", "rows16_kernel")),
    ("sort", ("sort", "Radix", "radix")),
    ("copy/cat", ("Cat", "copy", "Memcpy", "Memset")),
    ("reduce", ("reduce",)),
    ("index/scatter/gather", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise",)),
)


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def variant_of(name: str):
    """The packet kernel's variant of a kernel record, as the wrapper's
    launch counts name it (packet_trace.variant); kernel D's three
    kernels by their own names; None for the rest."""
    m = re.search(r"packet_trace_kernel<([^,>]+),([^,>]+),([^,>]+)>", name)
    if m:
        on = [v.strip() in ("true", "1", "(bool)1") for v in m.groups()]
        var = (("masked_" if on[1] else "") + ("any_hit" if on[0] else
                                                "closest")
               + ("" if on[2] else "_legacy"))
        return f"packet_trace[{var}]"
    for k in ("isect_keys", "isect_finish", "isect_kernel"):
        if k in name and "isect_occl" not in name:
            return f"stream3_isect[{k}]"
    return None


def traced_wavefront_ms(pathtracer, frame):
    """Run frame() with CUDA events around every outermost trace call of
    the engine; returns (summed trace ms, number of traces, frame ms)."""
    pairs = []
    depth = [0]
    originals = {n: getattr(pathtracer, n)
                 for n in ("_traced_wavefront", "_trace_dispatch")}

    def timed(fn):
        def wrapper(*a, **k):
            depth[0] += 1
            try:
                if depth[0] > 1:
                    return fn(*a, **k)
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = fn(*a, **k)
                ev[1].record()
                pairs.append(ev)
                return out
            finally:
                depth[0] -= 1
        return wrapper

    for n, fn in originals.items():
        setattr(pathtracer, n, timed(fn))
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frame()
        end.record()
        torch.cuda.synchronize()
    finally:
        for n, fn in originals.items():
            setattr(pathtracer, n, fn)
    return (sum(a.elapsed_time(b) for a, b in pairs), len(pairs),
            start.elapsed_time(end))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    os.environ.pop("RADIANCE_BENCH_SCENE", None)
    import bench
    from radiance_tpu_torch.api import accel
    from radiance_tpu_torch.core import types
    from radiance_tpu_torch.engine import pathtracer
    from radiance_tpu_torch.ops import stream3, stream3_multi
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(card, flush=True)
    if MULTI:
        scene, res, _ = chip_smoke.multi64_scene(dev, W, H)
    else:
        verts, tris = bench.scene_geometry("city")
        tlas = accel.BuildTopAccelStruct([types.Instance(
            np.eye(4, dtype=np.float32), 0, 0,
            accel.BuildBottomAccelStruct(types.Mesh(verts, tris)))])
        scene = tlas.device_scene(dev)
        res = chip_smoke.city_resources(dev, verts, tris, W, H)
    tracer = chip_smoke.make_tracer()
    if NATIVE:
        tracer = dataclasses.replace(tracer, multi_route="native")
    state = dict(accum=torch.zeros(W * H, 3, device=dev), ts=0)

    def frame():
        state["accum"], _ = tracer.render(scene, res, state["accum"],
                                          state["ts"], W, H, batch=BATCH,
                                          depth=DEPTH)
        state["ts"] += BATCH

    warm_ms = []
    for _ in range(2):       # the first builds the kernel
        t0 = time.time()
        frame()
        torch.cuda.synchronize()
        warm_ms.append((time.time() - t0) * 1e3)
    print(f"warm frames (host clock): {warm_ms} ms", flush=True)

    trace_ms, n_traces, frame_ms = traced_wavefront_ms(pathtracer, frame)
    print(f"by layer (CUDA events, one frame): frame {frame_ms:.3f} ms, "
          f"{n_traces} traced wavefronts {trace_ms:.3f} ms, shading and "
          f"accumulation {frame_ms - trace_ms:.3f} ms", flush=True)
    if NATIVE:
        _, stage_ms, _ = chip_smoke.call_spans(
            stream3_multi, chip_smoke.TLAS_STAGES, frame)
        stage_ms = {k: sum(v) for k, v in stage_ms.items()}
    else:
        _, stage_ms = chip_smoke.stage_spans(stream3, frame)
    if MULTI and not NATIVE:  # no trace_rows_stream3 around the scan's runs
        del stage_ms["trace_rows_stream3"], stage_ms["residual"]
    stage_ms = {k: round(v, 3) for k, v in stage_ms.items()}
    print(f"stream3 pipelines by stage (CUDA events, one frame): "
          f"{json.dumps(stage_ms)}", flush=True)
    pix = torch.arange(W * H, device=dev)
    _, _, alive, o, d = pathtracer._sample_init(tracer, res, pix, 0, 0)
    if MULTI:
        _, diag = stream3_multi.trace_rows_multi(
            scene, stream3_multi.multi_tables(scene),
            stream3.rows_from_aos(o, d), tracer.tmin, tracer.tmax,
            with_diag=True, native=NATIVE)
        primary_diag = dict(diag)
    else:
        _, diag = stream3.trace_rows_stream3(
            scene, stream3.rows_from_aos_fast(o, d), tracer.tmin,
            tracer.tmax, live=alive, with_diag=True)
        primary_diag = {k: int(diag[k]) for k in (
            "words", "kept_words", "steps", "capped", "flagged",
            "residual_rays")}
    print(f"one engine primary wave (pixel order): "
          f"{json.dumps(primary_diag)}", flush=True)

    # the profiled frame's emit and refine outputs, for the chain lengths
    # of kernels B and C
    with chip_smoke.Calls(None, stream3_multi if NATIVE else stream3,
                          names=("stage_emit", "stage_refine"),
                          keep_args=False) as calls, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        frame()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not events:
        print("chip_profile: the profiler recorded no device activity",
              file=sys.stderr)
        return 1
    by_kind, by_name, by_variant = {}, {}, {}
    for e in events:
        us = e.duration_ns() / 1e3
        by_kind[kind_of(e.name())] = by_kind.get(kind_of(e.name()), 0.0) + us
        var = variant_of(e.name())
        if var:
            tot, cnt = by_variant.get(var, (0.0, 0))
            by_variant[var] = (tot + us, cnt + 1)
        tot, cnt = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (tot + us, cnt + 1)
    busy_ms = chip_smoke.busy_ms(prof)
    print(f"profiled frame (torch.profiler): host clock {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}", flush=True)
    for name, (us, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:30]:
        print(f"  {us / 1e3:10.3f} ms {cnt:6d}  {name[:110]}")
    print("the packet kernel by variant and kernel D by kernel (device ms, "
          "launches):", flush=True)
    for var, (us, cnt) in sorted(by_variant.items()):
        print(f"  {us / 1e3:10.3f} ms {cnt:6d}  {var}")
    em, rf = ([c[3][1] for c in calls.calls[k]] for k in ("emit", "refine"))
    chains = dict(
        stream3_emit=dict(
            launches=len(em), device_ms=by_kind.get("stream3_emit", 0) / 1e3,
            longest_walk=max((int(e[:, 2].max()) for e in em), default=0),
            capped=sum(int(e[:, 1].sum()) for e in em)),
        stream3_refine=dict(
            launches=len(rf),
            device_ms=by_kind.get("stream3_refine", 0) / 1e3,
            longest_list=max((int(e[:, 4].max()) for e in rf), default=0),
            words=sum(int(e[:, 4].sum()) for e in rf),
            kept=sum(int(e[:, 0].sum()) for e in rf)))
    print(f"kernels B and C in the profiled frame: {json.dumps(chains)}",
          flush=True)
    out = dict(
        card=card, scene="multi64" if MULTI else "city",
        route=tracer.multi_route if MULTI else None, width=W, height=H,
        batch=BATCH, depth=DEPTH,
        warm_frame_ms=warm_ms, event_frame_ms=frame_ms,
        traced_wavefront_ms=trace_ms, n_traced_wavefronts=n_traces,
        stream3_stage_ms=stage_ms, primary_diag=primary_diag,
        profiled_frame_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / wall_ms,
        device_ms_by_kind={k: v / 1e3 for k, v in
                           sorted(by_kind.items(), key=lambda kv: -kv[1])},
        device_ms_by_variant={k: dict(ms=us / 1e3, launches=cnt) for k, (
            us, cnt) in sorted(by_variant.items())},
        packet_trace_launches=sum(c for n, (_, c) in by_name.items()
                                  if "packet_trace" in n),
        emit_refine=chains)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
