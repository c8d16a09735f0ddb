#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (radiance_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and
prints no result):
  1. device and toolchain: the card's name and power limit, CUDA, nvcc;
  2. build the seven kernel sources (csrc/packet_trace.cu and the stream3
     pipeline's s3_transpose.cu, s3_emit.cu, s3_refine.cu, s3_isect.cu,
     s3_isect_occl.cu, s3_oscal.cu) with nvcc for sm_90a, one nvcc per
     library, all started together -- the defaults and the leaf-cap and
     tq-width variants phases [14]-[15] launch; print their
     registers/spills and the build seconds;
  3. kernel vs its plain PyTorch version on the card, every variant, on
     64k-ray probes of the bench's three waves (primary, mirror bounce,
     shadow) and of a scattered wave over the 1M-triangle city, the
     scattered wave's t also against float64; legacy frames on a small
     near-origin scene; the far-from-origin grazing scene against the
     brute-force soup; PCG3D's words against a numpy oracle bit for bit;
     a small render against the CPU route; sample1's 512x512 primary and
     shadow waves on each Cornell-box instance's tables;
  4. the three 1920x1080 waves timed with CUDA events, kernel and plain,
     and the kernel's output held to the plain version's ray by ray; the
     plain version's walk counts give each variant's bound;
  5. stream3 on the city's 1920x1080 primary wave (2,073,600 rays): each
     of its four closest-hit kernels against its plain version on the
     card at the wave's shapes (transposes bit-exact, also at odd sizes,
     emit and refine word lists and emeta identical, B's window loads
     counted by the plain walk, pair intersection per ray to the parity
     bars, with D's bound from the plain version's counts),
     each timed (the transposes' two launches each alone and together,
     beside .t().contiguous()); the whole wave against the packet kernel
     (two exact tracers, the same bars), its stage times and diagnostics;
  6. the main path: WavefrontPathTracer.render on the city at 1920x1080,
     batch=4, depth=4 (primary waves through stream3), then sample1's
     Cornell box at 512x512, batch=16, depth=4, with launch counts reset
     just before and read just after, under torch.profiler with every
     call of the packet kernel, B, C and D recorded; then each launch's
     kernel ms from the profiler's kernel records, its bound from plain
     runs on its recorded arguments or from its counts (the packet
     kernel: sampled packets of each launch group, one walk a group,
     held against the kernel's recorded output on the same rays), B, C,
     D and F held against their plain versions on each city launch, with
     B's longest walk, capped slots and window loads and C's longest
     list;
  7. the many-instance stream path: kernel F (prep octant, whole-packet
     and 32-ray sub-frustum scalars) on the city's 1080p primary rows,
     masked and unmasked, its four outputs equal to its plain version's
     value for value, and the whole prep timed with F and with the plain
     route; kernel E (occlusion pairs) on the city's 1080p
     shadow wave against its plain version, on the emitted lists and on
     the lists refined by kernel C, each timed with its bound, and that
     wave through trace_rows_stream3(occl=True) against the packet
     kernel's any-hit; the 64-instance, 1M-triangle scene of bench.py
     --multi (built here with the port's accel) traced on the bench's
     tile-ordered 1080p primary rays through trace_rows_multi against the
     packet kernel's per-instance sweeps, then its shadow wave as
     occlusion, both timed, E and F per launch and held against their
     plain versions on the largest launch of each wave; then an engine
     frame on that scene at 1920x1080, batch=1, depth=2 (depth cut for
     time, not the width), with launch counts reset just before and read
     just after, under torch.profiler with every call of B, C, D, E and
     F recorded, each launch timed from the kernel records and bounded,
     D, E and F held against their plain versions on every launch, B and
     C on every MULTI_HOLD_STRIDE-th and on each wave's longest walk and
     longest list; and a second frame whose waves' shares of poisoned
     rays are logged;
  8. the RD-style API (Platform, buffers, pipeline, TraceRays), each
     path with the launch counts reset just before and read just after,
     its kernels seen by the Calls recorder: sample1's render_sample1 on
     the Cornell box at 512x512, batch 16, depth 4, 2 frames (the
     packet kernel's sweeps); the city written as a GLB with the port's
     write_glb and loaded twice through load_scene's AS cache (build and
     write .cache, then load from it; the two device scenes equal tensor
     for tensor), then 2 frames at 1920x1080, batch 4, depth 4 through
     TraceRays (the packet kernel and A, B, C, D, F); sample2 at 512
     with 1024^2 textures, batch 4, depth 1 (the instance scan with E),
     its TLAS file loaded back equal to a fresh build, each wave's
     poisoned share logged.  For sample1 and the city the RD route's
     accumulator must equal a direct render of the same scene,
     resources and camera at least as closely as two direct renders
     equal each other; frame ms, the RD frame beside the direct one, and
     the GLB parse, SAH build and cache-load seconds are logged;
  9. the two-level walk (ops/traversal.py) and the animated scene, with
     the launch counts reset just before and read just after: (a) the
     walk on 64k-ray probes of the city's three bench waves and a
     scattered wave against the packet kernel and of the multi64 primary
     against the instance scan,
     to the parity bars, each timed beside the other tracer; (b) an
     alpha-test any-hit program (odd prims let rays through) on the
     city's primary and shadow probes against the packet kernel on the
     city without its odd prims, accept-all-and-terminate equal to the
     built-in any-hit mode, and a 512x512, batch 1, depth 2 city frame
     with the alpha program at the shadow offset; (c) 96 instances of
     sample2's torus (no kernel tables) through TraceRays at 512x512,
     batch 1, depth 2, its primary wave held against the brute-force
     world soup on 4096 rays; (d) bench.py --animated's rigid motion:
     the multi64 TLAS refitted under frame_tf(k) for 6 frames at
     512x512 through the engine's dispatch (the scan), each frame held
     to a fresh build (hits and instance ids); (e) its deforming mesh:
     64,000 wobbling triangles rebuilt by the LBVH and walked for 3
     frames at 512x512 (LBVH_FRAMES), the card's tables equal to the CPU build's bit
     for bit, the last frame held to a host SAH build; bench.py's
     animated metrics under its names;
 10. the TLAS-native many-instance route (stream3_multi.trace_rows_tlas)
     on a fresh multi64 scene, its launch counts set to 0 just before
     and read just after each of its runs: (a) the bench's tile-ordered
     1080p primary wave and its shadow wave against the instance scan
     and the per-instance sweeps to the parity bars, timed with CUDA
     events and split by stage (prep, B, C, A, D/E, glue, residual),
     slots alive, pool-overflowed and flagged packets and residual rays
     logged; each of F, B, C and D (E on the shadow wave) held against
     its plain version on its launch (recorded under torch.profiler,
     bounded), A bit-exact on the wave's slot features, and the
     residual forced by a pool of one slot a packet on both waves (the
     same hits as unforced; the packet kernel held against its plain
     version on the residual's largest launch); (b) engine frames at
     1920x1080, batch 1, depth 2 on the native route beside the scan,
     warm, each route's idle share from torch.profiler, u8 RMSE between
     the two images < 2.0; (c) bench.py --animated's rigid refit on the
     native route, 6 frames at 512x512, each t bit-equal to a fresh
     build's; (d) the 1080p primary at 2, 4, 8, 9, 16 and 64 instances
     of multi64 through the sweeps, the scan and the native route (for
     the route thresholds; measured only);
 11. temporal t-bounds (stream3's blk_bound, both many-instance routes,
     the engine's tbound frames), their launch counts set to 0 just
     before and read just after each bounded run: (a) bench.py's
     interior hall (the port's interior_hall, 1M triangles, SAH, one
     instance); (b) bench.py --tbound's shape wave by wave: 4 jittered
     1920x1080 primary waves of the interior, each after the first
     bounded by the previous one's block_bound_from_t, sample 1 against
     its unbounded trace (bench's exactness test and the parity bars, no
     slot -2), the bounded and unbounded chains timed with CUDA events
     and printed under bench's metric names, and for each bounded sample
     the (word, block) pairs before and after the cull, the temporal
     residual against its cap, and D's launch with and without the
     bound (torch.profiler), the bounded launch held against its plain
     version; (c) engine frames of the interior at 1920x1080, batch 4,
     depth 4, with tbound off and on, frames at total_samples 0 then 4,
     warm, their accumulations allclose (rtol 1e-3, atol 1e-4) and
     images within u8 RMSE 0.5; (d) multi64's 1080p primary and shadow
     waves on the scan and the native route, bounded by the previous
     identical (closest-hit) trace and equal to the unbounded ones, then
     bounded by 0.5 on every block with the residual's floor at 8 rays,
     through the engine's _traced_wavefront: the unbounded hits, no slot
     below -1;
 12. ray and word ordering (chip_smoke.ordering_modes) on the city at
     1920x1080, its runs driven (launch counts set to 0 just before and
     read just after): (a) the engine's bucket sort
     (reorder.coherence_perm) on the bounce wave against torch.argsort of
     coherence_key, both timed, the permutation checked stable; (b)
     bench.py's three waves with the secondaries on "gen1_sort" against
     "gen1_live" (hits and t identical, occluded-or-not on the shadow
     wave), each timed; (c) on the 1080p primary, kernel C with and
     without its tq-sort form against its plain version (word lists
     identical; the sorted lists the unsorted ones in stable bucket
     order) and kernel D on both lists in its default, lean, cull and
     lean-and-cull forms against its plain version with the same flags
     (the parity bars; each form's t bit-equal to the same version's
     default form, prims >= 0.999), each timed with its bound and the
     cull's skipped pairs; (d) the block presort on the engine's
     pixel-order primary and the bench's tile-ordered one: capped and
     flagged packets, re-traced rays and words with and without it,
     hits held to the unsorted trace; (e) trace_rows_cascade on the
     shadow wave and the mirror bounce at the 50th and 90th percentile
     of each wave's hit t: stage A's and B's words against a full-range
     trace, results held to it; (f) build_tracer equal to
     trace_rows_stream3 with its drain bit for bit, then with presort,
     tqsort, lean and cull on both primaries (the slice's path: its
     counts are the new forms' launches), lean barycentrics within 2e-3;
     (g) city frames (1080p, batch 4, depth 4) with the bounce and
     shadow waves on "gen1_sort" against the default "argsort",
     accumulations allclose, and a 256x256 frame with "xla" bounces (the
     walk takes 1-2 s a trace: a cut of size only) against the default;
 13. multi-device rendering (parallel/sharding.py, chip_smoke.
     sharded_frames) on the city at 1920x1080, batch 2, depth 2, each
     mode run twice (the second warm), timed through profiling.timed
     (host clock ending in a synchronize) beside the unsharded frame on
     the same inputs, its runs driven: render_sharded on 3 shards of the
     card (691,200 pixels a shard: whole stream3 and packet-kernel
     packets) and on 4 (unaligned), sample_parallel_frame on 4 shards of
     batch 1 against render of batch 4, tile_sample_frame on a 3x2 mesh
     against render of batch 2, staged_shard_frame with "auto" and with
     the explicit SHARD_ROUTES (E on the primary's shadows) against
     frame_fn of the same routes, and a real 2-card pixel mesh where the
     machine has two cards (logged as not run on one); pixel modes must
     reproduce the image and accum (rtol 1e-5, atol 1e-6) on >= 0.9999
     of the pixels (a shard's waves make other packets, and a tie
     between leaves may then go the other way; the others are logged
     with their primary hits), the 2D mode accum to rtol 1e-4, atol 1e-5
     on as many, the sample-parallel mode on every pixel;
 14. LEAF64, the JAX package's 1M-triangle configuration
     (chip_smoke.leaf64): the city's tables at leaf_cap 64 (leaves, MiB,
     build seconds; past a 9-bit word's 16,382 leaves, so stream3 takes
     it only at tq_bits 7), then, with the launch counts set to 0 just
     before and read just after, its path: bench's three 1080p waves
     through the packet kernel (T = 64 lanes), the tile-ordered primary
     and its shadow wave through trace_rows_stream3(tq_bits=7), an engine
     frame at 1920x1080 b1 d2 with tq_bits 7; each wave's packet kernel
     (and the masked shadow) held to its plain version, timed in turns
     with the cap-128 tables' kernel on the same rays; the cap-64 hits
     held to the cap-128 scene's (the same geometry, other leaf frames:
     t on |dt|/(|o|+t) with the float64 witness); B, C and D on the
     primary and E on the shadow wave at tq 7 held to their plain
     versions (words identical, hits to the bars) with bounds; D's ms a
     launch at cap 64 against cap 128 on the same primary, in turns; the
     LEAF64 engine frame's ms beside the cap-128 frame's (warm, in turns,
     images within u8 RMSE 3.0);
 15. wide leaves (chip_smoke.wide_leaves): the city at leaf_cap 256 (tq
     9), 64k-ray probes of the primary and shadow waves, driven (counts
     reset and read) through the packet kernel and stream3, then the
     packet kernel (a leaf in passes of 32 lanes), D and E (256-lane
     tiles in dynamic shared memory) held to their plain versions and
     timed beside cap 128;
 16. many BLASes (chip_smoke.many_blas64): bench.py --multi's scene at
     leaf_cap 64, kleaf_cat's leaves, one native 1080p primary
     (trace_rows_tlas, tq 7) driven and held to the scan at tq 7;
 17. the viewers (chip_smoke.viewers): sample1's render() callback on
     the card at 512x512 in tools/web_viewer.render_loop_web through a
     urllib client (GET /frame.png, its bytes encode_png of the returned
     frame, and /state; POST a camera edit to /control, /save, /quit)
     and in tools/viewer.render_loop with a --controls-file edit, each
     driven; totalSamples restarts at the edit and the next frame equals
     a fresh render_sample1 at the edited camera; then `python -m
     radiance_tpu_torch.samples.sample1 --interactive` and `--web` (64x64,
     2 frames) each in its own process on the card;
 18. the SAH-driven leaf collapse (chip_smoke.collapse_and_windows): the
     city built greedy and with collapse="sah" at rho 0.15, caps 128 and
     64 (leaves, MiB, build seconds); on the SAH builds, driven, the
     three 1080p waves, stream3's primary and shadow, multi64 at SAH on
     the native route and a 1080p b1 d2 frame; the SAH hits held to the
     greedy builds' on the same rays (the frame within u8 RMSE 2.0),
     every build's waves timed (B-E a launch from torch.profiler), the
     SAH builds' kernels held to their plain versions.  Phases [5], [7],
     [12] (d) and [14] also run their waves with kernel B's step cap in
     windows of 8 rows (the default) and of 1 in turns (step_rows_wave:
     flagged packets, residual, B's ms and longest walk; every launch of
     B held to its plain version at both);
 19. the fused material wave (chip_smoke.fused_material_wave) on the
     city's 1920x1080 primary wave and first bounce: rt_material_prep and
     rt_material_finish timed alone beside their byte bounds, the whole
     wave through the fused route and through the SBT path it replaces,
     the two routes' path states equal bit for bit;
 20. the interior's 1920x1080 diffuse bounce wave through the packet
     kernel (chip_smoke.diffuse_bounce_wave): cosine-weighted bounces
     off the hall's primary hits, sorted as the engine sorts them, timed,
     held against the plain version and bounded by its counts; the node
     steps and leaves of a 64-ray packet walking with one cursor against
     a ray alone (the union factor the ray-private walk removes);
 21. the kernels' JSON line (per kernel: the main path's launches, the
     per-launch means of kernel ms, plain ms and bound and their sums,
     by scene where a kernel runs in several; A from phase 5, B and C
     also phase 5's 1080p wave, F phase 7's masked 1080p rows; each
     phase 8 path's launches, phase 9's, phase 10's, phase 11's,
     phase 12's and phase 13's, phase 10's launch of each on the native
     1080p waves,
     and D's bounded launch on phase 11's interior waves; rows of C's
     tq-sort form and D's lean and cull forms from phase 12), the card
     line, and the contract's last line; every row also carries its
     launches in each driven path of phases [14]-[17] and its numbers at
     cap 64 / tq 7 (`leaf64_1080p`) and on the 256-lane probe
     (`wide256_probe`), and phase [18]'s launches (`collapse_launches`)
     and per-build ms (`collapse_1080p`); B's row the step windows'
     waves (`step_windows`); the fused material wave's row its
     launches on phase [6]'s main path and phase [19]'s numbers; the
     packet kernel's closest-hit row phase [20]'s
     (`diffuse_bounce_1080p`).

Imports nothing of JAX or radiance_tpu (bench.py's numpy-only scene
helpers are reused).  Needs one CUDA card; exits 2 without one.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
CW = 512                      # sample1's Cornell-box image side
S2, S2_TEX = 512, 1024        # sample2's image side and texture side
PROBE = 65536
# the plain walks that bound the main path's packet launches take one
# 1024-ray packet in PLAIN_STRIDE of each (the whole walk of an
# incoherent city bounce wave takes tens of seconds)
PLAIN_STRIDE = {"city": 32, "cornell": 8}
TMIN, TMAX = 1e-3, 1e4
BARS = dict(hit=0.999, prim=0.999, rel_t_p99=1e-5)
WITNESS_RATIO = 2.0
KERNEL_SOURCE = "radiance_tpu_torch/csrc/packet_trace.cu"
REPLACES = "radiance_tpu/ops/packet_trace.py:125"
# the packet-kernel variants on the main path: the city's primary shadows
# are live-masked, its bounces argsorted (unmasked), stream3's residual
# and the multi-instance sweeps unmasked.  masked_closest (the primary's
# route before stream3) is still checked in phases 3-4.
PATH_VARIANTS = ("closest", "any_hit", "masked_any_hit")
S3_SRC = "radiance_tpu_torch/csrc/"
S3_KERNELS = {   # stage key -> (JSON name, source, TPU kernels replaced)
    "transpose": ("stream3_transpose", S3_SRC + "s3_transpose.cu",
                  ["radiance_tpu/ops/stream3.py:1595",
                   "radiance_tpu/ops/stream3.py:1575"]),
    "emit": ("stream3_emit", S3_SRC + "s3_emit.cu",
             ["radiance_tpu/ops/stream3.py:595",
              "radiance_tpu/ops/stream3.py:753",
              "radiance_tpu/ops/stream3.py:1031",
              "radiance_tpu/ops/stream3.py:1257"]),
    "refine": ("stream3_refine", S3_SRC + "s3_refine.cu",
               ["radiance_tpu/ops/stream3.py:1635"]),
    "isect": ("stream3_isect", S3_SRC + "s3_isect.cu",
              ["radiance_tpu/ops/stream3.py:1853"]),
    "isect_occl": ("stream3_isect_occl", S3_SRC + "s3_isect_occl.cu",
                   ["radiance_tpu/ops/stream3.py:2100"]),
    "oscal": ("stream3_oscal", S3_SRC + "s3_oscal.cu",
              ["radiance_tpu/ops/stream3.py:294"]),
}
MULTI_TRIS = 1_000_000        # bench.py --multi: 8 BLASes x 8 instances
# the card's peaks (H100 SXM datasheet, dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FLOPS_PER_PAIR = 44           # a ray-triangle test: 22 FP32 FMAs


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def camera_rays(dev, w=W, h=H):
    """bench.camera_rays for the city: tile-ordered 32x32-pixel packets."""
    n = w * h
    ts = 32
    px = np.arange(n, dtype=np.int64) % w
    py = np.arange(n, dtype=np.int64) // w
    tile = (py // ts) * (w // ts) + (px // ts)
    order = np.argsort(tile * 1024 + (py % ts) * ts + (px % ts))
    xs = px[order] / w - 0.5
    ys = py[order] / h - 0.5
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 140.0
    d = np.stack([xs * 1.2, ys * 0.7, np.full(n, -1.0)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def bounce_rays(rmath, o, d, t1, flt_max):
    """bench.py's mirror bounce off a radial normal."""
    hit = t1 < flt_max
    hit_p = o + t1[:, None] * d
    nrm = rmath.normalize(o - hit_p, eps=1e-6)
    d2 = rmath.reflect(-d, nrm)
    o2 = torch.where(hit[:, None], hit_p + nrm * 1e-3, o)
    return o2, d2


def cuda_ms(fn, reps, warmup=True):
    """Mean ms per call of fn over reps, by CUDA events (after one
    warmup call unless warmup=False)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def device_ms(fn, reps):
    """Mean device ms a call of fn over reps back-to-back calls, by CUDA
    events, and fn's output.  A sleep kernel holds the stream while the
    host enqueues the calls, so a call that costs the host more than its
    kernel takes (where cuda_ms() would time the host) shows only its
    device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)        # ~10 ms of clock cycles
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def judge(name, t_k, tri_k, t_p, tri_p, o, d, live, kprim, *, any_hit,
          t_scale="t", mesh=None):
    """Hold the kernel's (t, tri) to its plain version's on the same rays.

    t_scale="t" holds p99 |dt| / t to the bar.  t_scale="origin" is for
    short rays far from the origin (bounces off hit points): the tables'
    plane numerator n.o + dp is origin-centred in both frame modes, so
    both versions carry an absolute t error of order
    |o| * eps / cos(incidence) there.  It holds p99 |dt| / (|o| + t) to
    the bar, or, where that misses, requires the float64 witness to show
    the kernel no further from the true t than the plain version.
    mesh=(verts, tris) runs that witness (closest hit only).  kprim=None
    holds the face rows themselves."""
    hk, hp = t_k < 3.4e38, t_p < 3.4e38
    both = hk & hp
    res = dict(name=name, rays=int(t_k.shape[0]),
               hit_rate=float(hp.float().mean()),
               hit_agree=float((hk == hp).float().mean()))
    if live is not None:
        res["dead_hits"] = int((hk & ~live).sum())
        assert res["dead_hits"] == 0, res
    ok = res["hit_agree"] >= BARS["hit"]
    if not any_hit:
        prim_k, prim_p = ((tri_k, tri_p) if kprim is None else
                          (kprim[tri_k.clamp(min=0).long()],
                           kprim[tri_p.clamp(min=0).long()]))
        same = both & (prim_k == prim_p)
        nb = int(both.sum())
        res["prim_agree"] = float(same.sum()) / nb if nb else 1.0
        scale = t_p.abs()
        if t_scale == "origin":
            scale = scale + o.norm(dim=1)
        rel = ((t_k - t_p).abs() / scale.clamp(min=1e-30))[same]
        res["t_scale"] = t_scale
        res["rel_t_p99"] = (float(torch.quantile(rel.double(), 0.99))
                            if rel.numel() else 0.0)
        res["max_abs_err"] = (float((t_k - t_p).abs()[same].max())
                              if rel.numel() else 0.0)
        t_ok = res["rel_t_p99"] <= BARS["rel_t_p99"]
        if mesh is not None:
            # raises if the kernel is further from float64 than plain
            witness(name, o, d, (t_k, tri_k, t_p, tri_p), kprim, *mesh)
            if not t_ok and t_scale == "origin":
                t_ok = True
                res["t_held_by"] = "float64 witness"
        ok = ok and res["prim_agree"] >= BARS["prim"] and t_ok
    else:
        # any-hit t is any true hit: the error is the share of rays whose
        # occluded-or-not differs
        res["max_abs_err"] = 1.0 - res["hit_agree"]
    res["ok"] = bool(ok)
    log("  ", json.dumps(res))
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {res}")
    return res


def compare(name, pk, o, d, live, nodef, kleaf, kprim, *, any_hit, stable,
            t_scale="t", mesh=None):
    """Kernel vs plain version on the same object-space rays (dead lanes
    of a masked wave parked as the wrapper parks them); judge()'s result."""
    kw = dict(any_hit=any_hit, stable=stable)
    if live is not None:
        o = torch.where(live[:, None], o, 1e30)
        d = torch.where(live[:, None], d, 1.0)
    t_k, tri_k = pk.packet_trace_cuda(o, d, live, nodef, kleaf, TMIN, TMAX, **kw)
    t_p, tri_p = pk._packet_trace_reference(o, d, live, nodef, kleaf, TMIN,
                                            TMAX, **kw)
    torch.cuda.synchronize()
    return judge(name, t_k, tri_k, t_p, tri_p, o, d, live, kprim,
                 any_hit=any_hit, t_scale=t_scale, mesh=mesh)


def witness(name, o, d, outs, kprim, verts, tris):
    """A second witness for t: recompute t in float64 from the mesh's own
    vertices for each ray where both versions hit the same prim, and
    report the kernel's and the plain version's errors against it.
    Fails if the kernel is more than WITNESS_RATIO times further off
    than the plain version at p99 of |err| / (|o| + t), with a floor of
    1e-6."""
    from radiance_tpu_torch.ops.intersect import intersect_triangle

    t_k, tri_k, t_p, tri_p = outs
    prim_k = kprim[tri_k.clamp(min=0).long()]
    prim_p = kprim[tri_p.clamp(min=0).long()]
    same = (t_k < 3.4e38) & (t_p < 3.4e38) & (prim_k == prim_p)
    if not bool(same.any()):
        raise AssertionError(f"{name}: no ray hit for the float64 witness")
    prim = prim_k[same].long().cpu().numpy()
    v = verts.astype(np.float64)[tris[prim].astype(np.int64)]
    v0, e1, e2 = (torch.from_numpy(x).to(o.device)
                  for x in (v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
    od, dd = o[same].double(), d[same].double()
    _, t64, _, _ = intersect_triangle(od, dd, v0, e1, e2)
    scale = t64.abs() + od.norm(dim=1)
    res = dict(name=name, rays=int(same.sum()))
    for who, t in (("kernel", t_k), ("plain", t_p)):
        err = (t[same].double() - t64).abs()
        res[f"{who}_abs_p99"] = float(torch.quantile(err, 0.99))
        res[f"{who}_abs_max"] = float(err.max())
        res[f"{who}_rel_origin_p99"] = float(torch.quantile(err / scale, 0.99))
    log("   f64 witness", json.dumps(res))
    if res["kernel_rel_origin_p99"] > max(
            WITNESS_RATIO * res["plain_rel_origin_p99"], 1e-6):
        raise AssertionError(f"kernel further from float64 than plain: {res}")
    return res


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time for `flops` FP32 operations
    and `nbytes` of device-memory traffic at the card's peaks."""
    f_ms, b_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (f_ms, "operations") if f_ms > b_ms else (b_ms, "bytes")


def pair_bound(stg, args, st, out, tq_bits=9):
    """Kernel D's or E's (bound, words, leaves) on one launch: the
    ray-triangle tests the function needs (the plain version's
    stats["tri_tests"]: D, the unparked rays of each kept (leaf, block)
    pair; E, each live ray not yet occluded under the reference's
    schedule; each against its leaf's triangle lanes) at 22 FMAs each,
    and the bytes of the features, the valid words, the leaves they name
    (each once) and the output; words of tq_bits."""
    words, emeta, _, feats, kleaf = args[:5]
    cnt = torch.clamp(emeta[:, 0], max=stg.PCAP)
    valid = (torch.arange(words.shape[1], device=words.device)[None, :]
             < cnt[:, None])
    nwords = int(cnt.sum())
    nleaves = int(torch.unique(
        stg.word_format(tq_bits).leaf(words[valid])).numel())
    return (bound(st["tri_tests"] * FLOPS_PER_PAIR,
                  feats.numel() * 4 + nwords * 4
                  + nleaves * kleaf[0].numel() * 4 + out.numel() * 4),
            nwords, nleaves)


def occl_launch(stg, args, out_k=None, tq_bits=9):
    """Kernel E on one launch's arguments (stage_isect's, then pcap and
    stable) against its plain version: times (CUDA events; none if out_k,
    the kernel's output of a recorded launch, is given), the plain
    version's stats, the bound, and occluded-or-not of both with the live
    slot lanes.  trace_rows_multi parks a sub-wave's dead lanes at origin
    1e30, so the live lanes are those with a nearer object-space origin;
    fails if a dead lane differs from the plain version.  Words of
    tq_bits."""
    live_rows = stg.unparked(args[3])
    live = live_rows.view(-1, stg.PKT)[args[2].long()]
    ms = None
    if out_k is None:
        ms, out_k = cuda_ms(lambda: stg.isect_occl_cuda(
            *args, tq_bits=tq_bits), 5)
    st = {}
    plain_ms, out_p = cuda_ms(lambda: stg._isect_occl_plain(
        *args, stats=st, live=live_rows, tq_bits=tq_bits), 1, warmup=False)
    if not bool((out_k == out_p).all(dim=2)[~live].all()):
        raise AssertionError("isect_occl differs from plain on a dead lane")
    b, nwords, nleaves = pair_bound(stg, args, st, out_k, tq_bits)
    return dict(st, ms=ms, plain_ms=plain_ms, bound=b, words=nwords,
                leaves=nleaves, live=live, occ_k=out_k[..., 0] == 0,
                occ_p=out_p[..., 0] == 0)


def isect_launch(stg, args, out_k=None, tq_bits=9):
    """Kernel D on one launch's arguments (stage_isect's, then pcap and
    stable) against its plain version: times (CUDA events; none if out_k,
    the kernel's output of a recorded launch, is given), the plain
    version's stats and the bound; both outputs' t and prim ([lanes]).
    Words of tq_bits."""
    ms = None
    if out_k is None:
        ms, out_k = cuda_ms(lambda: stg.isect_cuda(*args, tq_bits=tq_bits),
                            5)
    st = {}
    plain_ms, out_p = cuda_ms(lambda: stg._isect_plain(
        *args, stats=st, tq_bits=tq_bits), 1, warmup=False)
    b, nwords, nleaves = pair_bound(stg, args, st, out_k, tq_bits)
    return dict(st, ms=ms, plain_ms=plain_ms, bound=b, words=nwords,
                leaves=nleaves, t_k=out_k[..., 0].reshape(-1),
                prim_k=out_k[..., 1].reshape(-1),
                t_p=out_p[..., 0].reshape(-1),
                prim_p=out_p[..., 1].reshape(-1))


def hold_launches(name, runs):
    """hold_prims over the lanes of many isect_launch() results."""
    return hold_prims(name, *(torch.cat([r[k] for r in runs]) for k in
                              ("t_k", "prim_k", "t_p", "prim_p")))


def oscal_equal(out_k, out_p) -> bool:
    """Kernel F's four outputs (cand, present, full, bscal) equal its
    plain version's by value."""
    return (len(out_k) == len(out_p) == 4
            and all(values_equal(a, b) for a, b in zip(out_k, out_p)))


def oscal_bound(rows, live, out):
    """Kernel F's bytes bound: six f32 rows and the live bytes read once,
    its four outputs written once."""
    return bound(0, sum(r.numel() * 4 for r in rows)
                 + (0 if live is None else live.numel())
                 + sum(x.numel() * x.element_size() for x in out))


def oscal_launches(stg, calls, ms, where):
    """Kernel F's recorded launches, each held against its plain version
    on its recorded arguments: (kernel ms, plain ms, bounds) lists for
    summary()."""
    plain, bounds = [], []
    for _, a, _, out in calls:
        p_ms, ref = cuda_ms(lambda: stg._oscal_plain(*a), 1, warmup=False)
        if not oscal_equal(out, ref):
            raise AssertionError(f"oscal differs from plain on a {where} "
                                 f"launch")
        plain.append(p_ms)
        bounds.append(oscal_bound(a[0], a[1], out))
    return ms, plain, bounds


def emit_counts(stg, launches):
    """Kernel B's needed work on launches that share nodef, tmax, step_cap
    and step_rows ((scal, smeta, nodef, tmax, step_cap, step_rows) each),
    from the walk of all their slots (stream3_stages._walk_paths: only the
    slot-frustum test, on which the cursor depends), the cap counted as
    the kernel counts it: per launch, each slot's step windows (emeta lane
    2) and nodes visited, the visited leaves the slot frustum hits (each
    needs the 32 sub-frustum tests) and the distinct node rows
    visited."""
    _, _, nodef, tmax, step_cap, step_rows = launches[0]
    scal = torch.cat([x[0] for x in launches])
    smeta = torch.cat([x[1] for x in launches])
    sizes = [x[0].shape[0] for x in launches]
    dev, i64 = scal.device, torch.int64
    lid = torch.repeat_interleave(torch.arange(len(sizes), device=dev),
                                  torch.tensor(sizes, device=dev))
    steps, nodes, hits = (torch.zeros(scal.shape[0], dtype=i64, device=dev)
                          for _ in range(3))
    nrows = nodef.shape[0]
    # row nrows: no row (the rows a walk does not visit)
    seen = torch.zeros(len(sizes), nrows + 1, dtype=torch.bool, device=dev)
    for sl, base, row, _, hit, walked, st, _ in stg._walk_paths(
            nodef, scal, smeta, tmax, step_cap, step_rows):
        steps[sl] = st
        nodes[sl] = walked.sum(dim=1)
        hits[sl] = (walked & (row[..., 10] > 0.0) & hit).sum(dim=1)
        at = base[:, None] + torch.arange(walked.shape[1], device=dev)
        seen[lid[sl][:, None], torch.where(walked, at, nrows)] = True
    rows = seen[:, :nrows].sum(dim=1).tolist()
    return [(st, nd, int(h.sum()), r) for st, nd, h, r in
            zip(steps.split(sizes), nodes.split(sizes), hits.split(sizes),
                rows)]


def emit_bound(bscal, emeta, pcap, nodes, hit_leaves, rows):
    """Kernel B's (bound, nodes, words) on one launch from its emeta and
    emit_counts(): an interval test of ~30 FLOPs a visited node and 32
    more at each visited leaf the slot frustum hits; the 48 bytes B
    reads of each distinct node row visited, the words written, the slot
    rows and bscal read."""
    words = int(torch.clamp(emeta[:, 0], max=pcap).sum())
    return (bound((nodes + 32 * hit_leaves) * 30,
                  rows * 48 + words * 4
                  + emeta.shape[0] * (16 + 8 + 8) * 4 + bscal.numel() * 4),
            nodes, words)


def emit_args(stg, a, k):
    """The arguments of a recorded stage_emit call (args a, kwargs k) as
    emit_hold() and emit_bounds() take them: stage_emit's, then step_cap,
    pcap and step_rows."""
    return a + (k.get("step_cap", stg.STEP_CAP), k.get("pcap", stg.PCAP),
                k.get("step_rows", stg.STEP_ROWS))


def emit_bounds(stg, runs):
    """emit_bound() of each of runs ((stage_emit's arguments, then
    step_cap, pcap and step_rows: emit_args()), the kernel's emeta) and
    its longest walk in nodes, from emit_counts() over the launches that
    share nodef, tmax, step_cap and step_rows: (bound, nodes, words,
    longest walk's nodes) a run; fails unless the counted step windows
    are the kernel's."""
    groups = {}
    for j, (a, _) in enumerate(runs):
        groups.setdefault((a[3].data_ptr(), a[3].shape[0], float(a[4]),
                           int(a[5]), int(a[7])), []).append(j)
    out = [None] * len(runs)
    for js in groups.values():
        counts = emit_counts(stg, [runs[j][0][:2] + runs[j][0][3:6]
                                   + runs[j][0][7:8] for j in js])
        for j, (steps, nodes, hit_leaves, rows) in zip(js, counts):
            a, emeta = runs[j]
            if not torch.equal(steps, emeta[:, 2].to(torch.int64)):
                raise AssertionError("emit: the kernel's steps differ from "
                                     "a walk of each slot")
            out[j] = emit_bound(a[2], emeta, a[6], int(nodes.sum()),
                                hit_leaves, rows) + (int(nodes.max()),)
    return out


def refine_bound(stg, words_in, emeta, emeta_out, pcap, tq_bits=9):
    """Kernel C's (bound, words, kept) on one launch: 12 FLOPs a (ray,
    word) in the 128-ray blocks the word's keep bits name (the others
    cannot change the result); a word and its 32-byte box read and a kept
    word written, 24 bytes a ray of the blocks some word of its slot
    keeps, the slot rows; words of tq_bits."""
    cnt = torch.clamp(emeta[:, 0], max=pcap)
    valid = (torch.arange(words_in.shape[1], device=words_in.device)[None, :]
             < cnt[:, None])
    keep = torch.where(valid, stg.word_format(tq_bits).keep(words_in), 0)
    tests = blocks = 0
    for b in range(8):
        bit = (keep >> b) & 1
        tests += int(bit.sum())
        blocks += int(bit.any(dim=1).sum())
    words, kept = int(cnt.sum()), int(emeta_out[:, 0].sum())
    return (bound(tests * stg.BLK * 12, words * (4 + 32) + kept * 4
                  + blocks * stg.BLK * 24 + emeta.shape[0] * 64),
            words, kept)


def emit_hold(stg, args, out_k, tq_bits=9):
    """Kernel B's output (words, emeta) on emit_args()'s arguments
    (stage_emit's, then step_cap, pcap and step_rows) against
    _emit_plain's: emeta identical and the valid words identical, else
    fail.  Returns (plain ms, the plain walk's stats: step windows, nodes
    and kernel B's window loads).  Words of tq_bits."""
    st = {}
    p_ms, (wp, ep) = cuda_ms(lambda: stg._emit_plain(
        *args[:7], stats=st, tq_bits=tq_bits, step_rows=args[7]), 1,
        warmup=False)
    wk, ek = out_k
    diff = first_word_diff(wk, wp, torch.clamp(ep[:, 0], max=args[6]))
    if not torch.equal(ek, ep) or diff is not None:
        bad = torch.nonzero((ek != ep).any(1))
        raise AssertionError(f"emit: kernel and plain differ: first emeta "
                             f"slot {bad[:1].tolist()}, first word {diff}")
    return p_ms, st


def refine_hold(stg, args, out_k, tq_bits=9):
    """Kernel C's output (words', emeta') on stage_refine's arguments and
    then pcap, against _refine_plain's: emeta' and the kept words
    identical, else fail.  Returns the plain ms.  Words of tq_bits."""
    p_ms, (rp, rep) = cuda_ms(lambda: stg._refine_plain(
        *args, tq_bits=tq_bits), 1, warmup=False)
    rk, rek = out_k
    diff = first_word_diff(rk, rp, rep[:, 0])
    if not torch.equal(rek, rep) or diff is not None:
        raise AssertionError(f"refine: kernel and plain differ: {diff}")
    return p_ms


def chain_launches(stg, calls, ms, scene, held):
    """Kernels B and C on every recorded launch of one scene's frames
    (calls and ms: Calls.calls and launch_ms() of them, tags "scene" or
    "scene/wave"): each launch's kernel ms and bound, its chain length
    (B: the longest slot's step windows and nodes and the capped slots;
    C: the longest list), and for the launches held(emit rows) picks (indices into the
    scene's launches), the plain version's ms and B's window stats, each
    held against its plain version.  Returns {"emit": rows, "refine":
    rows}, a dict a launch."""
    pick = [i for i, c in enumerate(calls["emit"])
            if c[0].split("/")[0] == scene]
    if pick != [i for i, c in enumerate(calls["refine"])
                if c[0].split("/")[0] == scene]:
        raise AssertionError(f"{scene}: emit and refine launches unpaired")
    out = {"emit": [], "refine": []}
    bounds = emit_bounds(stg, [
        (emit_args(stg, a, k), res[1])
        for _, a, k, res in (calls["emit"][i] for i in pick)])
    for i, (b, nodes, words, max_nodes) in zip(pick, bounds):
        tag, a, k, (wk, ek) = calls["emit"][i]
        pcap = k.get("pcap", stg.PCAP)
        out["emit"].append(dict(
            tag=tag, ms=ms["emit"][i], bound=b, nodes=nodes, words=words,
            steps=int(ek[:, 2].sum()), longest_walk=int(ek[:, 2].max()),
            longest_walk_nodes=max_nodes, capped=int(ek[:, 1].sum()),
            longest_list=int(torch.clamp(ek[:, 0], max=pcap).max())))
        tag, ra, rk, (rw, re) = calls["refine"][i]
        b, words, kept = refine_bound(stg, ra[0], ra[1], re,
                                      rk.get("pcap", stg.PCAP))
        out["refine"].append(dict(
            tag=tag, ms=ms["refine"][i], bound=b, words=words, kept=kept,
            longest_list=int(re[:, 4].max()),
            chunks=int(((re[:, 4] + 31) // 32).sum())))
    for j in held(out["emit"]):
        i = pick[j]
        _, a, k, res = calls["emit"][i]
        p_ms, st = emit_hold(stg, emit_args(stg, a, k), res)
        out["emit"][j].update(plain_ms=p_ms, **st)
        _, ra, rk, res = calls["refine"][i]
        feats_t = torch.zeros(16, ra[3].shape[1], device=ra[3].device)
        feats_t[REFINE_ROWS] = ra[3]
        out["refine"][j]["plain_ms"] = refine_hold(
            stg, ra[:3] + (feats_t,) + ra[4:] + (rk.get("pcap", stg.PCAP),),
            res)
    return out


def log_chains(scene, bc, card):
    """Log chain_launches() results: each launch's kernel ms and chain
    length (B: [ms, longest walk in step windows and in nodes, capped
    slots]; C: [ms, longest list]), then per wave (tag) and in all, B's
    and C's summaries."""
    for kind, name, keys in (
            ("emit", "B (stream3_emit)", ("longest_walk",
                                          "longest_walk_nodes", "capped")),
            ("refine", "C (stream3_refine)", ("longest_list",))):
        rows = bc[kind]
        log(f"    {name} per launch on {scene}, [ms, {', '.join(keys)}]: "
            f"{json.dumps([[round(r['ms'], 4)] + [r[k] for k in keys] for r in rows])}")
        groups = {}
        for r in rows:
            groups.setdefault(r["tag"], []).append(r)
        for tag, grp in [(scene, rows)] + (
                sorted(groups.items()) if len(groups) > 1 else []):
            res = chain_summary(grp, kind)
            log_summary(f"{name} over {tag}'s launches", res, card)
            log(f"      chain: {json.dumps({k: v for k, v in res.items() if k in CHAIN_KEYS})}")


def multi_held(rows):
    """The multi64 launches held against plain: every MULTI_HOLD_STRIDE-th,
    and in each wave the longest walk's and the longest list's."""
    keep = set(range(0, len(rows), MULTI_HOLD_STRIDE))
    for tag in {r["tag"] for r in rows}:
        wave = [j for j, r in enumerate(rows) if r["tag"] == tag]
        keep.add(max(wave, key=lambda j: rows[j]["longest_walk"]))
        keep.add(max(wave, key=lambda j: rows[j]["longest_list"]))
    return sorted(keep)


def chain_summary(rows, kind):
    """summary() of chain_launches() rows of one kernel ("emit" or
    "refine") and the chain lengths: B's longest walk (step windows and
    nodes), capped slots, step windows and nodes, and nodes visited a
    window load (from the held launches' plain walks);
    C's longest list and kept words.  The plain version's keys are only
    the held launches': plain_ms their mean, plain_ms_sum their sum,
    plain_held their number."""
    held = [r["plain_ms"] for r in rows if "plain_ms" in r]
    res = summary([r["ms"] for r in rows], [], [r["bound"] for r in rows])
    res.update(plain_ms=sum(held) / max(len(held), 1),
               plain_ms_sum=sum(held), plain_held=len(held),
               words=sum(r["words"] for r in rows),
               longest_list=max(r["longest_list"] for r in rows))
    if kind == "refine":    # chunks: C's 32-word work items a launch
        res.update(kept=sum(r["kept"] for r in rows),
                   chunks_per_launch=sum(r["chunks"] for r in rows)
                   / len(rows),
                   max_chunks=max(r["chunks"] for r in rows))
        return res
    held = [r for r in rows if "plain_ms" in r]
    loads = sum(r["window_loads"] for r in held)
    res.update(longest_walk=max(r["longest_walk"] for r in rows),
               longest_walk_nodes=max(r["longest_walk_nodes"]
                                      for r in rows),
               capped=sum(r["capped"] for r in rows),
               steps=sum(r["steps"] for r in rows),
               nodes=sum(r["nodes"] for r in rows),
               held_window_loads=loads,
               held_max_window_loads=max(r["max_window_loads"]
                                         for r in held),
               nodes_per_load=sum(r["nodes"] for r in held) / max(loads, 1))
    return res


# the kernels of each counted wrapper, by a substring of their names, in
# the order one call launches them
FAMILIES = {
    "packet_trace": ("packet_trace_kernel",),
    "emit": ("emit_window_kernel",),
    "refine": ("refine_scan_kernel", "refine_test_kernel",
               "refine_compact_kernel"),
    "isect": ("isect_keys", "isect_kernel<", "isect_finish"),
    "isect_occl": ("fill_miss", "isect_occl_kernel"),
    "oscal": ("oscal_kernel",),
}
# profiled(): the tries of one profile that lost kernel records
PROFILE_TRIES = 3
# the feature rows kernel C reads (d, then o): a recorded refine call
# keeps only these
REFINE_ROWS = [0, 1, 2, 6, 7, 8]
# the multi64 frame's launches of B and C held against their plain
# versions: every MULTI_HOLD_STRIDE-th, and in each wave the launch with
# the longest walk and the launch with the longest list
MULTI_HOLD_STRIDE = 16
# B and C on the city frames: every CITY_HOLD_STRIDE-th launch held
CITY_HOLD_STRIDE = 2
# chain_summary()'s keys beyond summary()'s
CHAIN_KEYS = ("plain_held", "words", "kept", "longest_list",
              "chunks_per_launch", "max_chunks", "longest_walk",
              "longest_walk_nodes", "capped", "steps", "nodes",
              "held_window_loads", "held_max_window_loads",
              "nodes_per_load")


class Calls:
    """Record the calls of the port's kernel dispatchers that launch a
    kernel (packet_trace.packet_trace; stream3's stage_emit,
    stage_refine, stage_isect, by occl, and octant_scalars): per wrapper
    key, a list of (tag, args, kwargs, output).  `tag` is set by the
    caller (the scene being rendered).  A refine call keeps REFINE_ROWS
    of its features, copied.  names, if given, limits the recorded
    dispatchers; with keep_args False a call keeps only its output."""

    def __init__(self, pk, s3, names=None, keep_args=True):
        self.sites = tuple(
            (m, n) for m, n in ((pk, "packet_trace"), (s3, "stage_emit"),
                                (s3, "stage_refine"), (s3, "stage_isect"),
                                (s3, "octant_scalars"))
            if names is None or n in names)
        self.keep_args = keep_args
        # the wrapper keys the recorded dispatchers can give (launch_ms
        # holds each key's kernel records to its calls)
        keys = {"packet_trace": ("packet_trace",), "stage_emit": ("emit",),
                "stage_refine": ("refine",),
                "stage_isect": ("isect", "isect_occl"),
                "octant_scalars": ("oscal",)}
        self.calls = {k: [] for _, n in self.sites for k in keys[n]}
        self.tag = None

    @staticmethod
    def key(name, a, k):
        if name == "packet_trace":
            return "packet_trace" if a[0].shape[0] else None
        if name in ("stage_emit", "stage_refine"):
            return name[6:] if a[0].shape[0] else None
        if name == "stage_isect":
            return (("isect_occl" if k.get("occl") else "isect")
                    if a[0].shape[0] else None)
        return "oscal" if a[2] else None

    def __enter__(self):
        self.orig = [getattr(m, n) for m, n in self.sites]

        def hook(name, fn):
            def wrapper(*a, **k):
                out = fn(*a, **k)
                key = self.key(name, a, k)
                if key and not self.keep_args:
                    self.calls[key].append((self.tag, None, None, out))
                elif key:   # masks copied: a caller may reuse its own
                    a = tuple(x.clone() if isinstance(x, torch.Tensor)
                              and x.dtype == torch.bool else x for x in a)
                    if key == "refine":
                        a = a[:3] + (a[3][REFINE_ROWS],) + a[4:]
                    self.calls[key].append((self.tag, a, dict(k), out))
                return out
            return wrapper

        for (m, n), fn in zip(self.sites, self.orig):
            setattr(m, n, hook(n, fn))
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.sites, self.orig):
            setattr(m, n, fn)


@contextlib.contextmanager
def cuda_profile():
    """torch.profiler over the CUDA activity, warmed by one small kernel
    and a synchronize before the caller's work, and closed by a
    synchronize.  CUPTI can still drop a kernel's record, at a profile's
    first kernel or inside one of 80,000 records: launch_ms then raises
    MissingRecords and profiled() takes the profile again."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def kernel_records(prof):
    """torch.profiler's device records: (name, start ns, duration ns) in
    launch order."""
    return sorted(((e.name(), e.start_ns(), e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA),
                  key=lambda r: r[1])


class MissingRecords(AssertionError):
    """A profile holds fewer kernel records than its recorded calls."""


def launch_ms(prof, calls):
    """Device ms of each recorded call's kernels, from torch.profiler's
    kernel records in launch order: {wrapper key: [ms per call]}; raises
    MissingRecords unless every call has its kernels."""
    recs = kernel_records(prof)
    out = {}
    for key in calls:
        subs = FAMILIES[key]
        mine = [r for r in recs if any(x in r[0] for x in subs)]
        k = len(subs)
        if len(mine) != k * len(calls[key]):
            raise MissingRecords(
                f"{key}: {len(mine)} kernel records for {len(calls[key])} "
                f"calls ({len(recs)} device records in the profile; first "
                f"{recs[:2]})")
        out[key] = [sum(r[2] for r in mine[i:i + k]) / 1e6
                    for i in range(0, len(mine), k)]
    return out


def profiled(pk, s3, fn, keep_args=True, names=None):
    """fn(calls) with every kernel dispatcher's call (of `names`, where
    given) recorded (Calls) under cuda_profile(): (fn's result,
    Calls.calls, launch_ms()).  A profile
    that lost a call's kernel records is taken again, fn and all, with a
    fresh Calls, up to PROFILE_TRIES in all; the last one's
    MissingRecords is raised.  Every try's launches are real launches: a
    caller that counts them counts them all."""
    for i in range(PROFILE_TRIES):
        with Calls(pk, s3, names=names, keep_args=keep_args) as calls, \
                cuda_profile() as prof:
            out = fn(calls)
            torch.cuda.synchronize()
        try:
            return out, calls.calls, launch_ms(prof, calls.calls)
        except MissingRecords as e:
            if i + 1 == PROFILE_TRIES:
                raise
            log(f"    profile {i + 1} of {PROFILE_TRIES} lost kernel "
                f"records, taken again: {e}")
        finally:
            del prof


def summary(ms, plain_ms, bounds):
    """Per-launch means and sums of kernel ms, plain ms and bounds."""
    n = max(len(ms), 1)
    by = {}
    for b in bounds:
        by[b[1]] = by.get(b[1], 0.0) + b[0]
    return dict(launches=len(ms), ms=sum(ms) / n, ms_sum=sum(ms),
                plain_ms=sum(plain_ms) / n, plain_ms_sum=sum(plain_ms),
                bound_ms=sum(by.values()) / n, bound_ms_sum=sum(by.values()),
                bound_by=max(by, key=by.get) if by else "operations")


def log_summary(name, r, card):
    log(f"    {name} ({card}): {r['launches']} launches, {r['ms']:.4f} ms "
        f"mean ({r['ms_sum']:.3f} ms in all), plain {r['plain_ms']:.3f} ms "
        f"mean, bound {r['bound_ms']:.4f} ms mean ({r['bound_ms_sum']:.3f} "
        f"in all, {r['bound_by']}), "
        f"{r['bound_ms_sum'] / max(r['ms_sum'], 1e-12):.3f} of it")


def packet_bounds(name, pk, calls, stride):
    """The packet kernel's plain version on a group of recorded launches
    that share a variant and tables: one plain walk over every stride-th
    whole 1024-ray packet of each launch, concatenated (packets walk
    independently, so each packet's counts and results are those of its
    own launch).  The walk's (t, tri) are held by judge() against the
    kernel's recorded output on the same rays, on |dt| / (|o| + t) (the
    group may be a bounce wave).  Returns (the walk's ms, the group's
    summed bound, judge()'s result): the ray-triangle tests scaled by the
    launches' rays over the rays walked; the bytes of every launch's rays
    in and out and of the node rows (64 B) and leaf matrices the walked
    packets touch, once -- a lower bound on the sum of the launches' own
    bounds."""
    parts, outs, n_all = [], [], 0
    for _, a, _, out in calls:
        n = a[0].shape[0]
        n_all += n
        pkt = torch.arange(n, device=a[0].device) // pk.PACKET
        keep = (pkt % stride == 0) & (pkt < max(n // pk.PACKET, 1))
        parts.append([None if x is None else x[keep] for x in a[:3]])
        outs.append([x[keep] for x in out])
    cols = [None if parts[0][i] is None else torch.cat([p[i] for p in parts])
            for i in range(3)]
    t_k, tri_k = (torch.cat([x[i] for x in outs]) for i in range(2))
    _, a, k, _ = calls[0]
    st = {}
    p_ms, (t_p, tri_p) = cuda_ms(lambda: pk._packet_trace_reference(
        *cols, *a[3:], **k, stats=st), 1, warmup=False)
    res = judge(name, t_k, tri_k, t_p, tri_p, cols[0], cols[1], cols[2],
                None, any_hit=k["any_hit"], t_scale="origin")
    scale = n_all / max(cols[0].shape[0], 1)
    return p_ms, bound(st["ray_leaf_tris"] * scale * FLOPS_PER_PAIR,
                       n_all * 32 + st["node_rows"] * 64
                       + st["leaves"] * a[4][0].numel() * 4), res


def hold_prims(name, t_k, prim_k, t_p, prim_p):
    """judge() for outputs that carry prim ids (stream3): hit agreement,
    prim agreement on rays both hit, p99 relative |dt| where the prims
    agree, each to BARS; returns the result dict."""
    hk, hp = t_k < 3.4e38, t_p < 3.4e38
    both = hk & hp
    same = both & (prim_k == prim_p)
    nb = int(both.sum())
    rel = ((t_k - t_p).abs() / t_p.abs().clamp(min=1e-30))[same]
    res = dict(name=name, rays=int(t_k.numel()),
               hit_rate=float(hp.float().mean()),
               hit_agree=float((hk == hp).float().mean()),
               prim_agree=float(same.sum()) / nb if nb else 1.0,
               rel_t_p99=(float(torch.quantile(rel.double(), 0.99))
                          if rel.numel() else 0.0),
               max_abs_err=(float((t_k - t_p).abs()[same].max())
                            if rel.numel() else 0.0))
    res["ok"] = bool(res["hit_agree"] >= BARS["hit"]
                     and res["prim_agree"] >= BARS["prim"]
                     and res["rel_t_p99"] <= BARS["rel_t_p99"]
                     and res["hit_rate"] > 0.0)
    log("  ", json.dumps(res))
    if not res["ok"]:
        raise AssertionError(f"{name} disagrees: {res}")
    return res


def hold_occluded(name, occ_k, occ_p, live, need_occluded=True):
    """Occluded-or-not of two tracers on the live rays only (dead lanes
    miss on both sides and would dilute the bar): agreement over the live
    rays, and over the rays that either side calls occluded, each to
    BARS["hit"]; with need_occluded, some ray must be occluded.  Returns
    the result dict."""
    k, p = occ_k[live], occ_p[live]
    dis = int((k != p).sum())
    either = int((k | p).sum())
    res = dict(name=name, live=int(k.numel()), occluded=int(p.sum()),
               disagree=dis, live_agree=1.0 - dis / max(k.numel(), 1),
               occluded_agree=1.0 - dis / max(either, 1))
    res["ok"] = bool(res["live_agree"] >= BARS["hit"]
                     and res["occluded_agree"] >= BARS["hit"]
                     and (res["occluded"] > 0 or not need_occluded))
    log("  ", json.dumps(res))
    if not res["ok"]:
        raise AssertionError(f"{name} disagrees: {res}")
    return res


def first_word_diff(wk, wp, cnt):
    """(slot, word index, leaf) of the first differing valid word."""
    valid = torch.arange(wk.shape[1], device=wk.device)[None, :] \
        < cnt[:, None]
    bad = torch.nonzero((wk != wp) & valid)
    if bad.numel() == 0:
        return None
    s, j = (int(v) for v in bad[0])
    return dict(slot=s, word=j, kernel=int(wk[s, j]), plain=int(wp[s, j]),
                leaf=(int(wp[s, j]) >> 17) - 1)


def call_spans(mod, names, fn, keep=None):
    """Run fn() with CUDA events around each call of the functions `names`
    of module `mod`.  Returns (fn's result, {name: [ms of each call]},
    {name: args of its largest call}) where keep maps a name to the size
    function of its arguments that picks that call."""
    spans = {n: [] for n in names}
    kept = {}
    orig = {n: getattr(mod, n) for n in names}

    def timed(n, f):
        def wrapper(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = f(*a, **k)
            ev[1].record()
            spans[n].append(ev)
            if keep and n in keep:
                size = keep[n](*a)
                if n not in kept or size > kept[n][0]:
                    kept[n] = (size, a)
            return out
        return wrapper

    for n in names:
        if hasattr(orig[n], "launches"):
            raise ValueError(f"{n} is a counted kernel wrapper: time its "
                             f"call site instead")
        setattr(mod, n, timed(n, orig[n]))
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for n in names:
            setattr(mod, n, orig[n])
    ms = {n: [a.elapsed_time(b) for a, b in v] for n, v in spans.items()}
    return out, ms, {n: v[1] for n, v in kept.items()}


def stage_spans(s3, fn):
    """Run fn() with CUDA events around the stream3 module's stages;
    returns (fn's result, {stage: summed ms}).  "residual" is the
    trace_rows_stream3 time outside _run (flagged re-walk, masking)."""
    names = ("_stage_prep", "stage_emit", "stage_refine",
             "feats_rows_to_major", "stage_isect", "_stage_glue", "_run",
             "trace_rows_stream3", "rows_from_aos_fast")
    out, ms, _ = call_spans(s3, names, fn)
    ms = {n: sum(v) for n, v in ms.items()}
    ms["residual"] = ms["trace_rows_stream3"] - ms["_run"]
    return out, ms


def values_equal(a, b) -> bool:
    """Equal shapes and dtypes and equal values, NaN matching NaN (+0 and
    -0 compare equal)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def pcg3d_words_np(v):
    """numpy uint32 oracle of the PCG3D hash words (math.cl:10-23)."""
    v = v.astype(np.uint32) * np.uint32(1664525) + np.uint32(1013904223)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x ^= x >> np.uint32(16)
    y ^= y >> np.uint32(16)
    z ^= z >> np.uint32(16)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return np.stack([x, y, z], -1)


def make_tracer():
    """The sample1 pipeline's tracer: physical camera + built-in shaders."""
    from radiance_tpu_torch.api.sbt import ShaderBindingTable
    from radiance_tpu_torch.engine import shaders
    from radiance_tpu_torch.engine.pathtracer import WavefrontPathTracer
    from radiance_tpu_torch.shading import camera

    sbt = ShaderBindingTable.from_json(shaders.DEFAULT_SBT_RECORDS,
                                       shaders.SHADER_REGISTRY)
    return WavefrontPathTracer(ray_generator=camera.physical_camera_raygen,
                               sbt=sbt)


def city_resources(dev, verts, tris, w, h, mesh_infos=None,
                   eye=(0.0, 0.0, 140.0),
                   light=(0.26726124, 0.8017837, 0.5345225)):
    """bench._engine_setup's bindings and camera, on the port; mesh_infos
    (default: one mesh) map instance ids to the meshes of verts/tris.
    eye: the pinhole camera's position (it looks down -z); light: the
    directional light's travel direction."""
    from radiance_tpu_torch.core import types
    from radiance_tpu_torch.scene import bindings
    from radiance_tpu_torch.shading import camera

    tris = tris.astype(np.uint32)
    fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                  verts[tris[:, 2]] - verts[tris[:, 0]])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-9)
    normals = np.repeat(fn, 3, axis=0).astype(np.float32)
    res = bindings.make_scene_bindings(
        mesh_infos or [types.MeshInfo()], verts, tris, np.zeros_like(verts),
        normals,
        [types.Material(albedo=(0.7, 0.7, 0.7, 1.0), roughness=0.6)],
        types.SceneProperties(lights=[types.DirLight(
            direction=(*light, 0.0), color=(3.0, 3.0, 3.0, 1.0))]),
        device=dev)
    res["camera"] = camera.camera_params(types.PhysicalCamera(
        width_pixel=float(w), height_pixel=float(h), focal_length=0.035,
        sensor_width=0.05, focal_distance=80.0, x=eye[0], y=eye[1],
        z=eye[2]), dev)
    return res


def multi64_scene(dev, w, h):
    """bench._build_multi_tlas's scene on the port's accel (seed 11: 8
    unique BLASes of MULTI_TRIS / 64 triangles in 40 clusters, each
    instanced 8 times across a 100-unit extent) and city-style bindings:
    one mesh entry per instance, pointing at its BLAS's mesh.  Returns
    (DeviceScene, resources, TopAccelStruct)."""
    from radiance_tpu_torch.api import accel
    from radiance_tpu_torch.core import types

    rng = np.random.default_rng(11)
    n_unique, n_copies, n_cl = 8, 8, 40
    per = MULTI_TRIS // (n_unique * n_copies) // n_cl
    meshes = []
    for _ in range(n_unique):
        centers = rng.uniform(-6, 6, size=(n_cl, 3)).astype(np.float32)
        verts_all = []
        for c in centers:
            local = rng.uniform(-1.5, 1.5, size=(per, 3)).astype(np.float32)
            offs = rng.normal(scale=0.08, size=(per, 3, 3)).astype(np.float32)
            verts_all.append((c + local)[:, None, :] + offs)
        meshes.append(np.concatenate(verts_all).reshape(-1, 3))
    blases = [accel.BuildBottomAccelStruct(types.Mesh(
        v, np.arange(len(v), dtype=np.uint32).reshape(-1, 3))) for v in meshes]
    instances, infos = [], []
    for b in range(n_unique):
        v_off = sum(len(v) for v in meshes[:b])
        for _ in range(n_copies):
            tf = np.eye(4, dtype=np.float32)
            tf[:3, 3] = rng.uniform(-44, 44, 3).astype(np.float32)
            instances.append(types.Instance(tf, 0, len(instances), blases[b]))
            # offsets in scalars; a mesh of v vertices has v / 3 triangles
            infos.append(types.MeshInfo(vertex_offset=3 * v_off,
                                        index_offset=v_off,
                                        uv_offset=3 * v_off,
                                        normal_offset=3 * v_off))
    tlas = accel.BuildTopAccelStruct(instances)
    tris = np.concatenate([np.arange(len(v), dtype=np.uint32).reshape(-1, 3)
                           for v in meshes])
    return tlas.device_scene(dev), city_resources(
        dev, np.concatenate(meshes), tris, w, h, mesh_infos=infos), tlas


def cornell_inputs(dev, size):
    """sample1's Cornell box, camera and light (samples/sample1.py)."""
    from radiance_tpu_torch.core import types
    from radiance_tpu_torch.scene import procedural
    from radiance_tpu_torch.shading import camera

    host = procedural.cornell_box(light_dir=(0.3, -1.0, -0.4), device=dev)
    res = dict(host.resources)
    res["camera"] = camera.camera_params(types.PhysicalCamera(
        width_pixel=float(size), height_pixel=float(size),
        focal_length=0.035, sensor_width=0.05, focal_distance=8.0, z=4.0),
        dev)
    return host.device_scene(dev), res


def check_frame(name, accum, image, n):
    mean = float(accum.mean())
    finite = bool(torch.isfinite(accum).all())
    std = float(image[..., :3].float().std())
    log(f"  {name}: accum mean {mean:.6f} finite {finite} image std {std:.3f}")
    if not finite or std <= 1.0 or image.shape[0] * image.shape[1] != n:
        raise AssertionError(f"{name}: bad frame (finite={finite}, std={std})")
    return mean


# ---- phase 8: the RD API --------------------------------------------------

class RDFrames:
    """Wrap the pipeline module's TraceRays while the block runs: each
    call's host ms (ended by a synchronize), the totalSamples it read,
    the accumulator and image it left on the device, and the resource
    dict its build_resources made."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.ms, self.total_samples = [], []
        self.accum = self.image = self.resources = None

    def __enter__(self):
        self.orig = orig = self.pipeline.TraceRays
        self.orig_res = build = self.pipeline.build_resources
        from radiance_tpu_torch.core import types

        def built(*a, **k):
            self.resources = build(*a, **k)
            return self.resources

        def traced(plt, raygen, *a):
            prog = plt.active_pipeline.modules[raygen]
            h = dict(zip(prog.descriptor_semantics, plt.bound_descriptor_set))
            rt = np.frombuffer(h["rtprop"].read(),
                               types.RAY_TRACE_PROPERTIES_DTYPE)
            self.total_samples.append(int(rt["totalSamples"][0]))
            t0 = time.time()
            orig(plt, raygen, *a)
            torch.cuda.synchronize()
            self.ms.append((time.time() - t0) * 1e3)
            self.accum = h["image_scratch"].device_value
            self.image = h["image"].device_value

        self.pipeline.TraceRays = traced
        self.pipeline.build_resources = built
        return self

    def __exit__(self, *exc):
        self.pipeline.TraceRays = self.orig
        self.pipeline.build_resources = self.orig_res


def launch_counts(pk, stg):
    """The kernel wrappers' launch counts: the packet kernel's by variant
    (packet_trace[<variant>]) and the stream3 kernels' by stage key."""
    out = {f"packet_trace[{k}]": v
           for k, v in pk.packet_trace_cuda.launches.items()}
    out.update({k: fn.launches for k, fn in stg.KERNELS.items()})
    out.update({"refine[tqsort]": stg.refine_cuda.sort_launches,
                "isect[lean]": stg.isect_cuda.lean_launches,
                "isect[cull]": stg.isect_cuda.cull_launches})
    return out


def reset_counts(pk, stg):
    pk.packet_trace_cuda.launches.clear()
    stg.reset_launches()


def direct_frames(tracer, scene, res, w, h, batch, depth, frames):
    """`frames` WavefrontPathTracer.render frames from a zero accumulator,
    totalSamples advancing by batch, as sample1's loop does; returns
    (accum, image, [host ms of each frame])."""
    acc = torch.zeros(w * h, 3, device=scene.device)
    ms = []
    for f in range(frames):
        t0 = time.time()
        acc, img = tracer.render(scene, res, acc, batch * f, w, h,
                                 batch=batch, depth=depth)
        torch.cuda.synchronize()
        ms.append((time.time() - t0) * 1e3)
    return acc, img, ms


def rd_gate(name, rd, direct, tracer, scene, shape, card):
    """The RD route's accumulator against the first of two direct renders
    of the same scene, resources and camera: at least as close as the two
    direct renders are to each other.  Then the same frames rendered
    directly with the reference sample's 4x4 placeholder image array in
    the resources (the port binds none where the scene has no textures):
    what that placeholder costs the shaders, which then sample it."""
    d_rd = float((rd.accum - direct[0][0]).abs().max())
    d_dd = float((direct[1][0] - direct[0][0]).abs().max())
    px = int((rd.image != direct[0][1]).any(-1).sum())
    log(f"    {name}: RD accum vs direct, max |diff| {d_rd:.3e}; direct vs "
        f"direct {d_dd:.3e}; RD image pixels differing from direct {px}")
    if d_rd > d_dd:
        raise AssertionError(f"{name}: the RD route's accum differs from a "
                             f"direct render ({d_rd}) more than two direct "
                             f"renders differ ({d_dd})")
    if rd.resources["textures"] is None:
        res = dict(rd.resources, textures=torch.zeros(
            1, 4, 4, 4, dtype=torch.uint8, device=rd.accum.device))
        acc, _, ms = direct_frames(tracer, scene, res, *shape)
        log(f"    {name} ({card}): direct frames with the 4x4 placeholder "
            f"image array bound {', '.join(f'{m:.1f}' for m in ms)} ms "
            f"(without: {', '.join(f'{m:.1f}' for m in direct[0][2])}, "
            f"{', '.join(f'{m:.1f}' for m in direct[1][2])}; RD "
            f"{', '.join(f'{m:.1f}' for m in rd.ms)}); accum max |diff| "
            f"to the RD route's {float((acc - rd.accum).abs().max()):.3e}")


def scene_diffs(a, b):
    """Names of the DeviceScene fields (tensors, kblas tuples, the frame
    mode) in which two scenes differ (shape, dtype or value)."""
    def same(x, y):
        if isinstance(x, torch.Tensor):
            return isinstance(y, torch.Tensor) and values_equal(x, y)
        if isinstance(x, (tuple, list)):
            return (isinstance(y, (tuple, list)) and len(x) == len(y)
                    and all(same(u, v) for u, v in zip(x, y)))
        return x == y

    return [f.name for f in dataclasses.fields(a) if f.name != "multi"
            and not same(getattr(a, f.name), getattr(b, f.name))]


def host_seconds(mod, names, fn):
    """Run fn() with each call of module mod's functions `names` timed on
    the host clock; returns (fn's result, {name: seconds, summed})."""
    secs = {n: 0.0 for n in names}
    orig = {n: getattr(mod, n) for n in names}

    def timed(n, f):
        def wrapper(*a, **k):
            t0 = time.time()
            try:
                return f(*a, **k)
            finally:
                secs[n] += time.time() - t0
        return wrapper

    for n in names:
        setattr(mod, n, timed(n, orig[n]))
    try:
        return fn(), secs
    finally:
        for n in names:
            setattr(mod, n, orig[n])


def check_kernels(name, calls, counts, need):
    """Fail unless each kernel of `need` ran: a Calls key must have
    recorded calls, as many as its wrapper counted; "aos_rows" and
    "transpose" (kernel A's two wrappers, which Calls does not record)
    must have counted launches."""
    for key in need:
        if key in ("aos_rows", "transpose"):
            if counts[key] <= 0:
                raise AssertionError(f"{name}: kernel A ({key}) was not "
                                     f"launched")
            continue
        got = len(calls.calls[key])
        want = (sum(v for k, v in counts.items()
                    if k.startswith("packet_trace["))
                if key == "packet_trace" else counts[key])
        if got <= 0 or got != want:
            raise AssertionError(f"{name}: {key} recorded {got} calls, "
                                 f"counted {want} launches")


def rd_api(dev, card, verts, tris, pk, s3, s3m, stg):
    """Phase 8: the port's RD-style API (Platform, buffers, pipeline,
    TraceRays, the loader and the TLAS file round trip) on sample1's
    Cornell box, the 1M-triangle city as a GLB through the loader and its
    AS cache, and sample2.  Returns {path: launch counts of its run}."""
    from radiance_tpu_torch.api import accel, pipeline, platform
    from radiance_tpu_torch.core import types
    from radiance_tpu_torch.engine import programs
    from radiance_tpu_torch.samples import sample1, sample2
    from radiance_tpu_torch.scene import glb_writer, gltf, loader, procedural
    from radiance_tpu_torch.shading import camera

    plt = platform.Platform.GetPlatform(dev)
    tracer = programs.sample1_program().tracer
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) sample1: the Cornell box, 512x512, batch 16, depth 4, 2 frames
        host = procedural.cornell_box(light_dir=(0.3, -1.0, -0.4),
                                      device=plt.device)
        cam = sample1.sample1_camera(CW, CW)
        torch.cuda.synchronize()
        reset_counts(pk, stg)
        with RDFrames(pipeline) as rd, Calls(pk, s3, keep_args=False) as calls:
            sample1.render_sample1(CW, CW, 16, 4, 2, scene=host,
                                   out=os.path.join(tmp, "s1.png"))
        counts["sample1"] = launch_counts(pk, stg)
        check_kernels("sample1", calls, counts["sample1"], ["packet_trace"])
        del calls
        res = dict(host.resources, camera=camera.camera_params(cam, dev))
        direct = [direct_frames(tracer, host.device_scene(dev), res, CW, CW,
                                16, 4, 2) for _ in range(2)]
        log(f"[8] (a) sample1 RD route, Cornell {CW}x{CW} batch 16 depth 4 "
            f"({card}): frames {', '.join(f'{m:.1f}' for m in rd.ms)} ms "
            f"(totalSamples {rd.total_samples}); direct "
            f"{', '.join(f'{m:.1f}' for m in direct[0][2])} ms; launches "
            f"{counts['sample1']}")
        if rd.total_samples != [0, 16]:
            raise AssertionError(f"sample1: totalSamples {rd.total_samples}")
        rd_gate("sample1", rd, direct, tracer, host.device_scene(dev),
                (CW, CW, 16, 4, 2), card)
        check_frame("sample1 RD", rd.accum, rd.image, CW * CW)
        del host, direct, rd

        # (b) the city as a GLB: write, load twice through the AS cache
        # (build and write .cache, then load from it), render through
        # TraceRays
        fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                      verts[tris[:, 2]] - verts[tris[:, 0]])
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-9)
        path = os.path.join(tmp, "city.glb")
        t0 = time.time()
        glb_writer.write_glb(path, [dict(
            positions=verts, normals=np.repeat(fn, 3, axis=0).astype(
                np.float32), indices=tris, material=0)], [dict(
                    baseColorFactor=(0.7, 0.7, 0.7, 1.0), metallicFactor=0.0,
                    roughnessFactor=0.6)])
        t_write = time.time() - t0
        t0 = time.time()
        gltf.parse_glb(path)
        t_parse = time.time() - t0

        def load():
            return loader.load_scene(path, use_cache=True, verbose=False,
                                     device=dev)

        t0 = time.time()
        built, s_build = host_seconds(accel, ["BuildBottomAccelStruct",
                                              "BuildTopAccelStruct",
                                              "TopAccelStructToFile"], load)
        t_load1 = time.time() - t0
        t0 = time.time()
        cached, s_cache = host_seconds(accel, ["FileToTopAccelStruct"], load)
        t_load2 = time.time() - t0
        if cached.instances or not built.instances:
            raise AssertionError("city GLB: the second load did not come "
                                 "from the AS cache")
        t0 = time.time()
        scene_b = built.device_scene(dev)
        torch.cuda.synchronize()
        t_tab1 = time.time() - t0
        t0 = time.time()
        scene_c = cached.device_scene(dev)
        torch.cuda.synchronize()
        t_tab2 = time.time() - t0
        diffs = scene_diffs(scene_b, scene_c)
        log(f"[8] (b) city GLB ({len(tris)} triangles, "
            f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, cache "
            f"{os.path.getsize(path + '.cache') / 2 ** 20:.1f} MiB): write "
            f"{t_write:.2f} s, GLB parse {t_parse:.2f} s; load_scene with "
            f"the SAH build {t_load1:.2f} s (BLAS build "
            f"{s_build['BuildBottomAccelStruct']:.2f} s, TLAS build "
            f"{s_build['BuildTopAccelStruct']:.3f} s, cache write "
            f"{s_build['TopAccelStructToFile']:.2f} s); load_scene from the "
            f"cache {t_load2:.2f} s (FileToTopAccelStruct "
            f"{s_cache['FileToTopAccelStruct']:.2f} s); device tables "
            f"{t_tab1:.2f} s built, {t_tab2:.2f} s cache-loaded; fields "
            f"differing {diffs}")
        if diffs:
            raise AssertionError(f"city GLB: cache-loaded device scene "
                                 f"differs from the built one in {diffs}")
        del built, scene_b
        ccam = types.PhysicalCamera(
            width_pixel=float(W), height_pixel=float(H), focal_length=0.035,
            sensor_width=0.05, focal_distance=80.0, z=140.0)
        reset_counts(pk, stg)
        with RDFrames(pipeline) as rd, Calls(pk, s3, keep_args=False) as calls:
            sample1.render_sample1(W, H, 4, 4, 2, scene=cached, camera=ccam,
                                   out=os.path.join(tmp, "city.png"))
        counts["city_glb"] = launch_counts(pk, stg)
        check_kernels("city GLB", calls, counts["city_glb"],
                      ["packet_trace", "aos_rows", "transpose", "emit",
                       "refine", "isect", "oscal"])
        del calls
        res = dict(cached.resources, camera=camera.camera_params(ccam, dev))
        direct = [direct_frames(tracer, scene_c, res, W, H, 4, 4, 2)
                  for _ in range(2)]
        log(f"[8] (b) city GLB through TraceRays, {W}x{H} batch 4 depth 4 "
            f"({card}): RD frames {', '.join(f'{m:.1f}' for m in rd.ms)} "
            f"ms vs direct render "
            f"{', '.join(f'{m:.1f}' for m in direct[0][2])} and "
            f"{', '.join(f'{m:.1f}' for m in direct[1][2])} ms (the "
            f"API's overhead: RD minus direct, second frame "
            f"{rd.ms[1] - direct[0][2][1]:.1f} ms); totalSamples "
            f"{rd.total_samples}; launches {counts['city_glb']}")
        if rd.total_samples != [0, 4]:
            raise AssertionError(f"city GLB: totalSamples {rd.total_samples}")
        rd_gate("city GLB", rd, direct, tracer, scene_c, (W, H, 4, 4, 2),
                card)
        check_frame("city GLB RD", rd.accum, rd.image, W * H)
        del cached, scene_c, direct, rd, res

        # (c) sample2: 512, 1024^2 textures, batch 4, depth 1, through the
        # instance scan, its waves' poisoned shares recorded
        sample2.AS_PATH = os.path.join(tmp, "bvh-cache.bin")
        scan, waves = s3m.trace_rows_multi, []

        def recorded(*a, **k):
            rec, diag = scan(*a, with_diag=True, **k)
            waves.append(dict(diag, occl=bool(k.get("occl")),
                              rays=int(rec.t.shape[0])))
            return rec

        reset_counts(pk, stg)
        s3m.trace_rows_multi = recorded
        try:
            with RDFrames(pipeline) as rd, Calls(pk, s3,
                                                 keep_args=False) as calls:
                sample2.render_sample2(S2, 4, 1, 1, tex_dim=S2_TEX,
                                       out=os.path.join(tmp, "s2.png"))
        finally:
            s3m.trace_rows_multi = scan
        counts["sample2"] = launch_counts(pk, stg)
        check_kernels("sample2", calls, counts["sample2"],
                      ["transpose", "emit", "refine", "isect", "isect_occl",
                       "oscal"])
        del calls
        verts2, tris2, _, _ = sample2.default_mesh()
        fresh = accel.BuildAccelStruct(sample2.get_instance_list(
            accel.BuildAccelStruct(types.Mesh(verts2, tris2))))
        diffs = scene_diffs(fresh.device_scene(dev),
                            accel.FileToTopAccelStruct(
                                sample2.AS_PATH).device_scene(dev))
        log(f"[8] (c) sample2 {S2}x{S2}, {S2_TEX}^2 textures, batch 4 "
            f"depth 1 ({card}): frame {rd.ms[0]:.1f} ms; TLAS file "
            f"{os.path.getsize(sample2.AS_PATH)} bytes, loaded scene fields "
            f"differing from the built {diffs}; launches {counts['sample2']}")
        for dg in waves:
            log(f"    sample2 wave ({'shadow' if dg['occl'] else 'closest'}"
                f"): poisoned {dg['poisoned']} of {dg['rays']} rays, share "
                f"{dg['poisoned'] / dg['rays']:.7f}")
        if diffs:
            raise AssertionError(f"sample2: file-loaded device scene differs "
                                 f"in {diffs}")
        if not waves or rd.total_samples != [0]:
            raise AssertionError("sample2: no scan wave or no frame")
        check_frame("sample2 RD", rd.accum, rd.image, S2 * S2)
        sample2.AS_PATH = None
    return counts


# ---- phase 9: the walk and the animated scene ----------------------------

ANIM = 512                    # bench.py --animated: RADIANCE_ANIM_RES
ANIM_FRAMES = 6
LBVH_FRAMES = 3               # the deforming mesh's frames: the walk takes
                              # ~4.7 s a 512x512 LBVH frame on the card
WOBBLE_TRIS = 64_000          # RADIANCE_ANIM_TRIS
MANY = 96                     # instances of sample2's torus in [9] (c)
SOUP_RAYS = 4096
SOUP_CHUNK = 256              # rays a brute-force soup pass


class WalkCalls:
    """Counts the walk's calls and rays (ops/traversal.trace_rays, torch
    ops with no kernel of their own) while in a `with` block."""

    def __init__(self, traversal, keep_first_closest=False):
        self.mod, self.calls, self.rays = traversal, 0, 0
        self.keep, self.first = keep_first_closest, None

    def __enter__(self):
        fn = self.orig = self.mod.trace_rays

        def counted(scene, o, d, tmin, tmax, any_hit_terminate=False,
                    chunk_size=None, any_hit_program=None):
            rec = fn(scene, o, d, tmin, tmax, any_hit_terminate, chunk_size,
                     any_hit_program)
            self.calls += 1
            self.rays += int(o.shape[0])
            if (self.keep and self.first is None and not any_hit_terminate
                    and any_hit_program is None):
                self.first = (scene, o, d, tmin, tmax, rec)
            return rec

        self.mod.trace_rays = counted
        return self

    def __exit__(self, *exc):
        self.mod.trace_rays = self.orig


def alpha_program(terminate: bool):
    """An alpha test: odd prims let rays through; with `terminate`, the
    first accepted candidate stops the ray (a shadow's any-hit)."""
    def program(cand):
        accept = (cand.prim % 2) == 0
        return accept, (accept if terminate else torch.zeros_like(accept))
    return program


def soup_hits(o, d, v0, e1, e2, tmin, tmax):
    """intersect_triangle_soup in SOUP_CHUNK-ray passes: (t, triangle)."""
    from radiance_tpu_torch.ops.intersect import intersect_triangle_soup

    ts, idx = [], []
    for i in range(0, o.shape[0], SOUP_CHUNK):
        t, k, _, _ = intersect_triangle_soup(o[i:i + SOUP_CHUNK],
                                             d[i:i + SOUP_CHUNK], v0, e1, e2,
                                             tmin, tmax)
        ts.append(t)
        idx.append(k)
    return torch.cat(ts), torch.cat(idx)


def many_instances(blas, types):
    """MANY instances of one BLAS: 4 layers of 6 x 4 in front of sample2's
    camera, each with its own custom id."""
    out = []
    for k in range(MANY):
        layer, cell = divmod(k, 24)
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [0.9 * (cell % 6) - 2.25, 0.9 * (cell // 6) - 2.35,
                    1.5 * layer]
        out.append(types.Instance(transform=m, sbt_offset=0,
                                  custom_instance_id=10 + k,
                                  bottom_accel_struct=blas))
    return out


def walk_and_animated(dev, card, scene, verts, tris, waves, sl, mtlas, pk,
                      s3, s3m, stg):
    """Phase 9: the two-level walk (ops/traversal.py) against the packet
    kernel (on the rays of `sl`) and the instance scan; custom any-hit
    programs on the city; a 96-instance scene with no kernel tables
    through TraceRays; bench.py --animated's rigid refit (64 instances)
    and deforming mesh (the LBVH), each frame held to a fresh build.
    Returns the launch counts of the phase and the animated metrics under
    bench.py's names."""
    from radiance_tpu_torch.api import accel, pipeline
    from radiance_tpu_torch.api.sbt import ShaderBindingTable
    from radiance_tpu_torch.bvh import lbvh
    from radiance_tpu_torch.core import math as rmath
    from radiance_tpu_torch.core import types
    from radiance_tpu_torch.engine import pathtracer, shaders
    from radiance_tpu_torch.engine.pathtracer import WavefrontPathTracer
    from radiance_tpu_torch.ops import traversal
    from radiance_tpu_torch.ops.intersect import FLT_MAX
    from radiance_tpu_torch.samples import sample2
    from radiance_tpu_torch.shading import camera

    out = {}
    reset_counts(pk, stg)
    torch.cuda.synchronize()

    # (a) walk parity on 64k-ray probes of the city's three bench waves
    # and a scattered wave (the packet kernel) and of the multi64 primary
    # (the instance scan)
    t0 = time.time()
    ident = torch.arange(len(tris), device=dev)
    walk_ms = {}
    # the bench's mirror bounce mostly escapes the city, so a scattered
    # probe as in phase [3] (random directions into the hemisphere facing
    # the camera, from 0.01 in front of each primary hit) adds incoherent
    # secondary rays that hit
    o, d = (x[sl] for x in waves["primary"])
    t_p = pk.trace_rays_packet(scene, o, d, TMIN, TMAX).t
    hits = torch.nonzero(t_p < FLT_MAX).squeeze(1)
    sd = torch.randn(hits.numel(), 3, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    sd = rmath.normalize(sd)
    sd = torch.where(((sd * d[hits]).sum(1) > 0)[:, None], -sd, sd)
    probes = {w: tuple(x[sl].contiguous() for x in waves[w])
              for w in ("primary", "bounce", "shadow")}
    probes["scatter"] = ((o[hits] + (t_p[hits] - 0.01)[:, None]
                          * d[hits]).contiguous(), sd.contiguous())
    for wave, any_hit in (("primary", False), ("bounce", False),
                          ("shadow", True), ("scatter", False)):
        o, d = probes[wave]
        w_ms, wrec = cuda_ms(lambda: traversal.trace_rays(
            scene, o, d, TMIN, TMAX, any_hit_terminate=any_hit), 2)
        k_ms, krec = cuda_ms(lambda: pk.trace_rays_packet(
            scene, o, d, TMIN, TMAX, any_hit=any_hit), 3)
        # the packet kernel's origin-centred planes carry ~|o| * eps of t
        # error that the walk's Moller-Trumbore does not: t is held on
        # |dt| / (|o| + t), with the float64 witness behind it
        name = f"walk vs packet kernel, city {wave} probe"
        res = judge(name, wrec.t, wrec.prim, krec.t, krec.prim, o, d, None,
                    ident, any_hit=any_hit, t_scale="origin",
                    mesh=None if any_hit else (verts, tris))
        walk_ms[f"city_{wave}"] = dict(walk_ms=w_ms, packet_ms=k_ms,
                                       hit_agree=res["hit_agree"])
        log(f"[9] (a) city {wave} probe, {o.shape[0]} rays ({card}): walk "
            f"{w_ms:.3f} ms, packet kernel {k_ms:.4f} ms ({w_ms / k_ms:.0f}x)")
    mscene = mtlas.device_scene(dev)
    mt = s3m.multi_tables(mscene)
    # every 32nd ray of the wave: the instances spread over the image
    o, d = (x[::32].contiguous() for x in waves["primary"])
    rows = s3.rows_from_aos_fast(o, d)
    w_ms, wrec = cuda_ms(lambda: traversal.trace_rays(
        mscene, o, d, TMIN, TMAX), 2)
    m_ms, mrec = cuda_ms(lambda: s3m.trace_rows_multi(
        mscene, mt, rows, TMIN, TMAX), 3)
    res = hold_prims("walk vs instance scan, multi64 primary probe", wrec.t,
                     wrec.prim, mrec.t, mrec.prim)
    both = wrec.hit & mrec.hit
    slot_agree = float((wrec.slot == mrec.slot)[both].float().mean())
    walk_ms["multi64_primary"] = dict(walk_ms=w_ms, scan_ms=m_ms,
                                      hit_agree=res["hit_agree"],
                                      slot_agree=slot_agree)
    log(f"[9] (a) multi64 primary probe, {o.shape[0]} rays ({card}): walk "
        f"{w_ms:.3f} ms, instance scan {m_ms:.3f} ms; slot agreement "
        f"{slot_agree:.7f} ({time.time() - t0:.1f} s)")
    if slot_agree < BARS["prim"]:
        raise AssertionError(f"walk and scan slots disagree: {slot_agree}")
    out["walk_ms"] = walk_ms

    # (b) a custom any-hit program on the city: an alpha test rejecting odd
    # prims equals the packet kernel on the city without them
    t0 = time.time()
    even = accel.BuildTopAccelStruct([types.Instance(
        np.eye(4, dtype=np.float32), 0, 0, accel.BuildBottomAccelStruct(
            types.Mesh(verts, np.ascontiguousarray(tris[::2]))))]
    ).device_scene(dev)
    for wave, any_hit in (("primary", False), ("shadow", True)):
        o, d = (x[sl].contiguous() for x in waves[wave])
        a_ms, arec = cuda_ms(lambda: traversal.trace_rays(
            scene, o, d, TMIN, TMAX,
            any_hit_program=alpha_program(terminate=any_hit)), 1)
        krec = pk.trace_rays_packet(even, o, d, TMIN, TMAX, any_hit=any_hit)
        name = f"alpha-test walk vs packet kernel on even prims, {wave}"
        if any_hit:
            hold_occluded(name, arec.hit, krec.hit,
                          torch.ones_like(arec.hit))
        else:
            judge(name, arec.t, arec.prim, krec.t, 2 * krec.prim, o, d,
                  None, ident, any_hit=False, t_scale="origin",
                  mesh=(verts, tris))
            if bool((arec.prim[arec.hit] % 2 != 0).any()):
                raise AssertionError("the alpha test let an odd prim hit")
        log(f"[9] (b) alpha-test walk, city {wave} probe ({card}): "
            f"{a_ms:.3f} ms")
    o, d = (x[sl].contiguous() for x in waves["shadow"])
    term = traversal.trace_rays(scene, o, d, TMIN, TMAX, any_hit_program=(
        lambda c: (torch.ones_like(c.valid), torch.ones_like(c.valid))))
    occ = traversal.trace_rays(scene, o, d, TMIN, TMAX,
                               any_hit_terminate=True)
    if not (torch.equal(term.hit, occ.hit) and torch.equal(term.t, occ.t)):
        raise AssertionError("accept-all + terminate differs from "
                             "any_hit_terminate")
    log(f"   accept-all + terminate equals any_hit_terminate on "
        f"{o.shape[0]} shadow rays ({int(occ.hit.sum())} occluded)")
    del even
    recs = [dict(r) for r in shaders.DEFAULT_SBT_RECORDS]
    recs[2]["anyHit"] = "alphaShadow"
    alpha = alpha_program(terminate=True)
    tracer = WavefrontPathTracer(
        ray_generator=camera.physical_camera_raygen,
        sbt=ShaderBindingTable.from_json(recs, dict(
            shaders.SHADER_REGISTRY, alphaShadow=lambda c, r: alpha(c))))
    res = city_resources(dev, verts, tris, ANIM, ANIM)
    with WalkCalls(traversal) as wc:
        tf0 = time.time()
        acc, img = tracer.render(scene, res,
                                 torch.zeros(ANIM * ANIM, 3, device=dev), 0,
                                 ANIM, ANIM, batch=1, depth=2)
        torch.cuda.synchronize()
        f_ms = (time.time() - tf0) * 1e3
    log(f"[9] (b) city frame {ANIM}x{ANIM} batch 1 depth 2 with the alpha "
        f"shadow program ({card}): {f_ms:.1f} ms; the walk took "
        f"{wc.calls} traces of {wc.rays} rays ({time.time() - t0:.1f} s)")
    check_frame("city, alpha shadows", acc, img, ANIM * ANIM)
    if wc.calls < 2:
        raise AssertionError("the alpha shadows did not take the walk")
    out["alpha_frame_ms"] = f_ms

    # (c) more than 64 instances: no kernel tables, through TraceRays
    t0 = time.time()
    verts2, tris2, _, _ = sample2.default_mesh()
    get_list = sample2.get_instance_list
    sample2.get_instance_list = lambda blas: many_instances(blas, types)
    with tempfile.TemporaryDirectory() as tmp:
        sample2.AS_PATH = os.path.join(tmp, "bvh-many.bin")
        try:
            with RDFrames(pipeline) as rd, WalkCalls(
                    traversal, keep_first_closest=True) as wc:
                sample2.render_sample2(ANIM, 1, 2, 1, tex_dim=S2_TEX,
                                       out=os.path.join(tmp, "many.png"))
        finally:
            sample2.get_instance_list = get_list
            sample2.AS_PATH = None
    log(f"[9] (c) {MANY} instances of sample2's {len(tris2)}-triangle torus "
        f"through TraceRays, {ANIM}x{ANIM} batch 1 depth 2 ({card}): frame "
        f"{rd.ms[0]:.1f} ms; the walk took {wc.calls} traces of {wc.rays} "
        f"rays")
    check_frame(f"{MANY} instances RD", rd.accum, rd.image, ANIM * ANIM)
    if wc.first is None:
        raise AssertionError("the many-instance frame did not walk")
    scene96, o, d, tmin, tmax, rec = wc.first
    if scene96.kblas is not None:
        raise AssertionError(f"{MANY} instances: the scene has kernel tables")
    pick = torch.linspace(0, o.shape[0] - 1, SOUP_RAYS, device=dev).long()
    vt = torch.from_numpy(verts2).to(dev)
    tt = torch.from_numpy(tris2.astype(np.int64)).to(dev)
    tf = torch.stack([torch.from_numpy(i.transform) for i in
                      many_instances(None, types)]).to(dev)
    wv = (rmath.mat4_transform_point(tf[:, None], vt[None])
          .reshape(-1, 3))                       # instance-major vertices
    tw = (tt[None] + torch.arange(MANY, device=dev)[:, None, None]
          * len(verts2)).reshape(-1, 3)
    v0 = wv[tw[:, 0]]
    t_s, k_s = soup_hits(o[pick], d[pick], v0, wv[tw[:, 1]] - v0,
                         wv[tw[:, 2]] - v0, tmin, tmax)
    inst = torch.div(k_s, len(tris2), rounding_mode="floor")
    got = rec.take(pick)
    ids = scene96.inst_id[got.slot.clamp(min=0).long()]
    res = hold_prims(f"{MANY}-instance primary wave vs brute-force soup",
                     got.t, got.prim, t_s,
                     torch.where(k_s >= 0, k_s % len(tris2), -1))
    same = got.hit & (t_s < FLT_MAX)
    inst_agree = float((ids == inst)[same].float().mean())
    log(f"   {SOUP_RAYS} rays against {MANY * len(tris2)} world triangles: "
        f"instance agreement {inst_agree:.7f} ({time.time() - t0:.1f} s)")
    if inst_agree < BARS["prim"]:
        raise AssertionError(f"{MANY}-instance frame: instances disagree "
                             f"with the soup: {inst_agree}")
    out["many_instance_frame_ms"] = rd.ms[0]

    # (d) rigid motion: bench.py's 64-instance refit (frame_tf), 6 frames
    # at ANIM^2 through the engine's route (the instance scan), each held
    # to a fresh build with the same transforms
    t0 = time.time()
    o, d = camera_rays(dev, ANIM, ANIM)
    base_tf = np.stack([np.asarray(i.transform, np.float32)
                        for i in mtlas.source_instances])

    def frame_tf(k):                     # bench.py:1259-1265
        ang = 0.05 * (k + 1)
        rot = np.eye(4, dtype=np.float32)
        rot[0, 0] = rot[2, 2] = np.cos(ang)
        rot[0, 2] = np.sin(ang)
        rot[2, 0] = -np.sin(ang)
        return np.einsum("ij,njk->nik", rot, base_tf)

    def frame(scn):
        return pathtracer._trace_dispatch(scn, o, d, TMIN, TMAX)

    built_map = mtlas.device_scene(dev).inst_kblas   # the build's slots
    mscene = mtlas.refit(frame_tf(0), dev)
    frame(mscene)
    torch.cuda.synchronize()
    refit_ms, frame_ms, reordered = [], [], 0
    for k in range(1, ANIM_FRAMES + 1):
        tf0 = time.time()
        mscene = mtlas.refit(frame_tf(k), dev)
        torch.cuda.synchronize()
        tf1 = time.time()
        rec = frame(mscene)
        torch.cuda.synchronize()
        tf2 = time.time()
        refit_ms.append((tf1 - tf0) * 1e3)
        frame_ms.append((tf2 - tf0) * 1e3)
        moved = sum(a != b for a, b in zip(mscene.inst_kblas, built_map))
        reordered += moved > 0
        fresh = accel.BuildTopAccelStruct([
            types.Instance(tf_i, 0, i, inst.bottom_accel_struct)
            for i, (tf_i, inst) in enumerate(zip(frame_tf(k),
                                                 mtlas.source_instances))]
        ).device_scene(dev)
        ref = frame(fresh)
        hold_prims(f"refit frame {k} vs a fresh build", rec.t, rec.prim,
                   ref.t, ref.prim)
        both = rec.hit & ref.hit
        ids = mscene.inst_id[rec.slot.clamp(min=0).long()]
        ids_f = fresh.inst_id[ref.slot.clamp(min=0).long()]
        id_agree = float((ids == ids_f)[both].float().mean())
        if id_agree < BARS["prim"]:
            raise AssertionError(f"refit frame {k}: instance ids disagree "
                                 f"with a fresh build: {id_agree}")
        log(f"   refit frame {k}: refit {refit_ms[-1]:.2f} ms, frame "
            f"{frame_ms[-1]:.1f} ms; instance id agreement {id_agree:.7f}; "
            f"slots holding another BLAS than at the build: {moved}")
        del fresh
    # the JAX update_tlas keeps the build's slot -> BLAS map (ROADMAP.md
    # queue 3): the last frame traced with it, as its scan would
    stale = pathtracer._trace_dispatch(dataclasses.replace(
        mscene, inst_kblas=built_map, multi=None), o, d, TMIN, TMAX)
    wrong = (stale.hit != rec.hit) | (stale.hit & rec.hit & (
        (stale.prim != rec.prim) | (stale.slot != rec.slot)))
    log(f"   frame {ANIM_FRAMES} with the build's slot map kept (the JAX "
        f"update_tlas): {float(wrong.float().mean()):.6f} of rays differ")
    dt = sum(frame_ms) / len(frame_ms) / 1e3
    out["rigid_refit"] = {
        "frames_per_sec": 1.0 / dt, "mrays": ANIM * ANIM / dt / 1e6,
        "route": "scan", "instances": len(mtlas.source_instances),
        "refit_ms": sum(refit_ms) / len(refit_ms),
        "frames_with_slots_moved": reordered,
        "stale_map_rays_differ": float(wrong.float().mean())}
    log(f"[9] (d) rigid refit, {ANIM}x{ANIM} ({card}): "
        f"{json.dumps(out['rigid_refit'])} ({time.time() - t0:.1f} s)")

    # (e) deforming mesh: bench.py's wobble, the LBVH rebuilt and walked
    # every frame, held to a host SAH build of the last frame
    t0 = time.time()
    rng = np.random.default_rng(3)
    centers = rng.uniform(-20, 20, size=(WOBBLE_TRIS, 3)).astype(np.float32)
    offs = rng.normal(scale=0.25, size=(WOBBLE_TRIS, 3, 3)).astype(np.float32)
    verts0 = (centers[:, None, :] + offs).reshape(-1, 3)
    wtris = np.arange(WOBBLE_TRIS * 3, dtype=np.int32).reshape(-1, 3)
    o2 = (o * 0.3).contiguous()
    v_dev = torch.from_numpy(verts0).to(dev)
    t_dev = torch.from_numpy(wtris).to(dev)
    phase = torch.from_numpy(rng.uniform(0, 6.28, size=(len(verts0), 3))
                             .astype(np.float32)).to(dev)

    def lbvh_frame(k):
        v = v_dev + 0.3 * torch.sin(phase + 0.3 * k)
        scn = lbvh.lbvh_scene(v, t_dev)
        return v, scn, traversal.trace_rays(scn, o2, d, 1e-3, 1e4)

    lbvh_frame(0.0)
    torch.cuda.synchronize()
    tf0 = time.time()
    for k in range(1, LBVH_FRAMES + 1):
        v_k, scn_k, rec = lbvh_frame(float(k))
        float(rec.t[::65536].sum())
    dt_l = (time.time() - tf0) / LBVH_FRAMES
    t_lb, p_lb = rec.t, rec.prim
    build_ms, _ = cuda_ms(lambda: lbvh.lbvh_scene(v_k, t_dev), 3)
    on_cpu = lbvh.lbvh_scene(v_k.cpu(), t_dev.cpu())
    for key in ("node_packed", "bundle_packed"):
        if not torch.equal(getattr(scn_k, key).cpu().view(torch.int32),
                           getattr(on_cpu, key).view(torch.int32)):
            raise AssertionError(f"LBVH {key} on the card differs from the "
                                 f"CPU build")
    log(f"   LBVH tables of frame {LBVH_FRAMES} equal the CPU build's bit "
        f"for bit ({tuple(scn_k.node_packed.shape)} node rows, "
        f"{tuple(scn_k.bundle_packed.shape)} bundles)")
    vk = v_k.cpu().numpy()
    tf0 = time.time()
    blas = accel.BuildBottomAccelStruct(types.Mesh(vk, wtris.astype(
        np.uint32)))
    sah = accel.BuildTopAccelStruct([types.Instance(
        np.eye(4, dtype=np.float32), 0, 0, blas)]).device_scene(dev)
    t_sah = traversal.trace_rays(sah, o2, d, 1e-3, 1e4).t
    float(t_sah[::65536].sum())
    dt_s = time.time() - tf0
    hl, hs = t_lb < FLT_MAX, t_sah < FLT_MAX
    both = hl & hs
    rmse = float(((t_lb - t_sah)[both].double() ** 2).mean().sqrt()) \
        if bool(both.any()) else 0.0
    mismatch = float((hl != hs).float().mean())
    hold_prims("LBVH frame vs host SAH build", t_lb, p_lb, t_sah,
               traversal.trace_rays(sah, o2, d, 1e-3, 1e4).prim)
    out["deforming"] = {
        "tris": WOBBLE_TRIS, "lbvh_ms_per_frame": dt_l * 1e3,
        "lbvh_mrays": ANIM * ANIM / dt_l / 1e6,
        "sah_rebuild_ms_per_frame": dt_s * 1e3, "speedup": dt_s / dt_l,
        "hit_t_rmse": rmse, "hit_mismatch_frac": mismatch,
        "lbvh_build_ms": build_ms, "frames": LBVH_FRAMES}
    log(f"[9] (e) deforming mesh, {ANIM}x{ANIM} ({card}): "
        f"{json.dumps(out['deforming'])} ({time.time() - t0:.1f} s)")
    if mismatch > 1e-3:
        raise AssertionError(f"LBVH and SAH hits differ on {mismatch}")

    out["launches"] = launch_counts(pk, stg)
    need = ("packet_trace[closest]", "packet_trace[any_hit]", "emit",
            "refine", "isect", "oscal")
    if any(out["launches"].get(k, 0) <= 0 for k in need):
        raise AssertionError(f"phase 9 missed a kernel: {out['launches']}")
    log(f"[9] launches in the phase: {out['launches']}")
    return out


# ---- phase 10: the TLAS-native many-instance route -----------------------

SWEEP_COUNTS = (2, 4, 8, 9, 16, 64)   # instances of multi64 in [10] (d)
TLAS_STAGES = ("_prep_tlas", "stage_emit", "stage_refine",
               "feats_rows_to_major", "stage_isect", "_glue_tlas",
               "retrace_flagged")


def driven(pk, stg, total, fn):
    """Run fn() with the launch counts set to 0 just before and read just
    after (synchronized); add them to `total` and return fn's result."""
    reset_counts(pk, stg)
    out = fn()
    torch.cuda.synchronize()
    for k, v in launch_counts(pk, stg).items():
        total[k] = total.get(k, 0) + v
    return out


def busy_ms(prof) -> float:
    """The device's busy ms in a torch.profiler run: the union of its
    kernel and copy intervals."""
    total, end = 0.0, float("-inf")
    for _, s, dur in kernel_records(prof):
        e = s + dur
        if s > end:
            total, end = total + dur, e
        elif e > end:
            total, end = total + e - end, e
    return total / 1e6


def tlas_wave(name, s3m, stg, pk, scene, mt, rows, total, card, **kw):
    """One wave through trace_rows_tlas, timed with CUDA events over 3
    calls after a warm-up (their launches counted in `total`), then split
    by stage with CUDA events around each; returns (rec, diag, ms,
    stage ms)."""
    def run():
        return s3m.trace_rows_tlas(scene, mt, rows, TMIN, TMAX,
                                   with_diag=True, **kw)
    ms, (rec, diag) = driven(pk, stg, total, lambda: cuda_ms(run, 3))
    _, spans, _ = driven(pk, stg, total,
                         lambda: call_spans(s3m, TLAS_STAGES, run))
    spans = {k: sum(v) for k, v in spans.items()}
    log(f"[10] (a) {name} ({card}): trace_rows_tlas {ms:.3f} ms "
        f"({rows[0].shape[0] / ms / 1e3:.2f} Mrays/s); slots alive "
        f"{diag['slots_alive']} / scap {diag['scap']}, pool-overflowed "
        f"packets {diag['pool_overflow']}, flagged {diag['flagged']}, "
        f"residual rays {diag['residual_rays']}; diag {json.dumps(diag)}; "
        f"stages (ms, CUDA events) "
        f"{json.dumps({k: round(v, 4) for k, v in spans.items()})}")
    return rec, diag, ms, spans


def recorded_wave(s3m, stg, pk, scene, mt, rows, total, **kw):
    """One trace_rows_tlas call with every kernel dispatcher's call
    recorded (Calls) under torch.profiler: (Calls.calls, launch_ms())."""
    _, calls, ms = profiled(pk, s3m, lambda _: driven(
        pk, stg, total, lambda: s3m.trace_rows_tlas(
            scene, mt, rows, TMIN, TMAX, **kw)))
    return calls, ms


def hold_tlas_wave(stg, calls, ms, occl, card):
    """Kernels F, B, C and D (or E) on their one launch of a recorded
    native wave, each held against its plain version on its recorded
    arguments and bounded: {key: dict(ms, plain_ms, bound_ms, bound_by)}."""
    out = {}
    (_, a, _, res), = calls["oscal"]
    p_ms, ref = cuda_ms(lambda: stg._oscal_plain(*a), 1, warmup=False)
    if not oscal_equal(res, ref):
        raise AssertionError("oscal differs from plain on the native route")
    out["oscal"] = (ms["oscal"][0], p_ms, oscal_bound(a[0], a[1], res))
    (_, a, k, res), = calls["emit"]
    args = emit_args(stg, a, k)
    p_ms, st = emit_hold(stg, args, res)
    (b, nodes, words, max_nodes), = emit_bounds(stg, [(args, res[1])])
    out["emit"] = (ms["emit"][0], p_ms, b)
    log(f"    B on the native route: {res[0].shape[0]} slots, {nodes} "
        f"nodes, {words} words, longest walk {int(res[1][:, 2].max())} "
        f"step windows ({max_nodes} nodes), capped "
        f"{int(res[1][:, 1].sum())}; window loads {st['window_loads']}; "
        f"equal to plain")
    (_, ra, rk, res), = calls["refine"]
    feats_t = torch.zeros(16, ra[3].shape[1], device=ra[3].device)
    feats_t[REFINE_ROWS] = ra[3]
    p_ms = refine_hold(stg, ra[:3] + (feats_t,) + ra[4:]
                       + (rk.get("pcap", stg.PCAP),), res)
    b, words, kept = refine_bound(stg, ra[0], ra[1], res[1],
                                  rk.get("pcap", stg.PCAP))
    out["refine"] = (ms["refine"][0], p_ms, b)
    log(f"    C on the native route: {words} words, {kept} kept; equal to "
        f"plain")
    key = "isect_occl" if occl else "isect"
    (_, a, k, res), = calls[key]
    args = a + (k["pcap"], k["stable"])
    if occl:
        r = occl_launch(stg, args, res)
        hold_occluded("E on the native shadow wave", r["occ_k"], r["occ_p"],
                      r["live"], need_occluded=False)
    else:
        r = isect_launch(stg, args, res)
        hold_prims("D on the native primary wave", r["t_k"], r["prim_k"],
                   r["t_p"], r["prim_p"])
    out[key] = (ms[key][0], r["plain_ms"], r["bound"])
    for k2, (k_ms, p_ms, b) in out.items():
        log(f"    {k2} on the native route ({card}): kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}), "
            f"{b[0] / k_ms:.3f} of it")
    return {k2: dict(ms=k_ms, plain_ms=p_ms, bound_ms=b[0], bound_by=b[1])
            for k2, (k_ms, p_ms, b) in out.items()}


def hold_residual(pk, calls, any_hit):
    """The packet kernel on the launch of a native wave's residual (its
    per-instance sweeps) with the most hits, held against its plain
    version on the recorded arguments; returns judge()'s result."""
    runs = [c for c in calls["packet_trace"] if c[2]["any_hit"] == any_hit]
    if not runs:
        raise AssertionError("the native route's residual launched no "
                             "packet kernel")
    _, a, k, (t_k, tri_k) = max(runs, key=lambda c: int(
        (c[3][0] < 3.4e38).sum()))
    t_p, tri_p = pk._packet_trace_reference(*a, **k)
    return judge(f"packet kernel on the native residual "
                 f"({a[0].shape[0]} rays)", t_k, tri_k, t_p, tri_p, a[0],
                 a[1], a[2], None, any_hit=any_hit)


def tlas_native(dev, card, tracer, light, pk, s3, s3m, stg):
    """Phase 10: the TLAS-native route (trace_rows_tlas) on a fresh
    multi64 scene: (a) bench's 1080p primary and shadow waves against the
    scan and the per-instance sweeps, each kernel of the route held
    against its plain version on its launch, the residual forced by a
    pool of one slot a packet; (b) engine frames on the native route
    beside the scan; (c) bench.py --animated's rigid refit on the native
    route, each frame against a fresh build; (d) the 1080p primary at
    SWEEP_COUNTS instances through the sweeps, the scan and the native
    route.  Launch counts: the native route's runs only.  Returns the
    counts and the phase's metrics."""
    from radiance_tpu_torch.api import accel
    from radiance_tpu_torch.core import math as rmath
    from radiance_tpu_torch.core import types
    from radiance_tpu_torch.engine import pathtracer
    from radiance_tpu_torch.ops.intersect import FLT_MAX

    total, out = {}, {}
    t0 = time.time()
    mscene, mres, mtlas = multi64_scene(dev, W, H)
    base_tf = np.stack([np.asarray(i.transform, np.float32)
                        for i in mtlas.source_instances])
    mt = s3m.multi_tables(mscene)
    if not s3m.supports_native(mt):
        raise AssertionError("multi64's leaves do not fit the word format")
    log(f"[10] multi64: {len(mscene.inst_kblas)} instances of "
        f"{len(mt.uniq)} BLASes; concatenated nodef {tuple(mt.nodef_cat.shape)},"
        f" kleaf {tuple(mt.kleaf_cat.shape)}; built in {time.time() - t0:.1f} s")

    # (a) the waves
    n = W * H
    o1, d1 = camera_rays(dev, W, H)
    rows = s3.rows_from_aos_fast(o1, d1)
    rec, diag, ms, spans = tlas_wave("primary 1080p", s3m, stg, pk, mscene,
                                     mt, rows, total, card)
    scan_ms, (scan, sdiag) = cuda_ms(lambda: s3m.trace_rows_multi(
        mscene, mt, rows, TMIN, TMAX, with_diag=True), 2)
    sw_ms, sweep = cuda_ms(lambda: pk.trace_rays_packet_multi(
        mscene, o1, d1, TMIN, TMAX), 2)
    ok = scan.slot != -2
    res = {}
    for other, ref, keep in (("scan", scan, ok), ("sweeps", sweep, None)):
        sel = slice(None) if keep is None else keep
        res[other] = hold_prims(f"native primary vs {other}", rec.t[sel],
                                rec.prim[sel], ref.t[sel], ref.prim[sel])
        both = (rec.hit & ref.hit)[sel]
        res[other]["slot_agree"] = float(
            (rec.slot[sel] == ref.slot[sel])[both].float().mean())
        if res[other]["slot_agree"] < BARS["prim"]:
            raise AssertionError(f"native primary: instance slots disagree "
                                 f"with the {other}: {res[other]}")
    log(f"[10] (a) primary 1080p ({card}): native {ms:.3f} ms, scan "
        f"{scan_ms:.3f} ms (poisoned {sdiag['poisoned']}), sweeps "
        f"{sw_ms:.3f} ms; slot agreement {res['scan']['slot_agree']:.7f} "
        f"(scan), {res['sweeps']['slot_agree']:.7f} (sweeps)")
    out["primary"] = dict(ms=ms, scan_ms=scan_ms, sweeps_ms=sw_ms,
                          stages=spans, diag=diag)
    calls, kms = recorded_wave(s3m, stg, pk, mscene, mt, rows, total)
    held = hold_tlas_wave(stg, calls, kms, False, card)
    # kernel A: the slot features of this wave, ray-major, bit-exact
    feats_t = s3m._prep_tlas(mt, mscene.inst_inv, s3._pad_wave(rows, None)[0],
                             TMIN, TMAX, None, diag["scap"],
                             stable=bool(mscene.stable_frames))[0]
    a_ms, a_out = cuda_ms(lambda: stg.transpose_cuda(feats_t), 5)
    ap_ms, a_ref = cuda_ms(lambda: feats_t.t().contiguous(), 5)
    if not torch.equal(a_out, a_ref):
        raise AssertionError("A differs from .t().contiguous() on the "
                             "native route's features")
    b = bound(0, 2 * 4 * feats_t.numel())
    held["transpose"] = dict(ms=a_ms, plain_ms=ap_ms, bound_ms=b[0],
                             bound_by=b[1], library_ms=ap_ms)
    log(f"    A on the native features ({tuple(feats_t.shape)}, {card}): "
        f"{a_ms:.4f} ms, .t().contiguous() {ap_ms:.4f} ms, bound "
        f"{b[0]:.4f} ms; bit-exact")
    del calls, feats_t, a_out, a_ref

    # its shadow wave (bench.py's, from the primary hits toward light_vec)
    mo2, _ = bounce_rays(rmath, o1, d1, rec.t, FLT_MAX)
    live = rec.hit
    srows = s3.rows_from_aos_fast(mo2, light)
    occ, odiag, oms, ospans = tlas_wave("shadow 1080p", s3m, stg, pk, mscene,
                                        mt, srows, total, card, live=live,
                                        occl=True)
    socc_ms, socc = cuda_ms(lambda: s3m.trace_rows_multi(
        mscene, mt, srows, TMIN, TMAX, live=live, occl=True), 2)
    psw_ms, psw = cuda_ms(lambda: pk.trace_rays_packet_multi(
        mscene, mo2, light, TMIN, TMAX, any_hit=True), 2)
    if bool(occ.hit[~live].any()):
        raise AssertionError("a dead lane of the native shadow wave is "
                             "occluded")
    hold_occluded("native shadow vs sweeps", occ.hit, psw.hit, live)
    hold_occluded("native shadow vs scan", occ.hit, socc.hit,
                  live & (socc.slot != -2))
    log(f"[10] (a) shadow 1080p ({card}): native {oms:.3f} ms, scan "
        f"{socc_ms:.3f} ms, sweeps {psw_ms:.3f} ms")
    out["shadow"] = dict(ms=oms, scan_ms=socc_ms, sweeps_ms=psw_ms,
                         stages=ospans, diag=odiag)
    calls, kms = recorded_wave(s3m, stg, pk, mscene, mt, srows, total,
                               live=live, occl=True)
    held["isect_occl"] = hold_tlas_wave(stg, calls, kms, True,
                                        card)["isect_occl"]
    del calls

    # the residual forced: a pool of one slot a packet, on both waves
    npk = -(-n // (stg.G * stg.PKT)) * stg.G
    for name, r_rows, kw, base in (
            ("primary", rows, {}, rec),
            ("shadow", srows, dict(live=live, occl=True), occ)):
        f_ms, (frec, fdiag) = driven(pk, stg, total, lambda: cuda_ms(
            lambda: s3m.trace_rows_tlas(mscene, mt, r_rows, TMIN, TMAX,
                                        scap=npk, with_diag=True, **kw), 1))
        if fdiag["residual_rays"] == 0:
            raise AssertionError(f"forced residual ({name}): nothing "
                                 f"flagged")
        if kw:
            hold_occluded("native shadow, forced residual vs unforced",
                          frec.hit, base.hit, live)
        else:
            hold_prims("native primary, forced residual vs unforced",
                       frec.t, frec.prim, base.t, base.prim)
        log(f"[10] (a) {name}, pool of {npk} slots ({card}): {f_ms:.3f} ms;"
            f" diag {json.dumps(fdiag)}")
        out[f"{name}_forced_residual"] = dict(ms=f_ms, diag=fdiag)
        calls, _ = recorded_wave(s3m, stg, pk, mscene, mt, r_rows, total,
                                 scap=npk, **kw)
        hold_residual(pk, calls, bool(kw))
        del calls, frec
    del scan, sweep, socc, psw, occ
    log(f"[10] (a) done in {time.time() - t0:.1f} s")

    # (b) engine frames on the native route beside the scan
    t1 = time.time()
    native_tracer = dataclasses.replace(tracer, multi_route="native")
    frames, waves = {}, []
    real = s3m.trace_rows_tlas

    def recorded(*a, **k):
        rec_w, dg = real(*a, **dict(k, with_diag=True))
        waves.append(dict(dg, occl=bool(k.get("occl")),
                          rays=int(rec_w.t.shape[0])))
        return rec_w

    for route, tr in (("scan", tracer), ("native", native_tracer)):
        def frame():
            return tr.render(mscene, mres, torch.zeros(n, 3, device=dev), 0,
                             W, H, batch=1, depth=2)
        count = ((lambda f: driven(pk, stg, total, f)) if route == "native"
                 else (lambda f: f()))
        s3m.trace_rows_tlas = recorded     # the first frame's waves
        try:
            count(frame)
        finally:
            s3m.trace_rows_tlas = real
        tf0 = time.time()
        accum, image = count(frame)
        torch.cuda.synchronize()
        warm = (time.time() - tf0) * 1e3
        with cuda_profile() as prof:
            tf0 = time.time()
            count(frame)
            torch.cuda.synchronize()
            wall = (time.time() - tf0) * 1e3
        busy = busy_ms(prof)
        del prof
        frames[route] = dict(ms=warm, profiled_ms=wall, busy_ms=busy,
                             idle_share=1.0 - busy / wall, accum=accum,
                             image=image)
        log(f"[10] (b) multi64 frame 1920x1080 batch 1 depth 2, {route} "
            f"({card}): warm {warm:.1f} ms; profiled {wall:.1f} ms, device "
            f"busy {busy:.1f} ms, idle share {1.0 - busy / wall:.4f}")
    for dg in waves:
        log(f"    native engine wave ({'shadow' if dg['occl'] else 'closest'}"
            f"): {json.dumps(dg)}")
    check_frame("multi64 native", frames["native"]["accum"],
                frames["native"]["image"], n)
    rmse = float((frames["native"]["image"][..., :3].float()
                  - frames["scan"]["image"][..., :3].float())
                 .pow(2).mean().sqrt())
    log(f"[10] (b) u8 RMSE native against scan {rmse:.4f} "
        f"({time.time() - t1:.1f} s)")
    if rmse >= 2.0:
        raise AssertionError(f"multi64 native frame differs from the scan's:"
                             f" RMSE {rmse}")
    out["frames"] = {k: {m: v for m, v in f.items()
                         if m not in ("accum", "image")}
                     for k, f in frames.items()}
    out["frames"]["rmse"] = rmse
    out["frames"]["native_waves"] = waves
    del frames

    # (c) rigid motion on the native route: bench.py's frame_tf, 6 frames
    # at ANIM^2, each against a fresh build traced the same way
    t1 = time.time()
    o, d = camera_rays(dev, ANIM, ANIM)

    def frame_tf(k):                     # bench.py:1259-1265
        ang = 0.05 * (k + 1)
        rot = np.eye(4, dtype=np.float32)
        rot[0, 0] = rot[2, 2] = np.cos(ang)
        rot[0, 2] = np.sin(ang)
        rot[2, 0] = -np.sin(ang)
        return np.einsum("ij,njk->nik", rot, base_tf)

    def trace(scn):
        return pathtracer._trace_dispatch(scn, o, d, TMIN, TMAX,
                                          multi_route="native")

    built_map = mscene.inst_kblas
    rscene = mtlas.refit(frame_tf(0), dev)
    driven(pk, stg, total, lambda: trace(rscene))
    refit_ms, frame_ms, reordered = [], [], 0
    for k in range(1, ANIM_FRAMES + 1):
        tf0 = time.time()
        rscene = mtlas.refit(frame_tf(k), dev)
        torch.cuda.synchronize()
        tf1 = time.time()
        rec_k = driven(pk, stg, total, lambda: trace(rscene))
        tf2 = time.time()
        refit_ms.append((tf1 - tf0) * 1e3)
        frame_ms.append((tf2 - tf0) * 1e3)
        _, dg = driven(pk, stg, total, lambda: s3m.trace_rows_tlas(
            rscene, rscene.multi, s3.rows_from_aos(o, d), TMIN, TMAX,
            with_diag=True))
        moved = sum(a != b for a, b in zip(rscene.inst_kblas, built_map))
        reordered += moved > 0
        fresh = accel.BuildTopAccelStruct([
            types.Instance(tf_i, 0, i, inst.bottom_accel_struct)
            for i, (tf_i, inst) in enumerate(zip(frame_tf(k),
                                                 mtlas.source_instances))]
        ).device_scene(dev)
        ref = trace(fresh)
        if not torch.equal(rec_k.t, ref.t) or not torch.equal(rec_k.prim,
                                                             ref.prim):
            raise AssertionError(f"native refit frame {k}: t or prims "
                                 f"differ from a fresh build")
        both = rec_k.hit & ref.hit
        ids = rscene.inst_id[rec_k.slot.clamp(min=0).long()]
        ids_f = fresh.inst_id[ref.slot.clamp(min=0).long()]
        id_agree = float((ids == ids_f)[both].float().mean())
        if id_agree < 0.9999999:
            raise AssertionError(f"native refit frame {k}: instance ids "
                                 f"disagree with a fresh build: {id_agree}")
        log(f"   native refit frame {k}: refit {refit_ms[-1]:.2f} ms, frame "
            f"{frame_ms[-1]:.1f} ms; t bit-equal to a fresh build, instance "
            f"id agreement {id_agree:.7f}; slots holding another BLAS than "
            f"at the build: {moved}; diag {json.dumps(dg)}")
        del fresh
    dt = sum(frame_ms) / len(frame_ms) / 1e3
    out["rigid_refit"] = {
        "frames_per_sec": 1.0 / dt, "mrays": ANIM * ANIM / dt / 1e6,
        "route": "tlas_native", "instances": len(mtlas.source_instances),
        "refit_ms": sum(refit_ms) / len(refit_ms),
        "frames_with_slots_moved": reordered}
    log(f"[10] (c) rigid refit on the native route, {ANIM}x{ANIM} ({card}): "
        f"{json.dumps(out['rigid_refit'])} ({time.time() - t1:.1f} s)")

    # (d) the thresholds: the 1080p primary at SWEEP_COUNTS instances of
    # multi64 (spread over its BLASes) through the three routes
    t1 = time.time()
    sweep_rows = []
    for k in SWEEP_COUNTS:
        pick = np.round(np.linspace(0, 63, k)).astype(int)
        sub = accel.BuildTopAccelStruct([
            types.Instance(base_tf[i], 0, j,
                           mtlas.source_instances[i].bottom_accel_struct)
            for j, i in enumerate(pick)]).device_scene(dev)
        smt = s3m.multi_tables(sub)
        r = {"instances": k}
        r["sweeps_ms"], ref = cuda_ms(lambda: pk.trace_rays_packet_multi(
            sub, o1, d1, TMIN, TMAX), 3)
        r["scan_ms"], _ = cuda_ms(lambda: s3m.trace_rows_multi(
            sub, smt, rows, TMIN, TMAX), 3)
        r["native_ms"], (got, dg) = driven(pk, stg, total, lambda: cuda_ms(
            lambda: s3m.trace_rows_tlas(sub, smt, rows, TMIN, TMAX,
                                        with_diag=True), 3))
        if bool(ref.hit.any()):
            hold_prims(f"native vs sweeps at {k} instances", got.t,
                       got.prim, ref.t, ref.prim)
        elif bool(got.hit.any()):
            raise AssertionError(f"native hits where the sweeps miss every "
                                 f"ray ({k} instances)")
        r.update(hit_rate=float(ref.hit.float().mean()),
                 slots_alive=dg["slots_alive"], scap=dg["scap"],
                 residual_rays=dg["residual_rays"])
        sweep_rows.append(r)
        log(f"[10] (d) {k} instances, 1080p primary ({card}): sweeps "
            f"{r['sweeps_ms']:.3f} ms, scan {r['scan_ms']:.3f} ms, native "
            f"{r['native_ms']:.3f} ms; {json.dumps(dg)}")
        del sub, smt, ref, got
    out["threshold_sweep"] = sweep_rows
    log(f"[10] (d) done in {time.time() - t1:.1f} s")

    out["launches"] = total
    out["held"] = held
    need = ("emit", "refine", "transpose", "isect", "isect_occl", "oscal",
            "packet_trace[closest]", "packet_trace[any_hit]")
    if any(total.get(k, 0) <= 0 for k in need):
        raise AssertionError(f"phase 10 missed a kernel: {total}")
    log(f"[10] launches of the native route in the phase: {total}")
    return out


# ---- phase 11: temporal t-bounds -----------------------------------------

INTERIOR_TRIS = 1_000_000     # bench.py's N_TRIS (bench.py --tbound)
TB_SAMPLES = 4                # bench.py's RADIANCE_TB_SAMPLES
TB_TMAX = 1e4                 # bench.py --tbound's tmax (bench.py:840-845)
TB_LOW_CAP = 8                # TB_RES_RAYS for (d)'s overflow, as
                              # tests/test_engine.py:275-321 sets it
TB_STAGES = ("_stage_prep", "stage_emit", "stage_refine",
             "_apply_block_bound", "feats_rows_to_major", "stage_isect",
             "_stage_glue", "_run", "retrace_flagged", "_tb_residual",
             "trace_rows_stream3")


def interior_rays(dev, w, h, jitter, pcg3d, tiles=True):
    """bench.camera_rays for the interior scene (bench.py:192-228): tile-
    ordered 32x32-pixel packets from (0, 6, 46) with the engine's per-
    pixel PCG sub-pixel jitter of sample `jitter` (pcg3d: bench's numpy
    _pcg3d_np); with tiles False the same rays in pixel order."""
    n = w * h
    ts = 32
    px = np.arange(n, dtype=np.int64) % w
    py = np.arange(n, dtype=np.int64) // w
    tile = (py // ts) * (w // ts) + (px // ts)
    order = (np.argsort(tile * 1024 + (py % ts) * ts + (px % ts)) if tiles
             else np.arange(n))
    rnd = pcg3d(np.stack(
        [np.full(n, jitter, np.uint32), np.zeros(n, np.uint32),
         order.astype(np.uint32)], -1))
    jx, jy = rnd[:, 0] - 0.5, rnd[:, 1] - 0.5
    xs = (px[order] + jx) / w - 0.5
    ys = (py[order] + jy) / h - 0.5
    o = np.zeros((n, 3), np.float32)
    o[:, 1] = 6.0
    o[:, 2] = 46.0
    d = np.stack([xs * 1.2, ys * 0.7, np.full(n, -1.0)], axis=-1)
    d = d.astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def interior_light():
    """bench.light_vec() for the interior (bench.py:232-237): the unit
    to-light direction, up through the ceiling's window openings."""
    v = np.array([0.15, 1.0, 0.05], np.float64)
    return (v / np.linalg.norm(v)).astype(np.float32)


def tb_diag(diag):
    """The temporal counters of a bounded trace's diag, as ints."""
    return {k: int(diag[k]) for k in ("block_pairs", "block_pairs_bounded",
                                      "tb_residual", "tb_cap", "tb_marked")}


def bounded_launch(s3, stg, pk, fn, hold):
    """One trace under torch.profiler with every kernel dispatcher's call
    recorded: D's kernel ms (its one launch) and the packet kernel's
    launches' ms; with hold, D held against its plain version on its
    recorded arguments and bounded (isect_launch)."""
    out, calls, ms = profiled(pk, s3, lambda _: fn(), keep_args=hold)
    if len(ms["isect"]) != 1:
        raise AssertionError(f"a 1080p wave launched D {len(ms['isect'])} "
                             f"times")
    r = dict(ms=ms["isect"][0], packet_ms=ms["packet_trace"])
    if hold:
        (_, a, k, res), = calls["isect"]
        h = isect_launch(stg, a + (k["pcap"], k["stable"]), res)
        hold_prims("D on the bounded 1080p wave vs plain", h["t_k"],
                   h["prim_k"], h["t_p"], h["prim_p"])
        r.update(plain_ms=h["plain_ms"], bound_ms=h["bound"][0],
                 bound_by=h["bound"][1], words=h["words"])
    return out, r


def temporal_bounds(dev, card, tracer, bench, pk, s3, s3m, stg):
    """Phase 11: temporal t-bounds.  (a) bench.py's interior hall at
    INTERIOR_TRIS triangles (the port's interior_hall, SAH, one instance);
    (b) bench.py --tbound's shape wave by wave: TB_SAMPLES jittered
    1080p primary waves, each after the first bounded by the previous
    one's block_bound_from_t, against the unbounded traces, timed as
    chains with CUDA events, D's launch with and without the bound from
    torch.profiler and the bounded one held against its plain version;
    (c) engine frames of the interior at 1080p, batch 4, depth 4, with
    and without tbound, two frames each (total_samples 0, then 4), warm;
    (d) multi64's 1080p primary and shadow waves on the scan and on the
    native route, bounded by the previous identical trace, then by 0.5
    on every block with the residual's floor at TB_LOW_CAP, through the
    engine's _traced_wavefront.  Launch counts: every bounded run and the
    frames of (c).  Returns the counts and the phase's metrics."""
    from radiance_tpu_torch.api import accel
    from radiance_tpu_torch.core import math as rmath
    from radiance_tpu_torch.core import types
    from radiance_tpu_torch.engine import pathtracer
    from radiance_tpu_torch.ops.intersect import FLT_MAX
    from radiance_tpu_torch.scene import procedural

    total, out = {}, {}
    n = W * H

    # (a) the interior hall
    t0 = time.time()
    verts, tris, meta = procedural.interior_hall(INTERIOR_TRIS)
    tg = time.time() - t0
    blas = accel.BuildBottomAccelStruct(types.Mesh(verts, tris))
    tlas = accel.BuildTopAccelStruct(
        [types.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)])
    scene = tlas.device_scene(dev)
    torch.cuda.synchronize()
    if not s3.supports(scene):
        raise AssertionError("the interior's leaves do not fit stream3")
    mib = sum(x.numel() * x.element_size()
              for x in (scene.knode_f, scene.kleaf)) / 2 ** 20
    out["scene"] = dict(tris=int(len(tris)), leaves=int(scene.kleaf.shape[0]),
                        table_mib=mib, meta_camera=meta["camera_origin"])
    log(f"[11] (a) interior hall: {len(tris)} tris (geometry {tg:.1f} s, "
        f"SAH and tables {time.time() - t0 - tg:.1f} s), "
        f"{scene.kleaf.shape[0]} leaves, knode_f + kleaf {mib:.1f} MiB; "
        f"camera origin {meta['camera_origin']}")

    # (b) bench.py --tbound, wave by wave
    t1 = time.time()
    rows = []
    for s in range(TB_SAMPLES):
        o, d = interior_rays(dev, W, H, s, bench._pcg3d_np)
        rows.append(s3.rows_from_aos_fast(o, d))
    del o, d

    def free(r):
        return s3.trace_rows_stream3(scene, r, TMIN, TB_TMAX)

    def bounded(r, bb, diag=False):
        return s3.trace_rows_stream3(scene, r, TMIN, TB_TMAX, blk_bound=bb,
                                     with_diag=diag)

    rec0 = free(rows[0])
    rec1b, dg1 = driven(pk, stg, total, lambda: bounded(
        rows[1], s3.block_bound_from_t(rec0.t), True))
    rec1f = free(rows[1])
    hit_b, hit_f = rec1b.hit, rec1f.hit
    close = torch.isclose(rec1b.t, rec1f.t, rtol=2e-3, atol=1e-3)
    mism = (hit_b != hit_f) | (hit_b & hit_f & ~close)
    exact_frac = 1.0 - float(mism.float().mean())
    log(f"[11] (b) tbound validation: {int(mism.sum())}/{n} rays differ from "
        f"the unbounded trace (exact_frac {exact_frac:.7f}); sample 1 "
        f"{json.dumps(tb_diag(dg1))}")
    if float(mism.float().mean()) > 1e-4:
        raise AssertionError(f"bounded trace diverged on {int(mism.sum())}"
                             f"/{n} rays")
    hold_prims("interior sample 1, bounded vs unbounded", rec1b.t,
               rec1b.prim, rec1f.t, rec1f.prim)
    if int(dg1["tb_marked"]) or bool((rec1b.slot == -2).any()):
        raise AssertionError(f"the bounded wave marked rays -2 at the "
                             f"default cap: {tb_diag(dg1)}")
    del rec1b, rec1f, hit_b, hit_f, close, mism

    def chain(bound_it):
        rec = free(rows[0])
        for s in range(1, TB_SAMPLES):
            rec = (bounded(rows[s], s3.block_bound_from_t(rec.t)) if bound_it
                   else free(rows[s]))
        return rec

    driven(pk, stg, total, lambda: chain(True))           # warm
    dt_b, _ = driven(pk, stg, total, lambda: cuda_ms(lambda: chain(True), 3,
                                                     warmup=False))
    dt_f, _ = cuda_ms(lambda: chain(False), 3)
    dt_b, dt_f = dt_b / TB_SAMPLES, dt_f / TB_SAMPLES
    metric = {"metric": "tbound_primary_mrays_per_sec_interior",
              "value": n / dt_b / 1e3, "unit": "Mrays/s",
              "unbounded_mrays": n / dt_f / 1e3, "speedup": dt_f / dt_b,
              "exact_frac": exact_frac, "samples": TB_SAMPLES, "w": W,
              "h": H}
    log(f"[11] (b) bench.py --tbound's line ({card}): {json.dumps(metric)}")
    out["bench"] = metric
    # where a wave's time goes, bounded (by sample 0) and unbounded
    # (sample 1's rays, warm, CUDA events around each stage)
    bb0 = s3.block_bound_from_t(rec0.t)
    spans = {}
    for name, fn in (("bounded", lambda: bounded(rows[1], bb0)),
                     ("unbounded", lambda: free(rows[1]))):
        fn()
        _, ms, _ = call_spans(s3, TB_STAGES, fn)
        spans[name] = {k: round(sum(v), 4) for k, v in ms.items() if v}
        log(f"[11] (b) {name} wave by stage (ms, CUDA events, {card}): "
            f"{json.dumps(spans[name])}")
    out["stages"] = spans

    # each bounded sample: the cull's pairs, the residual against its
    # cap, and D with and without the bound (torch.profiler)
    per_sample = []
    prev = rec0
    for s in range(1, TB_SAMPLES):
        bb = s3.block_bound_from_t(prev.t)
        (rec, dg), d_b = driven(pk, stg, total, lambda: bounded_launch(
            s3, stg, pk, lambda: bounded(rows[s], bb, True), hold=True))
        _, d_f = bounded_launch(s3, stg, pk, lambda: free(rows[s]),
                                hold=False)
        row = dict(sample=s, **tb_diag(dg), d_bounded_ms=d_b["ms"],
                   d_unbounded_ms=d_f["ms"], d_plain_ms=d_b["plain_ms"],
                   d_bound_ms=d_b["bound_ms"], d_bound_by=d_b["bound_by"],
                   residual_packet_ms=sum(d_b["packet_ms"]),
                   residual_packet_launches=len(d_b["packet_ms"]),
                   flagged=int(dg["flagged"]))
        per_sample.append(row)
        log(f"[11] (b) sample {s} ({card}): pairs {row['block_pairs']} -> "
            f"{row['block_pairs_bounded']} "
            f"({1 - row['block_pairs_bounded'] / row['block_pairs']:.4f} "
            f"culled); temporal residual {row['tb_residual']} rays of a cap "
            f"of {row['tb_cap']} ({row['tb_residual'] / n:.5f} of the "
            f"wave), marked -2 {row['tb_marked']}; D bounded "
            f"{d_b['ms']:.4f} ms, unbounded {d_f['ms']:.4f} ms, plain "
            f"{d_b['plain_ms']:.1f} ms, bound {d_b['bound_ms']:.4f} ms "
            f"({d_b['bound_by']}); the residual's packet kernel "
            f"{row['residual_packet_ms']:.4f} ms in "
            f"{row['residual_packet_launches']} launches")
        if row["tb_marked"]:
            raise AssertionError(f"sample {s} marked rays -2: {row}")
        prev = rec
    out["samples"] = per_sample
    isect = {k: sum(r[src] for r in per_sample) / len(per_sample)
             for k, src in (("ms", "d_bounded_ms"),
                            ("unbounded_ms", "d_unbounded_ms"),
                            ("plain_ms", "d_plain_ms"),
                            ("bound_ms", "d_bound_ms"),
                            ("block_pairs", "block_pairs"),
                            ("block_pairs_bounded", "block_pairs_bounded"))}
    isect["bound_by"] = per_sample[-1]["d_bound_by"]
    out["isect_1080p"] = isect
    del rows, rec0, prev, rec
    log(f"[11] (b) done in {time.time() - t1:.1f} s")

    # (c) engine frames on the interior, with and without tbound
    t1 = time.time()
    light = interior_light()
    res = city_resources(dev, verts, tris, W, H, eye=meta["camera_origin"],
                         light=tuple(float(-x) for x in light))
    frames = {}
    for tb in (False, True):
        tr = dataclasses.replace(tracer, tbound=tb)
        count = ((lambda f: driven(pk, stg, total, f)) if tb
                 else (lambda f: f()))
        # warm, recording each primary wave's counters
        waves = []
        real = s3.trace_rows_stream3

        def recorded(*a, **k):
            rec_w, dg = real(*a, **dict(k, with_diag=True))
            waves.append({kk: int(dg[kk]) for kk in (
                "flagged", "residual_rays", "block_pairs",
                "block_pairs_bounded", "tb_residual", "tb_marked")
                if kk in dg})
            return rec_w

        s3.trace_rows_stream3 = recorded
        try:
            count(lambda: tr.render(scene, res, torch.zeros(n, 3, device=dev),
                                    0, W, H, batch=4, depth=4))
        finally:
            s3.trace_rows_stream3 = real
        torch.cuda.synchronize()
        log(f"    tbound {tb}: the warm frame's primary waves "
            f"{json.dumps(waves)}")
        accum = torch.zeros(n, 3, device=dev)
        ms, prim = [], []
        for ts in (0, 4):
            tf0 = time.time()
            (accum, image), spans, _ = count(lambda: call_spans(
                s3, ("trace_rows_stream3",),
                lambda: tr.render(scene, res, accum, ts, W, H, batch=4,
                                  depth=4)))
            ms.append((time.time() - tf0) * 1e3)
            prim.append(spans["trace_rows_stream3"])
        frames[tb] = dict(ms=ms, primary_ms=prim, warm_waves=waves,
                          accum=accum, image=image)
        log(f"[11] (c) interior frame 1920x1080 batch 4 depth 4, tbound "
            f"{tb} ({card}): {', '.join(f'{m:.1f}' for m in ms)} ms; primary "
            f"waves (ms, CUDA events) "
            f"{json.dumps([[round(x, 4) for x in p] for p in prim])}")
    check_frame("interior tbound", frames[True]["accum"],
                frames[True]["image"], n)
    a_t, a_f = frames[True]["accum"], frames[False]["accum"]
    i_t, i_f = frames[True]["image"], frames[False]["image"]
    rmse = float((i_t[..., :3].float() - i_f[..., :3].float()).pow(2)
                 .mean().sqrt())
    differ = int((i_t != i_f).any(dim=-1).sum())
    log(f"[11] (c) tbound against unbounded: accum max |diff| "
        f"{float((a_t - a_f).abs().max()):.3e}, u8 RMSE {rmse:.4f}, "
        f"{differ} pixels differ ({time.time() - t1:.1f} s)")
    if not torch.allclose(a_t, a_f, rtol=1e-3, atol=1e-4) or rmse > 0.5:
        raise AssertionError(f"bounded frames differ from unbounded: RMSE "
                             f"{rmse}, {differ} pixels")
    out["frames"] = {str(k): {m: v for m, v in f.items()
                              if m not in ("accum", "image")}
                     for k, f in frames.items()}
    out["frames"].update(rmse=rmse, pixels_differ=differ)
    del frames, a_t, a_f, i_t, i_f, res, tlas, blas
    # the interior's scene for phase [12] (main() takes it out of `out`)
    out["interior"] = scene
    del scene

    # (d) the many-instance routes
    t1 = time.time()
    mscene, _, _ = multi64_scene(dev, W, H)
    mt = s3m.multi_tables(mscene)
    o1, d1 = camera_rays(dev, W, H)
    mrows = s3.rows_from_aos_fast(o1, d1)
    mlight = torch.from_numpy(bench.light_vec()).to(dev).expand(n, 3) \
        .contiguous()
    out["multi"] = {}
    for route in ("scan", "native"):
        native = route == "native"

        def trace(r, **kw):
            return s3m.trace_rows_multi(mscene, mt, r, TMIN, TMAX,
                                        native=native, **kw)

        base = trace(mrows)
        ok = base.slot != -2
        rec, dg = driven(pk, stg, total, lambda: trace(
            mrows, blk_bound=s3.block_bound_from_t(
                torch.where(ok, base.t, FLT_MAX)), with_diag=True))
        agree = {f: float((getattr(rec, f) == getattr(base, f))[ok]
                          .float().mean()) for f in ("prim", "slot")}
        agree["hit"] = float((rec.hit == base.hit)[ok].float().mean())
        if min(agree.values()) < 1.0 or int(dg["tb_marked"]):
            raise AssertionError(f"{route} primary: bounded differs from "
                                 f"unbounded: {agree}, {tb_diag(dg)}")
        # the shadow wave, bounded by the closest hits of the same rays
        so, _ = bounce_rays(rmath, o1, d1, base.t, FLT_MAX)
        srows = s3.rows_from_aos_fast(so, mlight)
        live = base.hit
        sclose = trace(srows, live=live)
        socc = trace(srows, live=live, occl=True)
        sok = live & (socc.slot != -2) & (sclose.slot != -2)
        occ, sdg = driven(pk, stg, total, lambda: trace(
            srows, live=live, occl=True, with_diag=True,
            blk_bound=s3.block_bound_from_t(
                torch.where(sclose.slot != -2, sclose.t, FLT_MAX))))
        if not torch.equal(occ.hit[sok], socc.hit[sok]) or int(
                sdg["tb_marked"]):
            raise AssertionError(f"{route} shadow: bounded occluded-or-not "
                                 f"differs from unbounded: {tb_diag(sdg)}")
        row = dict(primary=dict(tb_diag(dg), agree=agree,
                                poisoned=int((~ok).sum())),
                   shadow=dict(tb_diag(sdg), live=int(live.sum()),
                               occluded=int(socc.hit[sok].sum())))
        # a bound of 0.5 on every block: every ray residual, past a cap of
        # max(TB_LOW_CAP, n // 128) rays marked -2; the engine's
        # _traced_wavefront re-traces them through the packet sweeps
        bad = torch.full((-(-n // s3.BLK),), 0.5, device=dev)
        cap_was = s3.TB_RES_RAYS
        s3.TB_RES_RAYS = TB_LOW_CAP
        try:
            for wave, (o, d, alive, occl, ref) in (
                    ("primary", (o1, d1, torch.ones_like(live), False, base)),
                    ("shadow", (so, mlight, live, True, socc))):
                r_rows = mrows if wave == "primary" else srows
                marked, mdg = driven(pk, stg, total, lambda: trace(
                    r_rows, live=None if wave == "primary" else alive,
                    occl=occl, blk_bound=bad, with_diag=True))
                # every primary ray lies past 0.5, so the cap overflows;
                # a shadow ray is residual where the cull unoccludes it
                n_marked = int((marked.slot == -2).sum())
                full = int(mdg["tb_residual"]) == int(mdg["tb_cap"])
                if (int(mdg["tb_marked"]) != n_marked
                        or (n_marked == 0 and wave == "primary")
                        or (n_marked > 0 and not full)):
                    raise AssertionError(f"{route} {wave}, bound 0.5: "
                                         f"{tb_diag(mdg)}")
                got = driven(pk, stg, total, lambda:
                             pathtracer._traced_wavefront(
                                 mscene, o, d, TMIN, TMAX, alive,
                                 route="argsort", multi_route=route,
                                 any_hit_terminate=occl, blk_bound=bad))
                if bool((got.slot < -1).any()):
                    raise AssertionError(f"{route} {wave}: a slot below -1 "
                                         f"left _traced_wavefront")
                keep = alive & (ref.slot != -2)
                if occl:
                    hold_occluded(f"{route} shadow, bound 0.5 through "
                                  f"_traced_wavefront vs unbounded",
                                  got.hit, ref.hit, keep)
                else:
                    hold_prims(f"{route} primary, bound 0.5 through "
                               f"_traced_wavefront vs unbounded",
                               got.t[keep], got.prim[keep], ref.t[keep],
                               ref.prim[keep])
                row[f"{wave}_bound_0.5"] = dict(
                    tb_diag(mdg), hit_agree=float(
                        (got.hit == ref.hit)[keep].float().mean()))
                del marked, got
        finally:
            s3.TB_RES_RAYS = cap_was
        out["multi"][route] = row
        log(f"[11] (d) multi64 on the {route} ({card}): {json.dumps(row)}")
        del base, rec, so, srows, sclose, socc, occ
    del mscene, mt
    log(f"[11] (d) done in {time.time() - t1:.1f} s")

    out["launches"] = total
    need = ("emit", "refine", "transpose", "aos_rows", "isect",
            "isect_occl", "oscal", "packet_trace[closest]",
            "packet_trace[any_hit]", "packet_trace[masked_any_hit]")
    if any(total.get(k, 0) <= 0 for k in need):
        raise AssertionError(f"phase 11 missed a kernel: {total}")
    log(f"[11] launches of the bounded runs in the phase: {total}")
    return out


# ---- phase 12: ray and word ordering --------------------------------------

XLA_SIDE = 256                # the xla-bounce frame's side: the walk takes
                              # 1-2 s a trace (phase [9]), so a 1080p frame
                              # would not fit the time limit (a size cut)
ORDER_STAGES = ("_block_sort", "_stage_prep", "stage_emit", "stage_refine",
                "feats_rows_to_major", "stage_isect", "_stage_glue", "_run",
                "retrace_flagged", "trace_rows_stream3")
ORDER_FORMS = {   # JSON name -> (form count key, source, TPU kernel)
    "stream3_refine[tqsort]": ("refine[tqsort]", S3_SRC + "s3_refine.cu",
                               "radiance_tpu/ops/stream3.py:1635"),
    "stream3_isect[lean]": ("isect[lean]", S3_SRC + "s3_isect.cu",
                            "radiance_tpu/ops/stream3.py:1853"),
    "stream3_isect[cull]": ("isect[cull]", S3_SRC + "s3_isect.cu",
                            "radiance_tpu/ops/stream3.py:1853"),
}


def bits_equal(a, b) -> bool:
    """Two f32 tensors equal bit for bit."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def hold_same(name, got, ref):
    """Two exact tracers' records of the same closest-hit rays: the
    parity bars (hold_prims), and the share of rays with bit-equal t and
    equal prims logged (a ray re-traced by the packet kernel in one and
    by D in the other rounds its t apart)."""
    res = hold_prims(name, got.t, got.prim, ref.t, ref.prim)
    res["t_bit_equal"] = float((got.t.view(torch.int32)
                                == ref.t.view(torch.int32)).float().mean())
    res["prim_equal"] = float((got.prim == ref.prim).float().mean())
    log(f"    {name}: t bit-equal on {res['t_bit_equal']:.7f}, prims equal "
        f"on {res['prim_equal']:.7f} of the rays")
    return res


def bary64(scene, o, d, prim):
    """Float64 Moeller-Trumbore barycentrics (b1, b2) of rays o, d [k, 3]
    (world space) on their winning primitives prim [k] (kernel face
    through the inverse of kprim), the witness for two f32 forms."""
    kp = scene.kprim.long()
    nf = kp.shape[0]
    iprim = torch.zeros(nf, dtype=torch.long, device=kp.device)
    iprim[torch.where(kp >= 0, kp, nf - 1)] = torch.arange(nf,
                                                           device=kp.device)
    geo = scene.ktri_geo[iprim[prim.long()]].double()
    inv = scene.inst_inv[0].double()
    o = o.double() @ inv[:3, :3].T + inv[:3, 3]
    d = d.double() @ inv[:3, :3].T
    v0, e1, e2 = geo[:, 0:3], geo[:, 3:6], geo[:, 6:9]
    p = torch.cross(d, e2, dim=1)
    inv_det = 1.0 / (e1 * p).sum(1)
    tv = o - v0
    q = torch.cross(tv, e1, dim=1)
    return (tv * p).sum(1) * inv_det, (d * q).sum(1) * inv_det


def hold_lean_barys(name, scene, rec, base, o, d):
    """The lean form's barycentrics (stream3._winner_barys, the
    reference's: Moeller-Trumbore from ktri_geo) against the default
    form's (Pluecker ratios in kernel D) on the rays both hit with one
    prim: within tests/test_stream3.py:117-122's bar (allclose, rtol 2e-3,
    atol 2e-3) on at least 1 - 1e-4 of them.  Where a ray misses that
    bar, the float64 witness (bary64) says how far each f32 form is from
    the truth: the lean form's tvec = o - v0 carries |o| * eps, which the
    default's leaf-local frames do not, and a sliver triangle amplifies
    both.  Returns the counts and maxima."""
    same = rec.hit & base.hit & (rec.prim == base.prim)
    idx = torch.nonzero(same).squeeze(1)
    bl = torch.stack([rec.b1[idx], rec.b2[idx]], 1)
    bd = torch.stack([base.b1[idx], base.b2[idx]], 1)
    off = ((bl - bd).abs() > 2e-3 + 2e-3 * bd.abs()).any(1)
    bad = idx[off]
    res = dict(name=name, rays=int(idx.numel()), beyond_bar=int(bad.numel()),
               max_diff=float((bl - bd).abs().max()) if idx.numel() else 0.0)
    if bad.numel():
        w = torch.stack(bary64(scene, o[bad], d[bad], rec.prim[bad]), 1)
        res.update(lean_vs_f64_max=float((bl[off].double() - w).abs().max()),
                   default_vs_f64_max=float(
                       (bd[off].double() - w).abs().max()))
    log("  ", json.dumps(res))
    if res["beyond_bar"] > 1e-4 * max(res["rays"], 1):
        raise AssertionError(f"{name}: lean barycentrics: {res}")
    return res


def c_and_d_forms(where, card, scene, rows, tmax, s3, stg):
    """Phase 12 (c) on one 1080p wave: kernel C with and without its
    tq-sort form against _refine_plain (word lists identical; the sorted
    lists the unsorted ones in stable bucket order), then kernel D on
    both lists in each of its forms against _isect_plain with the same
    flags (the parity bars on live slots; each version's t bit-equal to
    its own default form's, prims >= 0.999 of it; lean lanes 2-3 zero),
    each timed with CUDA events, with its plain ms, bound and the pairs
    each cull skipped: the kernel's, counted on the card, must be more
    than none where the plain cull skips any (on the interior it must)
    and no more than the plain's whole-list rule skips.  Returns {form:
    numbers}."""
    dev = rows[0].device
    stable = scene.stable_frames
    _, feats_t, scal, smeta, bscal, _ = s3._stage_prep(
        rows, scene.knode_f, scene.inst_inv[0], stable=stable)
    words, emeta = stg.emit_cuda(scal, smeta, bscal, scene.knode_f, tmax,
                                 stg.STEP_CAP, stg.PCAP)
    slot_pkt = smeta[:, 0].contiguous()
    c_args = (words, emeta, slot_pkt, feats_t,
              s3.leaf_aabb8(scene.knode_f, scene.kleaf.shape[0]), tmax,
              stg.PCAP)
    forms, lists = {}, {}
    for sort in (False, True):
        ms, (rk, rek) = cuda_ms(lambda: stg.refine_cuda(*c_args, sort=sort),
                                5)
        p_ms, (rp, rep) = cuda_ms(lambda: stg._refine_plain(
            *c_args, sort=sort), 1, warmup=False)
        diff = first_word_diff(rk, rp, rep[:, 0])
        if not torch.equal(rek, rep) or diff is not None:
            raise AssertionError(f"{where} refine sort={sort}: kernel and "
                                 f"plain differ: {diff}")
        b, nw, kept = refine_bound(stg, words, emeta, rek, stg.PCAP)
        lists[sort] = (rk, rek)
        forms[f"refine/sort={sort}"] = dict(ms=ms, plain_ms=p_ms, bound=b,
                                            words=nw, kept=kept,
                                            max_abs_err=0.0)
    valid = (torch.arange(stg.PCAP, device=dev)[None, :]
             < lists[False][1][:, :1])
    u = lists[False][0]
    order = torch.argsort(torch.where(valid, stg.tq_bucket(u), 32), dim=1,
                          stable=True)
    if not torch.equal(torch.gather(u, 1, order)[valid],
                       lists[True][0][valid]):
        raise AssertionError(f"{where}: C's sorted lists are not its "
                             f"unsorted lists in stable tq-bucket order")
    log(f"[12] (c) C on the {where} 1080p primary ({card}): word lists "
        f"identical to plain, sorted and unsorted; "
        f"{json.dumps({k: round(v['ms'], 4) for k, v in forms.items()})} ms")
    feats = stg.transpose_cuda(feats_t)
    live = smeta[:, 1] > 0
    for sort in (False, True):
        args = (*lists[sort], slot_pkt, feats, scene.kleaf, TMIN, tmax,
                stg.PCAP, stable)
        base_k = stg.isect_cuda(*args)
        base_p = stg._isect_plain(*args)
        for lean, cull in ((False, False), (True, False), (False, True),
                           (True, True)):
            name = f"isect/sort={sort}/lean={lean}/cull={cull}"
            ms, ok = cuda_ms(lambda: stg.isect_cuda(*args, lean=lean,
                                                    cull=cull), 5)
            st = {}
            p_ms, op = cuda_ms(lambda: stg._isect_plain(
                *args, lean=lean, cull=cull, stats=st), 1, warmup=False)
            h = hold_prims(f"D {name} vs plain, {where}",
                           ok[live][..., 0].reshape(-1),
                           ok[live][..., 1].reshape(-1),
                           op[live][..., 0].reshape(-1),
                           op[live][..., 1].reshape(-1))
            for got, base, who in ((ok, base_k, "kernel"),
                                   (op, base_p, "plain")):
                share = float((got[..., 1] == base[..., 1])[live]
                              .float().mean())
                if not bits_equal(got[..., 0], base[..., 0]) or share < 0.999:
                    raise AssertionError(f"D {name}, {where}: the {who}'s t "
                                         f"or prims moved from its default "
                                         f"form (prims {share})")
            if lean and (bool(ok[..., 2:].any()) or bool(op[..., 2:].any())):
                raise AssertionError(f"D {name}: lean lanes 2-3 not zero")
            kst = {}
            stg.isect_cuda(*args, lean=lean, cull=cull, stats=kst)
            k_cul, p_cul = kst.get("culled", 0), st.get("culled", 0)
            if cull and (k_cul > p_cul or (k_cul > 0) != (p_cul > 0)
                         or (where == "interior" and p_cul == 0)):
                raise AssertionError(f"D {name}, {where}: the kernel's cull "
                                     f"skipped {k_cul} pairs, the plain "
                                     f"cull {p_cul}")
            b = pair_bound(stg, args, st, ok)[0]
            forms[name] = dict(ms=ms, plain_ms=p_ms, bound=b,
                               pairs=st["pairs"], culled=p_cul,
                               kernel_culled=k_cul,
                               max_abs_err=h["max_abs_err"])
            log(f"    D {name}, {where} ({card}): {ms:.4f} ms, plain "
                f"{p_ms:.1f} ms, bound {b[0]:.4f} ms ({b[1]}); pairs "
                f"{st['pairs']}, culled {p_cul} (plain), {k_cul} (kernel); "
                f"t bit-equal to the default form")
    out = {k: dict(v, bound_ms=v["bound"][0], bound_by=v["bound"][1])
           for k, v in forms.items()}
    for v in out.values():
        del v["bound"]
    return out


def ordering_modes(dev, card, tracer, scene, res, verts, tris, waves, hit1,
                   interior, bench, pk, s3, stg):
    """Phase 12: ray and word ordering on the city at 1080p.  (a) the
    engine's bucket sort (reorder.coherence_perm) on the bounce wave
    against torch.argsort of coherence_key; (b) bench.py's three waves,
    the secondaries on "gen1_sort" and on "gen1_live"; (c) kernel C's
    tq-sort form and kernel D's lean and cull forms on the 1080p primary
    of the city and of phase [11]'s interior hall (`interior`: a closed
    scene, whose blocks hold no miss, so the cull has pairs to skip),
    each against its plain version and timed, with its bound; (d) the
    block presort on the engine's pixel-order primary and the bench's
    tile-ordered one; (e) trace_rows_cascade on the shadow wave and the
    mirror bounce at the 50th and 90th percentile of each wave's hit t;
    (f) build_tracer, plain and with every mode on (the slice's own path:
    its counts are the new forms' launches); (g) engine frames with the
    bounce and shadow waves on "gen1_sort" against the default
    "argsort", and an XLA_SIDE frame with "xla" bounces.  Every run but
    the comparisons' plain versions is driven (counts set to 0 just before
    and read just after); returns the counts and the metrics."""
    from radiance_tpu_torch.engine import pathtracer
    from radiance_tpu_torch.ops import reorder
    from radiance_tpu_torch.ops.intersect import FLT_MAX

    total, out = {}, {}
    n = W * H
    (o1, d1), (o2, d2), (so, light) = (waves["primary"], waves["bounce"],
                                       waves["shadow"])
    t0 = time.time()

    # (a) the bucket sort against the argsort on the bounce wave
    key = torch.where(hit1, pk.coherence_key(o2, d2), 2 ** 31 - 1)
    a_ms, _ = cuda_ms(lambda: torch.argsort(key, stable=True), 10)
    b_ms, (perm, inv) = cuda_ms(lambda: reorder.coherence_perm(d2, hit1), 10)
    ks = reorder.octant_key(d2, hit1)[perm]
    if not (bool(((ks[1:] > ks[:-1]) | ((ks[1:] == ks[:-1])
                                       & (perm[1:] > perm[:-1]))).all())
            and torch.equal(perm[inv], torch.arange(n, device=dev))):
        raise AssertionError("coherence_perm is not the stable sort of the "
                             "octant keys")
    out["reorder"] = dict(bucket_ms=b_ms, argsort_ms=a_ms,
                          live=int(hit1.sum()))
    log(f"[12] (a) bounce wave, {n} rays, {int(hit1.sum())} live ({card}): "
        f"coherence_perm {b_ms:.4f} ms (9 buckets, a stable sort of its "
        f"keys), torch.argsort of coherence_key "
        f"{a_ms:.4f} ms")
    del key, perm, inv, ks

    # (b) bench.py's three waves, the secondaries on gen1_sort / gen1_live
    rows1 = s3.rows_from_aos_fast(o1, d1)
    p_ms, _ = driven(pk, stg, total, lambda: cuda_ms(
        lambda: s3.trace_rows_stream3(scene, rows1, TMIN, TMAX), 3))
    wave_ms = {}
    for name, (o, d, occl) in (("bounce", (o2, d2, False)),
                               ("shadow", (so, light, True))):
        recs = {}
        for route in ("gen1_live", "gen1_sort"):
            wave_ms[f"{name}/{route}"], recs[route] = driven(
                pk, stg, total, lambda: cuda_ms(
                    lambda: pathtracer._traced_wavefront(
                        scene, o, d, TMIN, TMAX, hit1, route=route,
                        any_hit_terminate=occl), 3))
        a, b = recs["gen1_live"], recs["gen1_sort"]
        same = bool(torch.equal(a.hit, b.hit))
        if not occl:
            same = same and bits_equal(a.t, b.t)
            hold_prims(f"{name} wave gen1_sort vs gen1_live", b.t, b.prim,
                       a.t, a.prim)
        if not same:
            raise AssertionError(f"{name} wave: gen1_sort and gen1_live "
                                 f"differ")
        log(f"[12] (b) {name} wave ({card}): gen1_sort "
            f"{wave_ms[name + '/gen1_sort']:.4f} ms, gen1_live "
            f"{wave_ms[name + '/gen1_live']:.4f} ms; "
            f"{'occluded-or-not' if occl else 'hits and t'} identical, "
            f"prims differ on {int((a.prim != b.prim).sum())} rays")
    for route in ("gen1_live", "gen1_sort"):
        tot = p_ms + wave_ms[f"bounce/{route}"] + wave_ms[f"shadow/{route}"]
        wave_ms[f"mrays/{route}"] = 3 * n / tot / 1e3
    wave_ms["primary/stream3"] = p_ms
    out["waves"] = wave_ms
    log(f"[12] (b) three waves ({card}): primary (stream3) {p_ms:.4f} ms; "
        f"{wave_ms['mrays/gen1_sort']:.2f} Mrays/s with the secondaries "
        f"on gen1_sort, {wave_ms['mrays/gen1_live']:.2f} on gen1_live")

    # (c) C's sort form and D's lean and cull forms on the 1080p primaries
    # of the city and the interior
    io, idr = interior_rays(dev, W, H, 0, bench._pcg3d_np)
    forms = {}
    for where, sc, rows_c, tmax in (
            ("city", scene, rows1, TMAX),
            ("interior", interior, s3.rows_from_aos_fast(io, idr), TB_TMAX)):
        forms[where] = c_and_d_forms(where, card, sc, rows_c, tmax, s3, stg)
    out["forms"] = forms
    log(f"[12] (a)-(c) done in {time.time() - t0:.1f} s")

    # (d) the block presort on the engine's and the bench's primaries
    t1 = time.time()
    pix = torch.arange(n, device=dev)
    eo, ed = pathtracer._sample_init(tracer, res, pix, 0, 0)[3:]
    out["presort"] = {}
    for name, (o, d) in (("engine pixel-order", (eo, ed)),
                         ("bench tile-ordered", (o1, d1))):
        rows = s3.rows_from_aos_fast(o, d)
        recs, row = {}, {}
        for ps in (False, True):
            ms, (recs[ps], dg) = driven(pk, stg, total, lambda: cuda_ms(
                lambda: s3.trace_rows_stream3(scene, rows, TMIN, TMAX,
                                              presort=ps, with_diag=True), 3))
            row[f"presort={ps}"] = dict(ms=ms, **{k: int(dg[k]) for k in (
                "words", "kept_words", "steps", "capped", "flagged",
                "residual_rays")})
        for ps in (False, True):
            _, spans, _ = call_spans(s3, ORDER_STAGES, lambda: (
                s3.trace_rows_stream3(scene, rows, TMIN, TMAX, presort=ps)))
            row[f"presort={ps}"]["stages"] = {
                k: round(sum(v), 4) for k, v in spans.items() if v}
        row.update(hold_same(f"{name} primary, presorted vs caller order",
                             recs[True], recs[False]))
        out["presort"][name] = row
        log(f"[12] (d) {name} primary ({card}): "
            f"{json.dumps({k: v for k, v in row.items() if 'presort' in k})}")
    del recs, rows
    # kernel B's step windows on the pixel-order primaries of the city
    # and the interior
    po, pd = interior_rays(dev, W, H, 0, bench._pcg3d_np, tiles=False)
    out["step_windows"] = {
        f"[12] (d) {name}": step_rows_wave(
            f"[12] (d) {name}", stg, s3,
            lambda sc=sc, rows=s3.rows_from_aos_fast(o, d), tmax=tmax:
            s3.trace_rows_stream3(sc, rows, TMIN, tmax, with_diag=True),
            card)
        for name, sc, (o, d), tmax in (
            ("city engine pixel-order primary", scene, (eo, ed), TMAX),
            ("interior pixel-order primary", interior, (po, pd), TB_TMAX))}
    del po, pd

    # (e) the cascade on the shadow wave and the mirror bounce
    out["cascade"] = {}
    for name, (o, d, occl) in (("shadow", (so, light, True)),
                               ("bounce", (o2, d2, False))):
        rows = s3.rows_from_aos_fast(o, d)
        th = s3.trace_rows_stream3(scene, rows, TMIN, TMAX, live=hit1).t
        th = th[th < FLT_MAX]
        if th.numel() == 0:
            raise AssertionError(f"the {name} wave hits nothing")
        f_ms, (full, fdg) = driven(pk, stg, total, lambda: cuda_ms(
            lambda: s3.trace_rows_stream3(scene, rows, TMIN, TMAX, live=hit1,
                                          occl=occl, with_diag=True), 3))
        row = dict(full_ms=f_ms, full_words=int(fdg["words"]),
                   hits=int(th.numel()))
        for q in (0.5, 0.9):
            near = float(torch.quantile(th, q))
            c_ms, (rec, cdg) = driven(pk, stg, total, lambda: cuda_ms(
                lambda: s3.trace_rows_cascade(scene, rows, TMIN, TMAX, near,
                                              live=hit1, occl=occl,
                                              with_diag=True), 3))
            if occl:
                hold_occluded(f"{name} cascade at p{int(q * 100)} vs one "
                              f"stage", rec.hit, full.hit, hit1)
                same = int((rec.hit != full.hit).sum())
            else:
                same = hold_same(f"{name} cascade at p{int(q * 100)} vs one "
                                 f"stage", rec, full)["t_bit_equal"]
            row[f"p{int(q * 100)}"] = dict(
                near=near, ms=c_ms, words_a=int(cdg["a"]["words"]),
                words_b=int(cdg["b"]["words"]),
                **({"hits_differ": same} if occl else {"t_bit_equal": same}))
        out["cascade"][name] = row
        log(f"[12] (e) {name} cascade ({card}): {json.dumps(row)}")
    del rows, th, full, rec
    log(f"[12] (d)-(e) done in {time.time() - t1:.1f} s")

    # (f) build_tracer, plain and with every mode on (the slice's path)
    t1 = time.time()
    bt = s3.build_tracer(scene)
    bt_ms, brec = driven(pk, stg, total, lambda: cuda_ms(
        lambda: bt(o1, d1, TMIN, TMAX), 3))
    ref = s3.trace_rows_stream3(scene, rows1, TMIN, TMAX)
    if not (bits_equal(brec.t, ref.t) and torch.equal(brec.prim, ref.prim)
            and bits_equal(brec.b1, ref.b1) and bits_equal(brec.b2, ref.b2)):
        raise AssertionError("build_tracer differs from trace_rows_stream3 "
                             "with its drain")
    modes = {w: s3.build_tracer(sc, presort=True, tqsort=True, lean=True,
                                cull=True)
             for w, sc in (("city", scene), ("interior", interior))}
    prims = (("bench", "city", o1, d1, TMAX), ("engine", "city", eo, ed, TMAX),
             ("interior", "interior", io, idr, TB_TMAX))
    main = {}
    reset_counts(pk, stg)
    mrecs = [modes[w](o, d, TMIN, tm) for _, w, o, d, tm in prims]
    torch.cuda.synchronize()
    for k, v in launch_counts(pk, stg).items():
        main[k] = v
        total[k] = total.get(k, 0) + v
    m_ms, _ = driven(pk, stg, total, lambda: cuda_ms(
        lambda: modes["city"](o1, d1, TMIN, TMAX), 3))
    lean_barys = {}
    for rec, (name, w, o, d, tm) in zip(mrecs, prims):
        sc = scene if w == "city" else interior
        base = s3.trace_rows_stream3(sc, s3.rows_from_aos_fast(o, d), TMIN,
                                     tm)
        hold_same(f"build_tracer(all modes) vs default, {name} primary",
                  rec, base)
        lean_barys[name] = hold_lean_barys(
            f"lean barycentrics vs default, {name} primary", sc, rec, base,
            o, d)
    out["build_tracer"] = dict(ms=bt_ms, modes_ms=m_ms,
                               lean_barys=lean_barys, main_launches=main)
    log(f"[12] (f) build_tracer on the 1080p primary ({card}): {bt_ms:.4f} "
        f"ms, equal to trace_rows_stream3 bit for bit; with presort, tqsort, "
        f"lean and cull {m_ms:.4f} ms; its launches on the bench's, the "
        f"engine's and the interior's primaries {json.dumps(main)}")
    for key, _, _ in ORDER_FORMS.values():
        if main.get(key, 0) <= 0:
            raise AssertionError(f"the modes' path launched no {key}")
    del mrecs, ref, brec, eo, ed, io, idr
    log(f"[12] (f) done in {time.time() - t1:.1f} s")

    # (g) engine frames: bounce and shadow waves on gen1_sort vs argsort;
    # an XLA_SIDE frame with xla bounces
    t1 = time.time()
    frames = {}
    for name, tr in (("argsort", tracer), ("gen1_sort", dataclasses.replace(
            tracer, bounce_route="gen1_sort", shadow_route="gen1_sort"))):
        driven(pk, stg, total, lambda: tr.render(
            scene, res, torch.zeros(n, 3, device=dev), 0, W, H, batch=4,
            depth=4))
        accum, ms = torch.zeros(n, 3, device=dev), []
        for ts in (0, 4):
            tf0 = time.time()
            accum, image = driven(pk, stg, total, lambda: tr.render(
                scene, res, accum, ts, W, H, batch=4, depth=4))
            ms.append((time.time() - tf0) * 1e3)
        frames[name] = dict(ms=ms, accum=accum, image=image)
        log(f"[12] (g) city frame 1920x1080 batch 4 depth 4, bounce and "
            f"shadow waves on {name} ({card}): "
            f"{', '.join(f'{m:.1f}' for m in ms)} ms")
    check_frame("city gen1_sort", frames["gen1_sort"]["accum"],
                frames["gen1_sort"]["image"], n)
    a_s, a_a = frames["gen1_sort"]["accum"], frames["argsort"]["accum"]
    rmse = float((frames["gen1_sort"]["image"][..., :3].float()
                  - frames["argsort"]["image"][..., :3].float())
                 .pow(2).mean().sqrt())
    diff = float((a_s - a_a).abs().max())
    log(f"[12] (g) gen1_sort against argsort: accum max |diff| {diff:.3e}, "
        f"u8 RMSE {rmse:.4f}")
    if not torch.allclose(a_s, a_a, rtol=1e-3, atol=1e-4) or rmse > 0.5:
        raise AssertionError(f"gen1_sort frames differ from argsort: RMSE "
                             f"{rmse}, max |diff| {diff}")
    out["frames"] = {k: v["ms"] for k, v in frames.items()}
    out["frames"].update(rmse=rmse, accum_max_diff=diff)
    del frames, a_s, a_a
    xres = city_resources(dev, verts, tris, XLA_SIDE, XLA_SIDE)
    xn = XLA_SIDE * XLA_SIDE
    xf = {}
    for name, tr in (("argsort", tracer),
                     ("xla", dataclasses.replace(tracer, bounce_route="xla"))):
        tf0 = time.time()
        acc, img = driven(pk, stg, total, lambda: tr.render(
            scene, xres, torch.zeros(xn, 3, device=dev), 0, XLA_SIDE,
            XLA_SIDE, batch=1, depth=2))
        xf[name] = (acc, img, (time.time() - tf0) * 1e3)
    check_frame("city xla bounces", xf["xla"][0], xf["xla"][1], xn)
    rmse = float((xf["xla"][1][..., :3].float()
                  - xf["argsort"][1][..., :3].float()).pow(2).mean().sqrt())
    log(f"[12] (g) city frame {XLA_SIDE}x{XLA_SIDE} batch 1 depth 2 "
        f"({card}): xla bounces {xf['xla'][2]:.1f} ms, argsort "
        f"{xf['argsort'][2]:.1f} ms; u8 RMSE {rmse:.4f}")
    if rmse >= 2.0:
        raise AssertionError(f"xla-bounce frame differs: RMSE {rmse}")
    out["xla_frame"] = dict(side=XLA_SIDE, xla_ms=xf["xla"][2],
                            argsort_ms=xf["argsort"][2], rmse=rmse)
    del xf, xres
    log(f"[12] (g) done in {time.time() - t1:.1f} s")

    out["launches"] = total
    need = ("emit", "refine", "transpose", "aos_rows", "isect", "isect_occl",
            "oscal", "packet_trace[closest]", "packet_trace[masked_closest]",
            "packet_trace[any_hit]", "packet_trace[masked_any_hit]",
            "refine[tqsort]", "isect[lean]", "isect[cull]")
    if any(total.get(k, 0) <= 0 for k in need):
        raise AssertionError(f"phase 12 missed a kernel: {total}")
    log(f"[12] launches of the driven runs in the phase: {total}")
    return out


# ---- phase 13: sharded frames --------------------------------------------

SHARD_ROUTES = ("stream3", "gen1_sort", "stream3", "gen1_live")
PIXEL_SHARE = 0.9999          # pixels a pixel mode must reproduce exactly
SHARD_NEED = ("emit", "refine", "transpose", "aos_rows", "isect",
              "isect_occl", "oscal", "packet_trace[closest]",
              "packet_trace[masked_closest]", "packet_trace[any_hit]",
              "packet_trace[masked_any_hit]")


def hold_pixel_mode(name, got, want, tracer, scene, res, pk, shards,
                    sample_axis=False):
    """A mode that shards pixels against the unsharded frame: on >=
    PIXEL_SHARE of the pixels the u8 image equal and accum within rtol
    1e-5, atol 1e-6 (with sample_axis, the 2D mode, accum within the
    sample modes' rtol 1e-4, atol 1e-5 and the image not compared).  A
    shard's waves form other packets than the whole frame's, so a ray
    whose two nearest leaves tie may take the other's prim, and its path
    goes elsewhere from there: the pixels that differ are logged with
    their shard, their place in a 1024-ray packet of it and the primary
    hit of their sample 0."""
    from radiance_tpu_torch.engine import pathtracer

    acc, img = got[0], got[1].reshape(-1, 4)
    racc, rimg = want[0], want[1].reshape(-1, 4)
    if sample_axis:
        ok = torch.isclose(acc, racc, rtol=1e-4, atol=1e-5).all(-1)
    else:
        ok = (img == rimg).all(-1) & torch.isclose(acc, racc, rtol=1e-5,
                                                   atol=1e-6).all(-1)
    n = ok.shape[0]
    share = float(ok.float().mean())
    bad = torch.nonzero(~ok).squeeze(1)
    per = -(-n // shards)
    log(f"    {name}: {n - bad.numel()} of {n} pixels equal ({share:.7f}); "
        f"accum max |diff| {float((acc - racc).abs().max()):.3e}")
    if bad.numel():
        pick = bad[:8]
        state = pathtracer._sample_init(tracer, res, pick, 0, 0)
        rec = pk.trace_rays_packet(scene, state[3], state[4], tracer.tmin,
                                   tracer.tmax)
        for j, p in enumerate(pick.tolist()):
            log(f"      pixel ({p % W}, {p // W}), shard {p // per}, ray "
                f"{(p % per) % 1024} of its packet: accum "
                f"{acc[p].tolist()} vs {racc[p].tolist()}, u8 "
                f"{img[p].tolist()} vs {rimg[p].tolist()}; sample 0 primary "
                f"prim {int(rec.prim[j])} t {float(rec.t[j]):.6f}")
    if share < PIXEL_SHARE:
        raise AssertionError(f"{name}: {bad.numel()} pixels differ from the "
                             f"unsharded frame ({share})")
    return dict(equal_share=share, differing=int(bad.numel()))


def hold_sample_mode(name, got, want):
    """The sample-parallel mode (whole-image shards) against render of
    batch n_dev * batch: the JAX tests' rtol 1e-4, atol 1e-5 on every
    pixel."""
    diff = float((got[0] - want[0]).abs().max())
    close = torch.allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    log(f"    {name}: accum max |diff| {diff:.3e}, allclose {close}")
    if not close:
        raise AssertionError(f"{name}: accum differs ({diff})")
    return dict(accum_max_diff=diff)


def sharded_frames(dev, card, tracer, scene, res, pk, stg):
    """Phase 13: parallel/sharding.py on the city at 1920x1080, batch 2,
    depth 2, each mode beside the unsharded frame on the same inputs:
    render_sharded on 3 shards of the card (691,200 pixels a shard: 675
    whole stream3 packets, 10,800 whole packet-kernel packets) and on 4
    (unaligned), sample_parallel_frame on 4 shards of batch 1 against
    render of batch 4, tile_sample_frame on a 3x2 mesh, staged_shard_frame
    with "auto" and with an explicit 4-tuple (SHARD_ROUTES: the primary's
    shadows on stream3, so E runs, and gen1_sort bounces) against
    frame_fn of the same routes, and, where the machine has two cards, a
    real 2-card pixel mesh.  Each run twice (the second warm), timed by
    profiling.timed (host clock ending in a synchronize, its
    box["seconds"]); the sharded runs driven (counts set to 0 just before
    and read just after).  Returns the counts, times and gates."""
    from radiance_tpu_torch.parallel import sharding
    from radiance_tpu_torch.utils import profiling

    total, out = {}, {"ms": {}, "gates": {}}
    n = W * H
    pix = torch.arange(n, device=dev)
    zero = torch.zeros(n, 3, device=dev)

    def frames(name, fn, drive=True):
        ms = out["ms"][name] = []
        for _ in range(2):
            with profiling.timed(name, quiet=True) as box:
                box["sync"] = (driven(pk, stg, total, fn) if drive
                               else fn())
            ms.append(box["seconds"] * 1e3)
        log(f"[13] {name} ({card}): frames " + ", ".join(
            f"{m:.1f}" for m in ms) + " ms")
        return box["sync"]

    def render(batch):
        return lambda: tracer.render(scene, res, zero, 0, W, H, batch=batch,
                                     depth=2)

    ref2 = frames("render b2", render(2), drive=False)
    check_frame("city b2", *ref2, n)
    ref4 = frames("render b4", render(4), drive=False)
    routed = tracer.frame_fn(batch=2, depth=2, routes=SHARD_ROUTES)
    ref_routed = frames("frame_fn b2 routes", lambda: routed(
        scene, res, zero, 0, pix), drive=False)
    mesh3 = sharding.make_mesh(3, devices=[dev] * 3)
    mesh4 = sharding.make_mesh(4, devices=[dev] * 4)
    gates = out["gates"]

    for k, mesh in ((3, mesh3), (4, mesh4)):
        name = f"render_sharded {k} shards"
        got = frames(name, lambda: sharding.render_sharded(
            tracer, mesh, scene, res, zero, 0, W, H, batch=2, depth=2))
        gates[name] = hold_pixel_mode(name, got, ref2, tracer, scene, res,
                                      pk, k)
    fn = sharding.sample_parallel_frame(tracer, mesh4, batch=1, depth=2)
    got = frames("sample_parallel 4x b1", lambda: fn(scene, res, zero, 0,
                                                    pix))
    gates["sample_parallel 4x b1"] = hold_sample_mode(
        "sample_parallel 4x b1 against render b4", got, ref4)
    mesh32 = sharding.make_mesh2d(3, 2, devices=[dev] * 6)
    fn = sharding.tile_sample_frame(tracer, mesh32, batch=1, depth=2)
    got = frames("tile_sample 3x2 b1", lambda: fn(scene, res, zero, 0, pix))
    gates["tile_sample 3x2 b1"] = hold_pixel_mode(
        "tile_sample 3x2 b1 against render b2", got, ref2, tracer, scene,
        res, pk, 3, sample_axis=True)
    for name, routes, mesh, ref in (
            ("staged auto", "auto", mesh3, ref2),
            ("staged 4-tuple", SHARD_ROUTES, mesh4, ref_routed)):
        fn = sharding.staged_shard_frame(tracer, mesh, batch=2, depth=2,
                                         routes=routes)
        got = frames(name, lambda: fn(scene, res, zero, 0, pix))
        gates[name] = hold_pixel_mode(name, got, ref, tracer, scene, res,
                                      pk, mesh.devices.size)
    del got, ref4, ref_routed

    cards = torch.cuda.device_count()
    if cards >= 2:
        mesh2 = sharding.make_mesh(2)
        name = "render_sharded 2 cards"
        got = frames(name, lambda: sharding.render_sharded(
            tracer, mesh2, scene, res, zero, 0, W, H, batch=2, depth=2))
        gates[name] = hold_pixel_mode(name, got, ref2, tracer, scene, res,
                                      pk, 2)
    else:
        log(f"[13] {cards} card on this machine: the 2-card pixel mesh did "
            f"not run")
    out["cards"] = cards
    out["launches"] = total
    if any(total.get(k, 0) <= 0 for k in SHARD_NEED):
        raise AssertionError(f"phase 13 missed a kernel: {total}")
    log(f"[13] launches of the sharded runs in the phase: {total}")
    return out


# ---- phases 14-17: leaf cap and word width, wide leaves, viewers ----------

LEAF_CAP, TQ7 = 64, 7         # the JAX package's LEAF64 configuration
WIDE_CAP = 256                # the wide-leaf probe's cap
VIEW_B, VIEW_D = 4, 2         # sample1's batch and depth in the viewers
PATH_S3 = ("aos_rows", "transpose", "emit", "refine", "isect", "isect_occl",
           "oscal")


def drive_path(pk, stg, name, fn, need):
    """Run fn() with the launch counts set to 0 just before and read just
    after; fail unless every counter of `need` (launch_counts() keys)
    moved.  Returns (fn's result, the counts)."""
    reset_counts(pk, stg)
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts(pk, stg)
    missed = [k for k in need if counts.get(k, 0) <= 0]
    log(f"    {name}: launches {json.dumps(counts)}")
    if missed:
        raise AssertionError(f"{name}: kernels of the path never launched: "
                             f"{missed}")
    return out, counts


# ---- kernel B's step windows: 8 rows (the default) against 1 -------------

STEP_ROWS_TURNS = (8, 1, 1, 8)
STEP_DIAG = ("flagged", "residual_rays", "capped", "poisoned", "steps")


@contextlib.contextmanager
def emit_step_rows(stg, s3, rows, record=None):
    """Every stage_emit call of the stream3 module (its _run: the stream3
    waves and the instance scan's sub-waves) at step_rows=rows; with
    `record` a list, each launch's (emit_args(), (words, emeta), tq
    width) appended."""
    orig = s3.stage_emit

    def emit(*a, **k):
        k["step_rows"] = rows
        out = stg.stage_emit(*a, **k)
        if record is not None and a[0].shape[0]:
            record.append((emit_args(stg, a, k), out,
                           k.get("tq_bits", stg.W_TQ_BITS)))
        return out

    s3.stage_emit = emit
    try:
        yield
    finally:
        s3.stage_emit = orig


def step_rows_wave(name, stg, s3, run, card):
    """One wave with kernel B's step cap counted in windows of 8 rows (the
    reference's compiled walks, the default) and of 1 (its node walk), on
    the same rays: run() traces it with_diag, returning (rec, diag).  The
    wave's ms (CUDA events, a warm call each, in turns 8, 1, 1, 8), then
    one run each with CUDA events around B's stage (stage_emit) and the
    residual (retrace_flagged): the flagged packets, residual rays,
    capped slots and poisoned rays of the diag, the residual's ms, B's ms
    and bound in all, and B's longest walk in step windows and in nodes
    (emit_bounds() over the recorded launches, which checks each
    launch's windows against a walk of its slots); each recorded launch
    of B held against its plain version at the same step_rows
    (emit_hold).  Returns {"8": ..., "1": ...}."""
    ms = {8: [], 1: []}
    for rows in STEP_ROWS_TURNS:
        with emit_step_rows(stg, s3, rows):
            ms[rows].append(cuda_ms(run, 1)[0])
    out = {}
    for rows in (8, 1):
        calls = []
        with emit_step_rows(stg, s3, rows, calls):
            (_, diag), sp, _ = call_spans(
                s3, ("stage_emit", "retrace_flagged"), run)
        walks = emit_bounds(stg, [(a, o[1]) for a, o, _ in calls])
        for a, o, bits in calls:
            emit_hold(stg, a, o, bits)
        out[str(rows)] = dict(
            wave_ms=sum(ms[rows]) / len(ms[rows]),
            **{k: int(diag[k]) for k in STEP_DIAG if k in diag},
            residual_ms=sum(sp["retrace_flagged"]),
            emit_ms=sum(sp["stage_emit"]), emit_launches=len(calls),
            emit_bound_ms=sum(w[0][0] for w in walks),
            emit_nodes=sum(w[1] for w in walks),
            longest_walk=max((int(o[1][:, 2].max()) for _, o, _ in calls),
                             default=0),
            longest_walk_nodes=max((w[3] for w in walks), default=0))
    log(f"   step windows, {name} ({card}): 8 rows "
        f"{json.dumps(out['8'])}; 1 row {json.dumps(out['1'])}; B equal to "
        f"plain on every launch at both")
    return out


def s3_stage_inputs(s3, scene, rows, live=None):
    """A wave's stage inputs on `scene`: prep (padded to whole groups),
    then (feats_t, scal, smeta, bscal, slot_pkt, aabb8, padded live)."""
    rows, live = s3._pad_wave(rows, live)
    _, feats_t, scal, smeta, bscal, _ = s3._stage_prep(
        rows, scene.knode_f, scene.inst_inv[0], live=live,
        stable=scene.stable_frames)
    return (feats_t, scal, smeta, bscal, smeta[:, 0].contiguous(),
            s3.leaf_aabb8(scene.knode_f, scene.kleaf.shape[0]), live)


def s3_stage_holds(name, stg, s3, scene, rows, tq_bits, card, live=None,
                   occl=False):
    """B, C and D (E with occl, on the refined lists) on one wave of
    `scene` at tq_bits, each timed (CUDA events over 5 launches) and held
    against its plain version on the same launch (B and C word for word,
    D to the parity bars, E on occluded-or-not of live lanes), with its
    bound.  Returns {stage key: JSON numbers}."""
    feats_t, scal, smeta, bscal, slot_pkt, aabb8, live_p = s3_stage_inputs(
        s3, scene, rows, live)
    out = {}
    ea = (scal, smeta, bscal, scene.knode_f, TMAX, stg.STEP_CAP, stg.PCAP)
    b_ms, (wk, ek) = cuda_ms(lambda: stg.emit_cuda(*ea, tq_bits=tq_bits), 5)
    b_plain, b_st = emit_hold(stg, ea + (stg.STEP_ROWS,), (wk, ek), tq_bits)
    b_bound, nodes, words, max_nodes = emit_bounds(
        stg, [(ea + (stg.STEP_ROWS,), ek)])[0]
    out["emit"] = dict(ms=b_ms, plain_ms=b_plain, bound=b_bound,
                       max_abs_err=0.0, longest_walk=b_st["max_steps"],
                       longest_walk_nodes=max_nodes)
    ra = (slot_pkt, feats_t, aabb8, TMAX, stg.PCAP)
    c_ms, (rk, rek) = cuda_ms(lambda: stg.refine_cuda(
        wk, ek, *ra, tq_bits=tq_bits), 5)
    c_plain = refine_hold(stg, (wk, ek) + ra, (rk, rek), tq_bits)
    c_bound, _, kept = refine_bound(stg, wk, ek, rek, stg.PCAP, tq_bits)
    out["refine"] = dict(ms=c_ms, plain_ms=c_plain, bound=c_bound,
                         max_abs_err=0.0)
    feats = stg.transpose_cuda(feats_t)
    pa = (rk, rek, slot_pkt, feats, scene.kleaf, TMIN, TMAX, stg.PCAP,
          scene.stable_frames)
    if occl:
        r = occl_launch(stg, pa, tq_bits=tq_bits)
        alive = smeta[:, 1] > 0
        lane_live = live_p.view(-1, stg.PKT)[smeta[:, 0].long()] \
            & alive[:, None] & r["live"]
        res = hold_occluded(f"{name} E vs plain", r["occ_k"], r["occ_p"],
                            lane_live)
        out["isect_occl"] = dict(ms=r["ms"], plain_ms=r["plain_ms"],
                                 bound=r["bound"],
                                 max_abs_err=1.0 - res["live_agree"])
    else:
        r = isect_launch(stg, pa, tq_bits=tq_bits)
        res = hold_launches(f"{name} D vs plain", [r])
        out["isect"] = dict(ms=r["ms"], plain_ms=r["plain_ms"],
                            bound=r["bound"], max_abs_err=res["max_abs_err"])
    log(f"   {name} stages at tq {tq_bits} ({card}): {words} words, "
        f"{int(ek[:, 2].sum())} step windows ({nodes} nodes; longest walk "
        f"{b_st['max_steps']} windows, {max_nodes} nodes), {kept} kept; "
        + "; ".join(
            f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.1f}, bound "
            f"{v['bound'][0]:.4f} {v['bound'][1]})" for k, v in out.items()))
    return out


def frame_ms(tracer, scene, res, n, batch, depth):
    """A warm 1080p engine frame: (host ms ending in a synchronize of the
    second of two renders, its accum, image)."""
    for _ in range(2):
        t0 = time.time()
        accum, image = tracer.render(scene, res,
                                     torch.zeros(n, 3, device=scene.device),
                                     0, W, H, batch=batch, depth=depth)
        torch.cuda.synchronize()
    return (time.time() - t0) * 1e3, accum, image


def leaf64(dev, card, tracer, city_tlas, scene, res, verts, tris, waves,
           hit1, pk, s3, stg):
    """Phase 14: the JAX package's LEAF64 configuration on the city:
    (a) the tables at leaf_cap 64 (leaves, MiB, build seconds); (b) the
    driven path with the launch counts set to 0 just before and read just
    after: bench's three 1080p waves through the packet kernel (T = 64),
    the tile-ordered primary and its shadow wave through
    trace_rows_stream3(tq_bits=7) and an engine frame at 1920x1080 b1 d2
    with tq_bits 7; (c) each wave's packet kernel held to its plain
    version and timed beside the cap-128 tables' kernel; the cap-64 hits
    held to the cap-128 scene's on the same rays; (d) B, C, D on the
    primary and E on the shadow wave at tq 7 held to their plain
    versions, D's ms at cap 64 against cap 128 on the same primary in
    turns; (e) the engine frame's ms beside the cap-128 frame's."""
    n = W * H
    out = {}
    t0 = time.time()
    s64 = city_tlas.device_scene(dev, leaf_cap=LEAF_CAP)
    torch.cuda.synchronize()
    out["build_s"] = time.time() - t0
    nl = s64.kleaf.shape[0]
    out.update(leaves=nl, leaves_128=int(scene.kleaf.shape[0]),
               kleaf_mib=s64.kleaf.numel() * 4 / 2 ** 20,
               knode_rows=int(s64.knode_f.shape[0]))
    log(f"[14] city at leaf_cap {LEAF_CAP}: {nl} leaves (cap 128: "
        f"{out['leaves_128']}), kleaf {tuple(s64.kleaf.shape)} "
        f"({out['kleaf_mib']:.1f} MiB), knode_f {out['knode_rows']} rows, "
        f"tables built in {out['build_s']:.1f} s")
    if s3.supports(s64) or not s3.supports(s64, TQ7):
        raise AssertionError(f"{nl} leaves: stream3 must refuse 9-bit words "
                             f"and take 7-bit ones")
    ref128 = {w: pk.trace_rays_packet(scene, o, d, TMIN, TMAX,
                                      any_hit=w == "shadow")
              for w, (o, d) in waves.items()}
    tracer64 = dataclasses.replace(tracer, tq_bits=TQ7)
    o1, d1 = waves["primary"]
    so, sd = waves["shadow"]

    def path():
        recs = {w: pk.trace_rays_packet(s64, o, d, TMIN, TMAX,
                                        any_hit=w == "shadow")
                for w, (o, d) in waves.items()}
        s3p = s3.trace_rows_stream3(s64, s3.rows_from_aos_fast(o1, d1), TMIN,
                                    TMAX, with_diag=True, tq_bits=TQ7)
        s3s = s3.trace_rows_stream3(s64, s3.rows_from_aos_fast(so, sd), TMIN,
                                    TMAX, live=hit1, occl=True,
                                    with_diag=True, tq_bits=TQ7)
        frame = tracer64.render(s64, res, torch.zeros(n, 3, device=dev), 0,
                                W, H, batch=1, depth=2)
        return recs, s3p, s3s, frame

    ((recs, (rec3, diag3), (rec_o, diag_o), (accum, image)),
     counts) = drive_path(
        pk, stg, "LEAF64 path", path,
        [f"packet_trace[{v}]" for v in PATH_VARIANTS] + list(PATH_S3))
    out["launches"] = counts
    check_frame("LEAF64 frame", accum, image, n)

    # (c) each wave's packet kernel at T = 64 against its plain version,
    # timed beside the cap-128 tables' kernel on the same rays
    out["waves"] = {}
    for wave, live in (("primary", None), ("bounce", None),
                       ("shadow", None), ("shadow", hit1)):
        o, d = waves[wave]
        if live is not None:        # dead lanes parked as the wrapper does
            o = torch.where(live[:, None], o, 1e30)
            d = torch.where(live[:, None], d, 1.0)
        ah = wave == "shadow"
        var = pk.variant(ah, live is not None, True)

        def run(sc):
            return lambda: pk.packet_trace_cuda(
                o, d, live, sc.knode_f, sc.kleaf, TMIN, TMAX, any_hit=ah,
                stable=True)
        ms128, _ = cuda_ms(run(scene), 5)
        ms64, (t_k, tri_k) = cuda_ms(run(s64), 5)
        ms64b, _ = cuda_ms(run(s64), 5)
        ms128b, _ = cuda_ms(run(scene), 5)
        st = {}
        p_ms, (t_p, tri_p) = cuda_ms(lambda: pk._packet_trace_reference(
            o, d, live, s64.knode_f, s64.kleaf, TMIN, TMAX, any_hit=ah,
            stable=True, stats=st), 1, warmup=False)
        b = bound(st["ray_leaf_tris"] * FLOPS_PER_PAIR,
                  n * 32 + st["node_rows"] * 64
                  + st["leaves"] * s64.kleaf[0].numel() * 4)
        r = judge(f"leaf64 {wave}_1080p/{var}", t_k, tri_k, t_p, tri_p, o,
                  d, live, s64.kprim, any_hit=ah,
                  t_scale="origin" if wave == "bounce" else "t",
                  mesh=(verts, tris))
        out["waves"][f"{wave}/{var}"] = dict(variant=var, ms=(ms64 + ms64b) / 2,
                                  ms_128=(ms128 + ms128b) / 2, plain_ms=p_ms,
                                  bound_ms=b[0], bound_by=b[1],
                                  max_abs_err=r["max_abs_err"], walk=st)
        log(f"   LEAF64 {wave}/{var} 1080p packet kernel ({card}): cap 64 "
            f"{ms64:.3f}, {ms64b:.3f} ms; cap 128 {ms128:.3f}, {ms128b:.3f} "
            f"ms (in turns); plain {p_ms:.1f} ms; bound {b[0]:.4f} ms "
            f"({b[1]}); walk {json.dumps(st)}")

    # the cap-64 hits against the cap-128 scene's on the same rays: the
    # same geometry (prim ids are the mesh's), but other leaves, so other
    # leaf frames (centroids): each table's t carries its own |o| * eps
    # (PERF.md section 2), so t is held on |dt| / (|o| + t), with the
    # float64 witness
    prim_id = torch.arange(len(tris), device=dev, dtype=torch.int32)
    for wave in ("primary", "bounce"):
        o, d = waves[wave]
        judge(f"cap 64 vs cap 128 {wave}", recs[wave].t, recs[wave].prim,
              ref128[wave].t, ref128[wave].prim, o, d, None, prim_id,
              any_hit=False, t_scale="origin", mesh=(verts, tris))
    hold_occluded("cap 64 vs cap 128 shadow", recs["shadow"].hit,
                  ref128["shadow"].hit,
                  torch.ones(n, dtype=torch.bool, device=dev))
    hold_prims("LEAF64 stream3 primary (tq 7) vs the packet kernel",
               rec3.t, rec3.prim, recs["primary"].t, recs["primary"].prim)
    a_s = pk.trace_rays_packet(s64, so, sd, TMIN, TMAX, any_hit=True,
                               live=hit1)
    hold_occluded("LEAF64 stream3 shadow (tq 7) vs packet any-hit",
                  rec_o.hit, a_s.hit, hit1)
    out["stream3_diag"] = {k: int(v) for k, v in diag3.items()
                           if k in ("words", "kept_words", "steps", "capped",
                                    "flagged", "residual_rays")}
    out["stream3_shadow_diag"] = {
        k: int(v) for k, v in diag_o.items()
        if k in ("words", "kept_words", "steps", "capped", "flagged",
                 "residual_rays")}
    w64, _ = cuda_ms(lambda: s3.trace_rows_stream3(
        s64, s3.rows_from_aos_fast(o1, d1), TMIN, TMAX, tq_bits=TQ7), 5)
    w128, _ = cuda_ms(lambda: s3.trace_rows_stream3(
        scene, s3.rows_from_aos_fast(o1, d1), TMIN, TMAX), 5)
    out["stream3_wave_ms"], out["stream3_wave_ms_128"] = w64, w128
    srows = s3.rows_from_aos_fast(so, sd)
    out["step_windows"] = {
        "[14] LEAF64 primary": step_rows_wave(
            "[14] LEAF64 primary (tq 7)", stg, s3,
            lambda: s3.trace_rows_stream3(s64, s3.rows_from_aos_fast(o1, d1),
                                          TMIN, TMAX, with_diag=True,
                                          tq_bits=TQ7), card),
        "[14] LEAF64 shadow": step_rows_wave(
            "[14] LEAF64 shadow (tq 7)", stg, s3,
            lambda: s3.trace_rows_stream3(s64, srows, TMIN, TMAX, live=hit1,
                                          occl=True, with_diag=True,
                                          tq_bits=TQ7), card)}
    log(f"   LEAF64 stream3 primary 1080p ({card}): {w64:.3f} ms a wave "
        f"(cap 128, tq 9: {w128:.3f}); diag {json.dumps(out['stream3_diag'])}"
        f"; shadow diag {json.dumps(out['stream3_shadow_diag'])}")

    # (d) B, C, D on the primary and E on the shadow wave at tq 7; D at cap
    # 64 against cap 128 on the same primary, in turns
    out["stages"] = s3_stage_holds("LEAF64 primary", stg, s3, s64,
                                   s3.rows_from_aos_fast(o1, d1), TQ7, card)
    out["shadow_stages"] = s3_stage_holds(
        "LEAF64 shadow", stg, s3, s64,
        s3.park_dead(s3.rows_from_aos_fast(so, sd), hit1), TQ7, card,
        live=hit1, occl=True)
    d_ms = {}
    for sc, bits in ((scene, 9), (s64, TQ7)):
        feats_t, scal, smeta, bscal, slot_pkt, aabb8, _ = s3_stage_inputs(
            s3, sc, s3.rows_from_aos_fast(o1, d1))
        wk, ek = stg.emit_cuda(scal, smeta, bscal, sc.knode_f, TMAX,
                               stg.STEP_CAP, stg.PCAP, tq_bits=bits)
        rk, rek = stg.refine_cuda(wk, ek, slot_pkt, feats_t, aabb8, TMAX,
                                  stg.PCAP, tq_bits=bits)
        d_ms[sc.leaf_cap] = (rk, rek, slot_pkt, stg.transpose_cuda(feats_t),
                             sc.kleaf, TMIN, TMAX, stg.PCAP,
                             sc.stable_frames), bits, int(rek[:, 0].sum())
    turns = []
    for cap in (128, 64, 64, 128):
        args, bits, _ = d_ms[cap]
        turns.append((cap, cuda_ms(lambda: stg.isect_cuda(
            *args, tq_bits=bits), 5)[0]))
    out["d_ms_64"] = sum(m for c, m in turns if c == 64) / 2
    out["d_ms_128"] = sum(m for c, m in turns if c == 128) / 2
    log(f"   D per launch on the 1080p primary ({card}), in turns "
        f"{json.dumps(turns)}: cap 64 {out['d_ms_64']:.3f} ms over "
        f"{d_ms[64][2]} kept words, cap 128 {out['d_ms_128']:.3f} ms over "
        f"{d_ms[128][2]} (the JAX package's offline price of cap 64: -26% "
        f"tile work, +20% emit iterations)")
    del d_ms, turns

    # (e) engine frames: cap 64 / tq 7 against cap 128 / tq 9, warm
    ms128, _, img128 = frame_ms(tracer, scene, res, n, 1, 2)
    ms64, _, img64 = frame_ms(tracer64, s64, res, n, 1, 2)
    ms64b, _, _ = frame_ms(tracer64, s64, res, n, 1, 2)
    ms128b, _, _ = frame_ms(tracer, scene, res, n, 1, 2)
    rmse = float((img64[..., :3].float() - img128[..., :3].float())
                 .pow(2).mean().sqrt())
    out["frame_ms"] = (ms64 + ms64b) / 2
    out["frame_ms_128"] = (ms128 + ms128b) / 2
    out["frame_rmse_vs_128"] = rmse
    log(f"[14] LEAF64 engine frame 1920x1080 b1 d2 ({card}): cap 64 / tq 7 "
        f"{ms64:.1f}, {ms64b:.1f} ms; cap 128 / tq 9 {ms128:.1f}, "
        f"{ms128b:.1f} ms (warm, in turns); u8 RMSE between the images "
        f"{rmse:.4f}")
    if rmse >= 3.0:
        raise AssertionError(f"LEAF64 frame differs from cap 128: {rmse}")
    return out


def wide_leaves(dev, card, city_tlas, scene, waves, hit1, sl, pk, s3, stg):
    """Phase 15: the city at leaf_cap 256 (tq 9), 64k-ray probes of the
    primary and shadow waves: the driven probe (counts set to 0 just
    before, read just after) through the packet kernel (closest, any-hit)
    and stream3 (D, and E on the shadow probe), then the packet kernel,
    D and E -- the 256-lane tile in dynamic shared memory -- held to
    their plain versions and timed beside the cap-128 tables'."""
    out = {}
    t0 = time.time()
    s256 = city_tlas.device_scene(dev, leaf_cap=WIDE_CAP)
    torch.cuda.synchronize()
    out.update(build_s=time.time() - t0, leaves=int(s256.kleaf.shape[0]),
               kleaf_mib=s256.kleaf.numel() * 4 / 2 ** 20)
    log(f"[15] city at leaf_cap {WIDE_CAP}: {out['leaves']} leaves, kleaf "
        f"{tuple(s256.kleaf.shape)} ({out['kleaf_mib']:.1f} MiB), built in "
        f"{out['build_s']:.1f} s")
    po, pd = (x[sl].contiguous() for x in waves["primary"])
    so, sd = (x[sl].contiguous() for x in waves["shadow"])
    live = hit1[sl].contiguous()

    def path():
        pk.trace_rays_packet(s256, po, pd, TMIN, TMAX)
        pk.trace_rays_packet(s256, so, sd, TMIN, TMAX, any_hit=True)
        s3.trace_rows_stream3(s256, s3.rows_from_aos_fast(po, pd), TMIN,
                              TMAX)
        s3.trace_rows_stream3(s256, s3.rows_from_aos_fast(so, sd), TMIN,
                              TMAX, live=live, occl=True)

    _, out["launches"] = drive_path(
        pk, stg, "wide-leaf probe", path,
        ["packet_trace[closest]", "packet_trace[any_hit]"] + list(PATH_S3))
    out["packet"] = {}
    for wave, (o, d), ah in (("primary", (po, pd), False),
                             ("shadow", (so, sd), True)):
        r = compare(f"wide{WIDE_CAP} {wave}", pk, o, d, None, s256.knode_f,
                    s256.kleaf, s256.kprim, any_hit=ah, stable=True)

        def run(sc):
            return lambda: pk.packet_trace_cuda(
                o, d, None, sc.knode_f, sc.kleaf, TMIN, TMAX, any_hit=ah,
                stable=True)
        ms = cuda_ms(run(s256), 10)[0]
        ms128 = cuda_ms(run(scene), 10)[0]
        out["packet"][wave] = dict(ms=ms, ms_128=ms128,
                                   max_abs_err=r["max_abs_err"])
        log(f"   packet kernel on the {wave} probe ({card}): cap "
            f"{WIDE_CAP} {ms:.4f} ms, cap 128 {ms128:.4f} ms")
    out["stages"] = s3_stage_holds(f"wide{WIDE_CAP} primary probe", stg, s3,
                                   s256, s3.rows_from_aos_fast(po, pd), 9,
                                   card)
    out["shadow_stages"] = s3_stage_holds(
        f"wide{WIDE_CAP} shadow probe", stg, s3, s256,
        s3.park_dead(s3.rows_from_aos_fast(so, sd), live), 9, card,
        live=live, occl=True)
    return out


def many_blas64(dev, card, pk, s3m, stg):
    """Phase 16: bench.py --multi's 64-instance scene built at leaf_cap
    64: the concatenated tables' leaves (past the 9-bit reach), then one
    native 1080p primary (trace_rows_tlas at tq 7), driven (counts set to
    0 just before, read just after), held to the instance scan at tq 7
    and timed beside it."""
    out = {}
    n = W * H
    _, _, mtlas = multi64_scene(dev, W, H)
    t0 = time.time()
    m64 = mtlas.device_scene(dev, leaf_cap=LEAF_CAP)
    mt = s3m.multi_tables(m64)
    torch.cuda.synchronize()
    out.update(build_s=time.time() - t0,
               leaves=int(mt.kleaf_cat.shape[0]),
               native_9=s3m.supports_native(mt),
               native_7=s3m.supports_native(mt, TQ7))
    log(f"[16] multi64 at leaf_cap {LEAF_CAP}: kleaf_cat "
        f"{tuple(mt.kleaf_cat.shape)} ({out['leaves']} leaves), tables in "
        f"{out['build_s']:.1f} s; native route at tq 9 "
        f"{out['native_9']}, at tq 7 {out['native_7']}")
    if not out["native_7"]:
        raise AssertionError("the native route refuses multi64 at tq 7")
    o1, d1 = camera_rays(dev, W, H)
    rows = s3m.s3.rows_from_aos_fast(o1, d1)
    (rec, diag), out["launches"] = drive_path(
        pk, stg, "multi64 LEAF64 native primary",
        lambda: s3m.trace_rows_tlas(m64, mt, rows, TMIN, TMAX, tq_bits=TQ7,
                                    with_diag=True),
        ["emit", "refine", "isect", "oscal", "transpose"])
    scan = s3m.trace_rows_multi(m64, mt, rows, TMIN, TMAX, tq_bits=TQ7)
    res = hold_prims("multi64 LEAF64 native vs scan", rec.t, rec.prim,
                     scan.t, scan.prim)
    both = rec.hit & scan.hit
    out["slot_agree"] = float((rec.slot == scan.slot)[both].float().mean())
    if out["slot_agree"] < BARS["prim"]:
        raise AssertionError(f"multi64 LEAF64 slots: {out['slot_agree']}")
    out["native_ms"] = cuda_ms(lambda: s3m.trace_rows_tlas(
        m64, mt, rows, TMIN, TMAX, tq_bits=TQ7), 3)[0]
    out["scan_ms"] = cuda_ms(lambda: s3m.trace_rows_multi(
        m64, mt, rows, TMIN, TMAX, tq_bits=TQ7), 1)[0]
    out["diag"] = diag
    out["max_abs_err"] = res["max_abs_err"]
    log(f"[16] multi64 LEAF64 native 1080p primary ({card}): "
        f"{out['native_ms']:.3f} ms ({n / out['native_ms'] / 1e3:.2f} "
        f"Mrays/s) vs the scan {out['scan_ms']:.3f} ms; slot agreement "
        f"{out['slot_agree']:.7f}; diag {json.dumps(diag)}")
    return out


def _http(url, payload=None, method="GET"):
    """One client call with its own timeout: (status, headers, body)."""
    import urllib.request
    data = None if method == "GET" else (
        json.dumps(payload).encode() if payload is not None else b"")
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, dict(r.headers), r.read()


def viewers(dev, card, pk, stg):
    """Phase 17: sample1's render() callback on the card in both viewer
    loops at 512x512 (batch VIEW_B, depth VIEW_D), each driven (counts
    set to 0 just before, read just after).  The web loop
    (tools/web_viewer.render_loop_web) through a urllib client: GET
    /frame.png (its bytes equal to utils/image.encode_png of the frame
    the loop rendered: no PIL) and /state, POST a camera edit to /control,
    /save, /quit.  The terminal loop (tools/viewer.render_loop) with a
    --controls-file edit written after its second frame.  In both
    totalSamples restarts at the edit, and the first frame after it
    equals a fresh render_sample1 at the edited camera (no further from
    it than two fresh renders are from each other)."""
    import threading
    import urllib.error
    from radiance_tpu_torch.samples import sample1
    from radiance_tpu_torch.tools import viewer
    from radiance_tpu_torch.utils import image as image_io

    out = {}
    cam = sample1.sample1_camera(CW, CW)
    cam.x = 0.3
    tmp = tempfile.mkdtemp(prefix="viewers_")
    fresh = [sample1.render_sample1(CW, CW, VIEW_B, VIEW_D, 1, camera=cam,
                                    out=os.path.join(tmp, f"fresh{i}.png"))
             for i in range(2)]
    d_fresh = int(np.abs(fresh[0].astype(int) - fresh[1]).max())

    def recorder(s1, frames, edits):
        plain_render, plain_apply = s1.render_frame, s1.apply_controls

        def render(data):
            t0 = time.time()
            img = plain_render(data)
            frames.append((s1.total_samples(), img.copy(),
                           (time.time() - t0) * 1e3))
            return img

        def apply(updates):
            edits.append(len(frames))
            plain_apply(updates)

        s1.render_frame, s1.apply_controls = render, apply

    def hold_edit(name, frames, edits):
        k = edits[-1]
        if not (k > 0 and frames[k][0] == VIEW_B
                and frames[k - 1][0] == k * VIEW_B):
            raise AssertionError(f"{name}: totalSamples did not restart at "
                                 f"the edit: {[f[0] for f in frames]}")
        d_edit = int(np.abs(frames[k][1].astype(int) - fresh[0]).max())
        log(f"   {name}: edit before frame {k}, totalSamples "
            f"{[f[0] for f in frames]}; frame after the edit vs a fresh "
            f"render max |du8| {d_edit} (fresh vs fresh {d_fresh}); frame "
            f"ms {', '.join(f'{f[2]:.1f}' for f in frames)}")
        if d_edit > d_fresh:
            raise AssertionError(f"{name}: the frame after the edit differs "
                                 f"from a fresh render ({d_edit} > "
                                 f"{d_fresh})")
        return dict(frames=len(frames), edit_before=k, d_edit=d_edit,
                    d_fresh=d_fresh,
                    frame_ms=[f[2] for f in frames])

    # the web loop
    s1 = sample1.Sample1(CW, CW, VIEW_B, VIEW_D)
    frames, edits, box = [], [], {}
    recorder(s1, frames, edits)
    ready = threading.Event()

    def on_start(addr):
        box["addr"] = addr
        ready.set()

    def web():
        box["last"] = sample1.run_viewer(
            s1, web=True, frames=0, out=os.path.join(tmp, "web.png"),
            web_port=0, on_start=on_start)

    def web_path():
        t = threading.Thread(target=web, daemon=True)
        t.start()
        if not ready.wait(60):
            raise AssertionError("the web viewer did not start")
        base = "http://%s:%d" % box["addr"]
        _, _, page = _http(base + "/")
        for _ in range(1500):
            try:
                st, hdrs, png = _http(base + "/frame.png")
                if st == 200 and png:
                    break
            except urllib.error.HTTPError:      # 503 before the first frame
                pass
            time.sleep(0.02)
        fid = int(hdrs["X-Frame-Id"])
        if png != image_io.encode_png(frames[fid - 1][1]):
            raise AssertionError("/frame.png is not encode_png of the frame")
        state = json.loads(_http(base + "/state")[2])
        _http(base + "/control", {"camera.x": 0.3}, "POST")
        for _ in range(3000):
            if edits and len(frames) > edits[0]:
                break
            time.sleep(0.02)
        n0 = len(os.listdir(tmp))
        _http(base + "/save", None, "POST")
        for _ in range(3000):
            if len(os.listdir(tmp)) > n0:
                break
            time.sleep(0.02)
        saved = len(os.listdir(tmp)) > n0
        _http(base + "/quit", None, "POST")
        t.join(120)
        if t.is_alive() or not saved or b"inspector" not in page:
            raise AssertionError(f"web viewer: alive {t.is_alive()}, saved "
                                 f"{saved}")
        return state

    state, out["web_launches"] = drive_path(
        pk, stg, "sample1 --web", web_path,
        ["packet_trace[closest]", "packet_trace[any_hit]"])
    out["web"] = hold_edit("web viewer", frames, edits)
    out["web"]["state_controls"] = state["controls"]

    # the terminal loop with a watched controls file
    s1 = sample1.Sample1(CW, CW, VIEW_B, VIEW_D)
    frames, edits = [], []
    recorder(s1, frames, edits)
    ctl = os.path.join(tmp, "controls.json")
    rec_render = s1.render_frame

    def render(data):
        img = rec_render(data)
        if len(frames) == 2:
            with open(ctl, "w") as f:
                json.dump({"camera.x": 0.3}, f)
        return img

    s1.render_frame = render
    _, out["file_launches"] = drive_path(
        pk, stg, "sample1 --interactive --controls-file",
        lambda: sample1.run_viewer(s1, web=False, frames=4,
                                   out=os.path.join(tmp, "file.png"),
                                   controls_file=ctl, use_stdin=False),
        ["packet_trace[closest]", "packet_trace[any_hit]"])
    out["file"] = hold_edit("controls-file viewer", frames, edits)
    log(f"[17] viewers ({card}): web {json.dumps(out['web'])}; file "
        f"{json.dumps(out['file'])}")

    # the command lines themselves, on the card, in their own processes
    # (stdin closed; the web loop on a free port ends after its frames)
    out["cli"] = {}
    for flag in ("--interactive", "--web"):
        png = os.path.join(tmp, f"cli{flag}.png")
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "radiance_tpu_torch.samples.sample1",
             flag, "--width", "64", "--height", "64", "--batch", "1",
             "--depth", "1", "--frames", "2", "--web-port", "0", "--out",
             png], cwd=tmp, stdin=subprocess.DEVNULL, capture_output=True,
            text=True, timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
        out["cli"][flag] = dict(rc=r.returncode, s=time.time() - t0)
        log(f"   sample1 {flag} --frames 2 (its own process, {card}): rc "
            f"{r.returncode} in {out['cli'][flag]['s']:.1f} s; "
            f"{r.stdout.strip().splitlines()[-1:]}")
        if r.returncode != 0 or not os.path.exists(png):
            raise AssertionError(f"sample1 {flag} failed: {r.stderr[-2000:]}")
    return out

# ---- phase 18: the SAH-driven leaf collapse -------------------------------

COLLAPSE_RHO = 0.15           # the JAX package's RADIANCE_COLLAPSE_RHO
COLLAPSE_BUILDS = ((128, "greedy"), (128, "sah"), (64, "greedy"),
                   (64, "sah"))


def tq_for(supports, tables):
    """The widest tq width (9 down to 5) whose words reach the tables'
    leaves, by the route's supports(); fails where none does."""
    bits = next((b for b in range(9, 4, -1) if supports(tables, b)), None)
    if bits is None:
        raise AssertionError("no tq width reaches the tables' leaves")
    return bits


def collapse_builds(dev, city_tlas, s3):
    """The city's tables built anew four ways (COLLAPSE_BUILDS) from the
    TLAS's own BLAS rows: ({"<collapse><cap>": (scene, tq width)}, each
    build's leaves, kleaf MiB, node rows, seconds and tq width)."""
    from radiance_tpu_torch.bvh import device as bvh_device

    blas_by = {off: (b.nodes, b.faces, b.vertices)
               for off, b in city_tlas.blas_offsets}
    scenes, info = {}, {}
    for cap, collapse in COLLAPSE_BUILDS:
        t0 = time.time()
        sc = bvh_device.build_device_scene(
            city_tlas.nodes, city_tlas.instances, blas_by,
            tlas_capacity=city_tlas.tlas_capacity, leaf_cap=cap,
            collapse=collapse, rho=COLLAPSE_RHO, device=dev)
        torch.cuda.synchronize()
        key = f"{collapse}{cap}"
        scenes[key] = (sc, tq_for(s3.supports, sc))
        info[key] = dict(leaves=int(sc.kleaf.shape[0]),
                         kleaf_mib=sc.kleaf.numel() * 4 / 2 ** 20,
                         knode_rows=int(sc.knode_f.shape[0]),
                         build_s=time.time() - t0, tq_bits=scenes[key][1])
    return scenes, info


def load_collapse_kernels(stg, scenes):
    """The stream3 libraries each build's (leaf cap, tq width) needs,
    built in parallel where phase [2] did not build them."""
    stg_libs = {lib for sc, bits in scenes.values()
                for lib in stg.variant_libs(sc.leaf_cap, bits)}
    from radiance_tpu_torch.ops import cuda_build
    cuda_build.load_all(sorted(stg_libs, key=lambda lib: lib.name))


def collapse_timings(card, scene, bits, waves, rows, hit1, pk, s3):
    """One build's numbers: bench's three 1080p waves through the packet
    kernel (CUDA events over 5), and the stream3 primary and shadow waves:
    each wave's ms (CUDA events over 3), its residual's ms (CUDA events
    around retrace_flagged), and B, C, D and E on each launch from
    torch.profiler's kernel records."""
    row = {}
    for wave, (o, d) in waves.items():
        row[f"packet_{wave}_ms"] = cuda_ms(
            lambda o=o, d=d, ah=wave == "shadow": pk.packet_trace_cuda(
                o, d, None, scene.knode_f, scene.kleaf, TMIN, TMAX,
                any_hit=ah, stable=True), 5)[0]
    runs = {"primary": lambda: s3.trace_rows_stream3(
                scene, rows["primary"], TMIN, TMAX, tq_bits=bits),
            "shadow": lambda: s3.trace_rows_stream3(
                scene, rows["shadow"], TMIN, TMAX, live=hit1, occl=True,
                tq_bits=bits)}
    for wave, run in runs.items():
        row[f"stream3_{wave}_ms"] = cuda_ms(run, 3)[0]
        _, sp, _ = call_spans(s3, ("retrace_flagged",), run)
        row[f"stream3_{wave}_residual_ms"] = sum(sp["retrace_flagged"])

    def fn(calls):
        for wave, run in runs.items():
            calls.tag = wave
            run()
    # B-E only: CUPTI keeps losing one of F's two records in this profile
    _, calls, ms = profiled(pk, s3, fn, keep_args=False, names=(
        "stage_emit", "stage_refine", "stage_isect"))
    for key, name in (("emit", "B"), ("refine", "C"), ("isect", "D"),
                      ("isect_occl", "E")):
        for (tag, *_), m in zip(calls[key], ms[key]):
            row[f"{name}_{tag}_ms"] = row.get(f"{name}_{tag}_ms", 0.0) + m
    return row


def collapse_and_windows(dev, card, tracer, city_tlas, res, verts, tris,
                         waves, hit1, sl, pk, s3, s3m, stg):
    """Phase 18: the SAH-driven leaf collapse on the H100.  (a) the city's
    tables four ways, caps 128 and 64, each greedy and SAH at rho 0.15:
    leaves, kleaf MiB, build seconds; (b) the driven path, with the
    launch counts set to 0 just before and read just after: on the two
    SAH builds, bench's three 1080p waves through the packet kernel and
    the stream3 primary and shadow waves, multi64 built with the SAH cut
    through the native route for one 1080p primary, and a 1080p b1 d2
    engine frame on the city's SAH cap-128 build; (c) each SAH build's
    hits against the greedy build's of the same cap on the same rays
    (the parity bars, t on |dt| / (|o| + t), shadows as occluded or not),
    multi64's native hits and slots against the greedy scene's, and the
    SAH frame's u8 RMSE against the greedy frame's (< 2.0); (d) on every
    build, the waves timed (the packet kernel's, and stream3's with B, C,
    D and E a launch from torch.profiler, its flagged packets and
    residual); (e) on the SAH builds, the packet kernel held to its plain
    version on 64k-ray probes of the three waves, and B, C, D on the
    primary and E on the shadow wave held to their plain versions (B and
    C word for word, D and E to the bars; the greedy builds' launches
    are phases [5], [6] and [14]'s)."""
    n = W * H
    out = {}
    t0 = time.time()
    scenes, out["builds"] = collapse_builds(dev, city_tlas, s3)
    load_collapse_kernels(stg, scenes)
    for key, b in out["builds"].items():
        log(f"[18] city, {key}: {b['leaves']} leaves, kleaf "
            f"{b['kleaf_mib']:.1f} MiB, knode_f {b['knode_rows']} rows, "
            f"built in {b['build_s']:.1f} s; stream3 at tq {b['tq_bits']}")
    o1, d1 = waves["primary"]
    so, sd = waves["shadow"]
    rows = {"primary": s3.rows_from_aos_fast(o1, d1),
            "shadow": s3.rows_from_aos_fast(so, sd)}
    _, _, mtlas = multi64_scene(dev, W, H)
    multi = {c: mtlas.device_scene(dev, collapse=c, rho=COLLAPSE_RHO)
             for c in ("greedy", "sah")}
    mtabs = {c: s3m.multi_tables(m) for c, m in multi.items()}
    mbits = {c: tq_for(s3m.supports_native, mt) for c, mt in mtabs.items()}
    tracers = {k: dataclasses.replace(tracer, tq_bits=bits)
               for k, (_, bits) in scenes.items()}

    def traced(key):
        sc, bits = scenes[key]
        r = {w: pk.trace_rays_packet(sc, o, d, TMIN, TMAX,
                                     any_hit=w == "shadow")
             for w, (o, d) in waves.items()}
        r["stream3"] = s3.trace_rows_stream3(
            sc, rows["primary"], TMIN, TMAX, with_diag=True, tq_bits=bits)
        r["stream3_shadow"] = s3.trace_rows_stream3(
            sc, rows["shadow"], TMIN, TMAX, live=hit1, occl=True,
            with_diag=True, tq_bits=bits)
        return r

    def native(c):
        return s3m.trace_rows_tlas(multi[c], mtabs[c], rows["primary"], TMIN,
                                   TMAX, with_diag=True, tq_bits=mbits[c])

    def path():
        return ({k: traced(k) for k in ("sah128", "sah64")}, native("sah"),
                tracers["sah128"].render(
                    scenes["sah128"][0], res, torch.zeros(n, 3, device=dev),
                    0, W, H, batch=1, depth=2))

    (recs, nat, (accum, image)), out["launches"] = drive_path(
        pk, stg, "SAH collapse path", path,
        [f"packet_trace[{v}]" for v in PATH_VARIANTS] + list(PATH_S3))
    check_frame("SAH city frame", accum, image, n)
    recs.update({k: traced(k) for k in ("greedy128", "greedy64")})

    # (c) the SAH hits against the greedy build's: the same geometry and
    # prim ids, other leaves (so other leaf frames: t on |dt| / (|o| + t))
    prim_id = torch.arange(len(tris), device=dev, dtype=torch.int32)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    out["vs_greedy"] = {}
    for cap in (128, 64):
        g, s = recs[f"greedy{cap}"], recs[f"sah{cap}"]
        name = f"SAH vs greedy at cap {cap}"
        r = {w: judge(f"{name}, {w}", s[w].t, s[w].prim, g[w].t, g[w].prim,
                      *waves[w], None, prim_id, any_hit=False,
                      t_scale="origin", mesh=(verts, tris))
             for w in ("primary", "bounce")}
        r["shadow"] = hold_occluded(f"{name}, shadow", s["shadow"].hit,
                                    g["shadow"].hit, ones)
        r["stream3"] = judge(f"{name}, stream3 primary", s["stream3"][0].t,
                             s["stream3"][0].prim, g["stream3"][0].t,
                             g["stream3"][0].prim, o1, d1, None, None,
                             any_hit=False, t_scale="origin")
        r["stream3_shadow"] = hold_occluded(
            f"{name}, stream3 shadow", s["stream3_shadow"][0].hit,
            g["stream3_shadow"][0].hit, hit1)
        out["vs_greedy"][str(cap)] = r
    (rec_s, dg_s), (rec_g, dg_g) = nat, native("greedy")
    hold_prims("multi64 native, SAH vs greedy", rec_s.t, rec_s.prim,
               rec_g.t, rec_g.prim)
    both = rec_s.hit & rec_g.hit
    slot_agree = float((rec_s.slot == rec_g.slot)[both].float().mean())
    if slot_agree < BARS["prim"]:
        raise AssertionError(f"multi64 SAH slots: {slot_agree}")
    out["multi64"] = dict(
        leaves={c: int(mt.kleaf_cat.shape[0]) for c, mt in mtabs.items()},
        tq_bits=mbits, slot_agree=slot_agree, diag_sah=dg_s,
        diag_greedy=dg_g,
        **{f"native_ms_{c}": cuda_ms(lambda c=c: native(c), 3)[0]
           for c in ("greedy", "sah")})
    log(f"[18] multi64 native 1080p primary, SAH vs greedy ({card}): "
        f"{json.dumps(out['multi64'])}")
    ms_g, _, img_g = frame_ms(tracers["greedy128"], scenes["greedy128"][0],
                              res, n, 1, 2)
    ms_s, _, img_s = frame_ms(tracers["sah128"], scenes["sah128"][0], res,
                              n, 1, 2)
    rmse = float((img_s[..., :3].float() - img_g[..., :3].float())
                 .pow(2).mean().sqrt())
    out.update(frame_ms_sah128=ms_s, frame_ms_greedy128=ms_g,
               frame_rmse=rmse)
    log(f"[18] city engine frame 1920x1080 b1 d2 at cap 128 ({card}): SAH "
        f"{ms_s:.1f} ms, greedy {ms_g:.1f} ms (warm); u8 RMSE between the "
        f"images {rmse:.4f}")
    if rmse >= 2.0:
        raise AssertionError(f"SAH city frame: RMSE {rmse} against greedy")
    del recs, accum, image, img_g, img_s
    log(f"[18] (a)-(c) done in {time.time() - t0:.1f} s")
    t0 = time.time()

    # (d) every build's waves timed, B-E a launch from the profiler
    out["waves"] = {}
    for key, (sc, bits) in scenes.items():
        row = collapse_timings(card, sc, bits, waves, rows, hit1, pk, s3)
        out["waves"][key] = row
        log(f"[18] {key} ({card}): {json.dumps(row)}")
    # the wave diags of the recorded path: flagged packets, residual rays
    for key in scenes:
        sc, bits = scenes[key]
        for wave, kw in (("primary", {}),
                         ("shadow", dict(live=hit1, occl=True))):
            _, dg = s3.trace_rows_stream3(sc, rows[wave], TMIN, TMAX,
                                          with_diag=True, tq_bits=bits, **kw)
            out["waves"][key][f"stream3_{wave}_diag"] = {
                k: int(v) for k, v in dg.items()
                if k in ("words", "kept_words", "steps", "capped",
                         "flagged", "residual_rays")}

    log(f"[18] (d) done in {time.time() - t0:.1f} s")
    t0 = time.time()

    # (e) the SAH builds' kernels held to their plain versions
    out["holds"] = {}
    for cap in (128, 64):
        sc, bits = scenes[f"sah{cap}"]
        held = {}
        for wave, (o, d) in waves.items():
            ah = wave == "shadow"
            held[f"packet_{wave}"] = compare(
                f"SAH cap {cap} {wave} probe/{pk.variant(ah, False, True)}",
                pk, o[sl].contiguous(), d[sl].contiguous(), None,
                sc.knode_f, sc.kleaf, sc.kprim, any_hit=ah, stable=True)
        held["stages"] = s3_stage_holds(f"SAH cap {cap} primary", stg, s3,
                                        sc, rows["primary"], bits, card)
        held["shadow_stages"] = s3_stage_holds(
            f"SAH cap {cap} shadow", stg, s3, sc,
            s3.park_dead(rows["shadow"], hit1), bits, card, live=hit1,
            occl=True)
        out["holds"][str(cap)] = held
    log(f"[18] (e) done in {time.time() - t0:.1f} s")
    return out


def fused_material_wave(dev, card, tracer, scene, res):
    """Phase [19]: the fused material wave (shading/material_cuda.py,
    csrc/shade_material.cu) on the city's 1920x1080 primary wave and first
    bounce, from a fresh sample's state: rt_material_prep and
    rt_material_finish each timed alone (device_ms), bounded by the bytes
    each moves on these lanes (every input byte read once, every output
    byte written once), and the whole wave (closest-hit trace, shading,
    update) timed through the fused route and through the SBT path it
    replaces (its plain version; host clock ending in a synchronize), the
    traces alone beside them; the two routes' path states equal bit for
    bit, the launches counted.  Returns {"primary": ..., "bounce": ...,
    "launches": ...}."""
    import dataclasses as dc

    from radiance_tpu_torch.engine import context as ctx_mod
    from radiance_tpu_torch.engine import pathtracer as pt
    from radiance_tpu_torch.shading import material_cuda as mc

    n = W * H
    pixel = torch.arange(n, dtype=torch.int64, device=dev)
    plain = dc.replace(tracer)
    plain.fuses_material = lambda *a, **k: False
    if not tracer.fuses_material(scene, tracer.hit_offset,
                                 tracer.miss_index, 0):
        raise AssertionError("the city's waves do not take the fused route")
    primary, p_shadow, bounce, b_shadow = tracer._routes(scene, None)
    light = ctx_mod.get_light_direction(res)
    rgb = res["light_color"][0, :3]
    launches0 = mc.material_prep.launches, mc.material_finish.launches
    out = {}
    state = pt._sample_init(tracer, res, pixel, 0, 0)
    for b, wave in ((0, "primary"), (1, "bounce")):
        route, sroute = (primary, p_shadow) if b == 0 else (bounce, b_shadow)
        color, contribution, alive, o, d = state

        def step(t, st=state, b=b, route=route, sroute=sroute):
            return pt._sample_step(
                t, scene, res, pixel, 0, b, tuple(x.clone() for x in st),
                debug=0, hit_offset=t.hit_offset, miss_index=t.miss_index,
                route=route, shadow_route=sroute)

        def trace(o=o, d=d, alive=alive, route=route):
            return pt._traced_wavefront(
                scene, o, d, tracer.tmin, tracer.tmax, alive, route=route,
                multi_route=tracer.multi_route, tq_bits=tracer.tq_bits)

        hits = trace()
        act = alive & hits.hit
        hit_pos, rec = mc.material_prep(scene, res, hits, o, d, alive)

        def shadow(hit_pos=hit_pos, act=act, sroute=sroute):
            return pt._traced_wavefront(
                scene, hit_pos, light.expand(n, 3), 0.001, 1000.0, act,
                route=sroute, any_hit_terminate=True,
                multi_route=tracer.multi_route, tq_bits=tracer.tq_bits).hit

        occl = shadow()
        prep_ms, _ = device_ms(
            lambda: mc.material_prep(scene, res, hits, o, d, alive), 20)
        st = [x.clone() for x in state]
        finish_ms, _ = device_ms(lambda: mc.material_finish(
            hits.t, occl, rec, o, d, pixel, light, rgb, 0, b, st[0], st[1],
            st[2]), 20)
        s_lanes = int(act.sum())
        # prep: t and alive of every lane, the record, ray, indices and
        # normals of each shading lane; the shadow origin of every lane
        # and the 64-B shading record of each shading lane
        prep_bytes = n * (5 + 12) + s_lanes * (16 + 24 + 12 + 36 + 64)
        # finish: t, alive, colour and direction of every lane, the
        # occlusion bit, record, pixel and throughput of each shading
        # lane, the origin of every other; writes colour and the next ray
        # of every lane, the throughput of each shading lane, alive of
        # every other
        finish_bytes = (n * (4 + 1 + 12 + 12 + 12 + 24)
                        + s_lanes * (1 + 64 + 8 + 12 + 12)
                        + (n - s_lanes) * (12 + 1))
        ref = step(plain)
        got = step(tracer)
        torch.cuda.synchronize()
        equal = [bool(torch.equal(g, r)) for g, r in zip(got, ref)]
        if not all(equal):
            raise AssertionError(f"fused {wave} wave differs from the SBT "
                                 f"path: {equal}")
        err = max(float(torch.where(g == r, 0.0, (g.float() - r.float())
                                    .abs()).max()) for g, r in zip(got, ref))
        fused_wave_ms = cuda_ms(lambda: step(tracer), 5)[0]
        plain_wave_ms = cuda_ms(lambda: step(plain), 3)[0]
        trace_ms, shadow_ms = cuda_ms(trace, 5)[0], cuda_ms(shadow, 5)[0]
        out[wave] = dict(
            lanes=n, shading_lanes=s_lanes,
            prep_ms=prep_ms, finish_ms=finish_ms,
            prep_bound_ms=bound(0, prep_bytes)[0],
            finish_bound_ms=bound(0, finish_bytes)[0],
            fused_wave_ms=fused_wave_ms, plain_wave_ms=plain_wave_ms,
            trace_ms=trace_ms, shadow_ms=shadow_ms,
            plain_shade_ms=plain_wave_ms - trace_ms - shadow_ms,
            state_bit_equal=True, max_abs_err=err)
        log(f"[19] {wave}: {json.dumps(out[wave])} ({card})")
        state = got
    out["launches"] = dict(
        prep=mc.material_prep.launches - launches0[0],
        finish=mc.material_finish.launches - launches0[1])
    return out


def walk_counts(o, d, nodef, base, clip, group):
    """The node steps and leaves of escape-threaded walks in which
    `group` consecutive rays share one cursor (64: the TPU kernel's packet
    walk; 1: a ray alone, the packet kernel's ray-private walk), each
    ray's clip fixed at `clip` (its final t, or tmax): a node
    opens when any ray of the group enters its box before its clip.
    base: each ray's table row base.  Parked rays (an origin component of
    1e29 or more) walk nothing.  Returns per group the mean node steps
    and leaves entered, and the ray-leaf pairs with their triangle sum."""
    n = o.shape[0]
    dev = o.device
    g = -(-n // group)
    pad = g * group - n

    def grid(x, fill):
        if pad:
            x = torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])
        return x.view(g, group, *x.shape[1:])

    use = grid((o.abs() < 1e29).all(dim=1), False)
    ox, oy, oz = (grid(o[:, k], 0.0) for k in range(3))
    ix, iy, iz = (grid(1.0 / d[:, k], 1.0) for k in range(3))
    cl = grid(clip, 0.0)
    gbase = grid(base.long(), 0)[:, 0]
    idx = torch.where(use.any(dim=1), 0, -1)
    steps = torch.zeros(g, dtype=torch.int64, device=dev)
    leaves = torch.zeros(g, dtype=torch.int64, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    pair_tris = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        act = torch.nonzero(idx >= 0).squeeze(1)
        if act.numel() == 0:
            break
        row = nodef[gbase[act] + idx[act]]
        a_, esc, ntri = (row[:, k].long() for k in (8, 9, 10))
        t0x = (row[:, 0:1] - ox[act]) * ix[act]
        t1x = (row[:, 3:4] - ox[act]) * ix[act]
        t0y = (row[:, 1:2] - oy[act]) * iy[act]
        t1y = (row[:, 4:5] - oy[act]) * iy[act]
        t0z = (row[:, 2:3] - oz[act]) * iz[act]
        t1z = (row[:, 5:6] - oz[act]) * iz[act]
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.maximum(t0z, t1z))
        inside = ((tf >= torch.clamp(tn, min=0.0)) & (tn < cl[act])
                  & use[act])
        opened = inside.any(dim=1)
        leaf = ntri > 0
        steps[act] += 1
        leaves[act] += (leaf & opened).long()
        k = inside.sum(dim=1) * leaf.long()
        pairs += k.sum()
        pair_tris += (k * ntri).sum()
        idx[act] = torch.where(leaf, esc, torch.where(opened, a_, esc))
    counted = use.any(dim=1)
    return dict(group=group, groups=int(counted.sum()),
                steps=float(steps[counted].float().mean()),
                leaves=float(leaves[counted].float().mean()),
                ray_leaf_pairs=int(pairs), ray_leaf_tris=int(pair_tris))


def diffuse_bounce_wave(dev, card, scene, bench, pk):
    """Phase [20]: the interior's 1920x1080 diffuse bounce wave through
    the packet kernel (row 1), the wave its ray-private walk was built
    for.  The hall's tile-ordered primary of sample 0
    (interior_rays) is traced by the kernel; from each hit a direction
    drawn cosine-weighted about the hit face's normal (the views'
    material, roughness 0.6, scatters about as widely), from 1e-3 in
    front of it; the lanes sorted by coherence_key, the missed ones
    parked last, as the engine's argsort route sorts a bounce wave.  The
    kernel is timed (device_ms), held against its plain version and
    bounded by that version's counts (stats: ray_leaf_tris x
    FLOPS_PER_PAIR; the rays in and out, the node rows and leaves
    touched); walk_counts() gives the node steps and leaves of a 64-ray
    packet with one cursor and of a ray alone, each ray's clip at its
    final t: their ratio is the union factor the ray-private walk
    removes.  Returns the numbers."""
    n = W * H
    t0 = time.time()
    o1, d1 = interior_rays(dev, W, H, 0, bench._pcg3d_np)
    t1, tri1 = pk.packet_trace_cuda(o1, d1, None, scene.knode_f, scene.kleaf,
                                    TMIN, TMAX, any_hit=False, stable=True)
    hit = t1 < 3.4e38
    geo = scene.ktri_geo[tri1.clamp(min=0).long()]
    nrm = torch.linalg.cross(geo[:, 3:6], geo[:, 6:9])
    nrm = nrm / nrm.norm(dim=1, keepdim=True).clamp(min=1e-30)
    nrm = torch.where(((nrm * d1).sum(1) > 0)[:, None], -nrm, nrm)
    gen = torch.Generator(device=dev).manual_seed(20)
    u1 = torch.rand(n, device=dev, generator=gen)
    u2 = torch.rand(n, device=dev, generator=gen)
    r, phi = u1.sqrt(), 2 * np.pi * u2
    a = torch.where(nrm[:, :1].abs() > 0.9,
                    torch.tensor([0.0, 1.0, 0.0], device=dev),
                    torch.tensor([1.0, 0.0, 0.0], device=dev))
    tx = torch.linalg.cross(a, nrm)
    tx = tx / tx.norm(dim=1, keepdim=True)
    ty = torch.linalg.cross(nrm, tx)
    d2 = ((r * phi.cos())[:, None] * tx + (r * phi.sin())[:, None] * ty
          + (1 - u1).sqrt()[:, None] * nrm)
    o2 = o1 + torch.where(hit, t1, 0.0)[:, None] * d1 + 1e-3 * nrm
    key = torch.where(hit, pk.coherence_key(o2, d2), 2 ** 31 - 1)
    perm = torch.argsort(key, stable=True)
    parked = ~hit[perm]
    o2 = torch.where(parked[:, None], 1e30, o2[perm]).contiguous()
    d2 = torch.where(parked[:, None], 1.0, d2[perm]).contiguous()

    def run():
        return pk.packet_trace_cuda(o2, d2, None, scene.knode_f, scene.kleaf,
                                    TMIN, TMAX, any_hit=False, stable=True)

    ms, (t_k, tri_k) = device_ms(run, 10)
    st = {}
    p_ms, (t_p, tri_p) = cuda_ms(lambda: pk._packet_trace_reference(
        o2, d2, None, scene.knode_f, scene.kleaf, TMIN, TMAX,
        any_hit=False, stable=True, stats=st), 1, warmup=False)
    held = judge("[20] diffuse bounce", t_k, tri_k, t_p, tri_p, o2, d2, None,
                 scene.kprim, any_hit=False, t_scale="origin")
    b_ms, b_by = bound(st["ray_leaf_tris"] * FLOPS_PER_PAIR,
                       n * 32 + st["node_rows"] * 64
                       + st["leaves"] * scene.kleaf[0].numel() * 4)
    base = pk.packet_bases(d2, pk.PACKET_RAYS, scene.knode_f.shape[0] // 8)
    base = base.repeat_interleave(pk.PACKET_RAYS)[:n]
    clip = torch.where(t_k < 3.4e38, t_k, torch.full_like(t_k, TMAX))
    ray = walk_counts(o2, d2, scene.knode_f, base, clip, 1)
    packet = walk_counts(o2, d2, scene.knode_f, base, clip, pk.PACKET_RAYS)
    out = dict(rays=n, live=int(hit.sum()), ms=ms, plain_ms=p_ms,
               bound_ms=b_ms, bound_by=b_by, plain_stats=st,
               hit_agree=held["hit_agree"], prim_agree=held["prim_agree"],
               walk_ray=ray, walk_packet=packet,
               union_factor=packet["steps"] / ray["steps"],
               union_leaf_factor=packet["leaves"] / ray["leaves"])
    log(f"[20] diffuse bounce wave ({card}): {json.dumps(out)} "
        f"({time.time() - t0:.1f} s)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.environ.pop("RADIANCE_BENCH_SCENE", None)
    import bench
    from radiance_tpu_torch.api import accel
    from radiance_tpu_torch.core import math as rmath
    from radiance_tpu_torch.core import types
    from radiance_tpu_torch.ops import cuda_build
    from radiance_tpu_torch.ops import packet_trace as pk
    from radiance_tpu_torch.ops import stream3 as s3
    from radiance_tpu_torch.ops import stream3_multi as s3m
    from radiance_tpu_torch.ops import stream3_stages as stg
    from radiance_tpu_torch.ops.intersect import (FLT_MAX,
                                                  intersect_triangle_soup)
    from radiance_tpu_torch.shading import camera
    from radiance_tpu_torch.shading import material_cuda as mc

    dev = torch.device("cuda")
    t_start = time.time()

    # ---- 1. device and toolchain -------------------------------------
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; devices {torch.cuda.device_count()}")
    log("    nvcc:", subprocess.run([cuda_build.nvcc(), "--version"],
                                    capture_output=True, text=True,
                                    timeout=60).stdout.strip().splitlines()[-1])
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: the plain version's leaf "
                             "products must be IEEE f32")
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----------------------------------------------------
    t0 = time.time()
    libs = list(dict.fromkeys([
        pk.KERNEL, *stg.variant_libs(),
        *stg.variant_libs(LEAF_CAP, TQ7), *stg.variant_libs(WIDE_CAP, 9)]))
    cuda_build.load_all(libs)
    log(f"[2] seven kernel sources built as {len(libs)} libraries (the "
        f"defaults; B-E at leaf cap {LEAF_CAP} / tq {TQ7}, D and E at "
        f"{WIDE_CAP} lanes; the packet kernel takes every cap) in parallel "
        f"and loaded in "
        f"{time.time() - t0:.1f} s: {' '.join(cuda_build.NVCC_FLAGS)}")
    for name, info in cuda_build.BUILD_INFO.items():
        log(f"    {name}: {info['seconds']:.1f} s, "
            f"{' '.join(info['command'][len(cuda_build.NVCC_FLAGS) + 1:-3])}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("      ptxas:", line.strip())

    # ---- 3. kernel vs plain ------------------------------------------
    t0 = time.time()
    verts, tris = bench.scene_geometry("city")
    blas = accel.BuildBottomAccelStruct(types.Mesh(verts, tris))
    tlas = accel.BuildTopAccelStruct(
        [types.Instance(np.eye(4, dtype=np.float32), 0, 0, blas)])
    t_bvh = time.time() - t0
    scene = tlas.device_scene(dev)
    city_tlas = tlas
    torch.cuda.synchronize()
    log(f"[3] city: {len(tris)} tris, BVH {t_bvh:.1f} s, tables "
        f"{time.time() - t0 - t_bvh:.1f} s; knode_f "
        f"{tuple(scene.knode_f.shape)}, kleaf {tuple(scene.kleaf.shape)} "
        f"({scene.kleaf.numel() * 4 / 2 ** 20:.0f} MiB), stable "
        f"{scene.stable_frames}")
    tables = (scene.knode_f, scene.kleaf, scene.kprim)
    n = W * H
    o1, d1 = camera_rays(dev)
    light = torch.from_numpy(bench.light_vec()).to(dev).expand(n, 3).contiguous()
    t1, _ = pk.packet_trace_cuda(o1, d1, None, scene.knode_f, scene.kleaf,
                                 TMIN, TMAX, any_hit=False, stable=True)
    o2, d2 = bounce_rays(rmath, o1, d1, t1, FLT_MAX)
    hit1 = t1 < FLT_MAX
    waves = {"primary": (o1, d1), "bounce": (o2.contiguous(), d2.contiguous()),
             "shadow": (o2.contiguous(), light)}
    lo = n // 2 - PROBE // 2
    sl = slice(lo, lo + PROBE)
    rng = np.random.default_rng(0)
    rand_live = torch.from_numpy(rng.uniform(size=PROBE) < 0.7).to(dev)
    results = {}
    for wave, any_hit, live in (("primary", False, None),
                                ("primary", False, rand_live),
                                ("bounce", False, None),
                                ("bounce", False, hit1[sl]),
                                ("shadow", True, None),
                                ("shadow", True, hit1[sl])):
        o, d = waves[wave]
        name = f"{wave}/{pk.variant(any_hit, live is not None, True)}"
        results[name] = compare(name, pk, o[sl].contiguous(),
                                d[sl].contiguous(), live, *tables,
                                any_hit=any_hit, stable=True)

    # a scattered wave, as incoherent as the engine's GGX bounces (the
    # bench's mirror bounce mostly escapes the scene): random directions
    # into the hemisphere facing the camera, from 0.01 in front of each
    # primary hit, so no ray starts on its own surface
    from_hits = torch.nonzero(hit1).squeeze(1)[:PROBE]
    sd = rng.normal(size=(from_hits.numel(), 3)).astype(np.float32)
    sd = torch.from_numpy(sd / np.linalg.norm(sd, axis=1, keepdims=True))
    d_in = d1[from_hits]
    sd = sd.to(dev)
    sd = torch.where(((sd * d_in).sum(1) > 0)[:, None], -sd, sd).contiguous()
    so = (o1[from_hits] + (t1[from_hits] - 0.01)[:, None] * d_in).contiguous()
    for live in (None, rand_live[:from_hits.numel()]):
        name = f"scatter/{pk.variant(False, live is not None, True)}"
        results[name] = compare(name, pk, so, sd, live, *tables,
                                any_hit=False, stable=True,
                                t_scale="origin", mesh=(verts, tris))

    # legacy frames on a small near-origin scene, where both frame forms
    # are exact (tests/test_stable_frames.py's near-origin case)
    rng = np.random.default_rng(9)
    c = rng.uniform(-5, 5, (350, 3)).astype(np.float32)
    nv = (c[:, None, :] + rng.normal(scale=0.5, size=(350, 3, 3))
          .astype(np.float32)).reshape(-1, 3)
    near = accel.BuildTopAccelStruct([types.Instance(
        np.eye(4, dtype=np.float32), 0, 0, accel.BuildBottomAccelStruct(
            types.Mesh(nv, np.arange(1050, dtype=np.uint32).reshape(-1, 3))))])
    legacy = near.device_scene(dev, stable_frames=False)
    rng = np.random.default_rng(2)
    no = torch.from_numpy(rng.uniform(-6, 6, (PROBE, 3)).astype(np.float32))
    nd = rng.normal(size=(PROBE, 3)).astype(np.float32)
    nd = torch.from_numpy(nd / np.linalg.norm(nd, axis=-1, keepdims=True))
    for any_hit in (False, True):
        name = f"near/{pk.variant(any_hit, False, False)}"
        results[name] = compare(name, pk, no.to(dev), nd.to(dev), None,
                                legacy.knode_f, legacy.kleaf, legacy.kprim,
                                any_hit=any_hit, stable=False)

    # the far-from-origin grazing scene (tests/test_stable_frames.py)
    offset = np.array([600.0, 400.0, 500.0], np.float32)
    rng = np.random.default_rng(5)
    c = rng.uniform(-5, 5, (400, 3)).astype(np.float32)
    fv = ((c[:, None, :] + rng.normal(scale=0.5, size=(400, 3, 3))
           .astype(np.float32)).reshape(-1, 3) + offset).astype(np.float32)
    ft = np.arange(1200, dtype=np.uint32).reshape(-1, 3)
    far = accel.BuildTopAccelStruct([types.Instance(
        np.eye(4, dtype=np.float32), 0, 0,
        accel.BuildBottomAccelStruct(types.Mesh(fv, ft)))]).device_scene(dev)
    rng = np.random.default_rng(7)
    fo = np.tile((offset + [0, 0, 60.0]).astype(np.float32), (PROBE, 1))
    fd = offset + rng.uniform(-5, 5, (PROBE, 3)).astype(np.float32) - fo
    fd = (fd / np.linalg.norm(fd, axis=-1, keepdims=True)).astype(np.float32)
    fo_t, fd_t = torch.from_numpy(fo).to(dev), torch.from_numpy(fd).to(dev)
    results["far/closest"] = compare("far/closest", pk, fo_t, fd_t, None,
                                     far.knode_f, far.kleaf, far.kprim,
                                     any_hit=False, stable=True)
    got = pk.trace_rays_packet(far, fo_t, fd_t, TMIN, TMAX)
    vt = torch.from_numpy(fv).to(dev)
    tt = torch.from_numpy(ft.astype(np.int64)).to(dev)
    t_soup, _, _, _ = intersect_triangle_soup(
        fo_t, fd_t, vt[tt[:, 0]], vt[tt[:, 1]] - vt[tt[:, 0]],
        vt[tt[:, 2]] - vt[tt[:, 0]], TMIN, TMAX)
    soup_agree = float(((t_soup < FLT_MAX) == got.hit).float().mean())
    log(f"   far scene vs brute-force soup: hit agreement {soup_agree:.6f} "
        f"(hit rate {float((t_soup < FLT_MAX).float().mean()):.3f})")
    if soup_agree < BARS["hit"]:
        raise AssertionError(f"far grazing scene: {soup_agree}")

    # PCG3D on the card vs a numpy uint32 oracle: the hash words before
    # the float conversion, and the float output
    v = np.random.default_rng(0).integers(0, 2 ** 32, (100_000, 3),
                                          dtype=np.uint64).astype(np.uint32)
    v_t = torch.from_numpy(v.astype(np.int64)).to(dev)
    words = rmath.pcg3d_words(v_t).cpu().numpy()
    if not np.array_equal(words, pcg3d_words_np(v).astype(np.int64)):
        raise AssertionError("pcg3d words on the card are not bit-exact")
    if rmath.pcg3d(v_t).cpu().numpy().tobytes() != bench._pcg3d_np(v).tobytes():
        raise AssertionError("pcg3d floats on the card are not bit-exact")
    log("   pcg3d: uint32 words and float output bit-exact on 100000 "
        "full-range inputs")

    # a small render on the card against the CPU route (plain version)
    tracer = make_tracer()
    small_imgs = []
    for where in ("cpu", dev):
        cs, cr = cornell_inputs(where, 32)
        _, img = tracer.render(cs, cr, torch.zeros(1024, 3, device=where), 0,
                               32, 32, batch=2, depth=2)
        small_imgs.append(img.cpu().numpy()[..., :3].astype(np.float64))
    rmse = float(np.sqrt(np.mean((small_imgs[0] - small_imgs[1]) ** 2)))
    log(f"   Cornell 32x32 batch 2 depth 2, card vs CPU route: u8 RMSE "
        f"{rmse:.4f}")
    if rmse >= 3.0:
        raise AssertionError(f"small render disagrees: RMSE {rmse}")

    # sample1's 512x512 primary wave and its shadow wave, per ray, against
    # each Cornell-box instance's own tables (the per-instance sweeps)
    cs, cr = cornell_inputs(dev, CW)
    pix = torch.arange(CW * CW, device=dev)
    co, cd = camera.generate_rays(cr["camera"], pix, torch.stack(
        [torch.zeros_like(pix), torch.zeros_like(pix), pix], dim=1))
    ct = pk.trace_rays_packet_multi(cs, co, cd, TMIN, TMAX).t
    so_c = torch.where((ct < FLT_MAX)[:, None],
                       co + (ct - 1e-3)[:, None] * cd, co)
    sd_c = -rmath.normalize(torch.tensor([0.3, -1.0, -0.4], device=dev))
    sd_c = sd_c.expand_as(so_c)
    for slot, bi in enumerate(cs.inst_kblas):
        nodef, kleaf, kprim, _ = cs.kblas[bi]
        inv = cs.inst_inv[slot]
        for wave, any_hit, (wo, wd) in (("primary", False, (co, cd)),
                                        ("shadow", True, (so_c, sd_c))):
            name = f"cornell{slot}_{wave}/{pk.variant(any_hit, False, True)}"
            results[name] = compare(
                name, pk, rmath.mat4_transform_point(inv, wo).contiguous(),
                rmath.mat4_transform_dir(inv, wd).contiguous(), None, nodef,
                kleaf, kprim, any_hit=any_hit, stable=cs.stable_frames)
    log(f"[3] done in {time.time() - t0:.1f} s")

    # ---- 4. the three 1080p waves, kernel vs plain --------------------
    t0 = time.time()
    all_live = torch.ones(n, dtype=torch.bool, device=dev)
    timed = {   # variant -> (wave, live) at the shapes the engine gives it
        "closest": ("primary", None),
        "masked_closest": ("primary", all_live),
        "any_hit": ("shadow", None),
        "masked_any_hit": ("shadow", hit1),
    }
    times = {}

    def run(route, wave, live, any_hit, **kw):
        o, d = waves[wave]
        fn = (pk.packet_trace_cuda if route == "cuda"
              else pk._packet_trace_reference)
        return lambda: fn(o, d, live, scene.knode_f, scene.kleaf, TMIN, TMAX,
                          any_hit=any_hit, stable=True, **kw)

    pk_bounds = {}

    def timed_and_judged(wave, live, any_hit):
        """Time kernel and plain on a full wave, then hold the kernel's
        output to the plain version's, ray by ray, and closest-hit t to
        float64.  The bounce wave's hits are short rays from hit points,
        judged as the scattered probe is.  The plain version's walk
        counts give the variant's bound: every ray-triangle test of the
        rays inside a visited leaf's box at 22 FMAs, against the rays in
        and out (32 B each), the node rows (64 B) and leaf matrices
        (32 KiB) the walk touched, each once."""
        k_ms, (t_k, tri_k) = cuda_ms(run("cuda", wave, live, any_hit), 5)
        st = {}
        p_ms, (t_p, tri_p) = cuda_ms(run("plain", wave, live, any_hit,
                                         stats=st), 1, warmup=False)
        var = pk.variant(any_hit, live is not None, True)
        pk_bounds.setdefault(var, bound(   # closest: the primary wave's
            st["ray_leaf_tris"] * FLOPS_PER_PAIR,
            n * 32 + st["node_rows"] * 64
            + st["leaves"] * scene.kleaf[0].numel() * 4))
        log(f"    {wave}/{var} plain walk: {json.dumps(st)}; bound "
            f"{pk_bounds[var][0]:.4f} ms ({pk_bounds[var][1]})")
        name = f"{wave}_1080p/{var}"
        o, d = waves[wave]
        results[name] = judge(name, t_k, tri_k, t_p, tri_p, o, d, live,
                              scene.kprim, any_hit=any_hit,
                              t_scale="origin" if wave == "bounce" else "t",
                              mesh=(verts, tris))
        return k_ms, p_ms

    wave_ms = {}
    for wave, any_hit in (("primary", False), ("bounce", False),
                          ("shadow", True)):
        k_ms, p_ms = wave_ms[wave] = timed_and_judged(wave, None, any_hit)
        log(f"[4] {wave:8s} wave {n} rays: kernel {k_ms:.3f} ms "
            f"({n / k_ms / 1e3:.2f} Mrays/s), plain {p_ms:.3f} ms "
            f"({n / p_ms / 1e3:.3f} Mrays/s)")
    for var, (wave, live) in timed.items():
        any_hit = var.endswith("any_hit")
        if live is None:
            times[var] = wave_ms[wave]
            continue
        k_ms, p_ms = times[var] = timed_and_judged(wave, live, any_hit)
        log(f"[4] {wave:8s} wave, {var}: kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms")
    k_sum = sum(v[0] for v in wave_ms.values())
    p_sum = sum(v[1] for v in wave_ms.values())
    log(f"[4] three waves ({card}): kernel {3 * n / k_sum / 1e3:.3f} "
        f"Mrays/s, plain {3 * n / p_sum / 1e3:.3f} Mrays/s "
        f"({time.time() - t0:.1f} s)")

    # ---- 5. stream3 on the 1080p primary wave ------------------------
    t0 = time.time()
    s3k = {}        # stage key -> the kernel's JSON numbers
    stable = scene.stable_frames
    kleaf, knode = scene.kleaf, scene.knode_f

    def exact(name, k, p):
        same = k.shape == p.shape and torch.equal(
            k.contiguous().view(torch.int32), p.contiguous().view(torch.int32))
        log(f"   {name}: bit-exact {same}")
        if not same:
            raise AssertionError(f"{name}: transpose not bit-exact")

    # A: the wave's AoS -> rows (one launch for o and d) and the
    # features' rows -> ray-major, bit-exact against .t().contiguous() at
    # the wave's shapes and at odd ones
    rows = s3.rows_from_aos_fast(o1, d1)
    exact("A rows_from_aos_fast", torch.stack(rows),
          torch.cat([o1.t().contiguous(), d1.t().contiguous()]))
    _, feats_t, scal, smeta, bscal, _ = s3._stage_prep(
        rows, knode, scene.inst_inv[0], stable=stable)
    feats = stg.transpose_cuda(feats_t)
    exact("A feats_rows_to_major", feats, feats_t.t().contiguous())
    npad = feats_t.shape[1]
    nslot = scal.shape[0]
    gen = torch.Generator(device=dev).manual_seed(4)
    for m in (1, 31, 1025, 5000, 3 * stg.PKT + 7):
        x = torch.randn(m, 6, device=dev, generator=gen)
        xo, xd = x[:, :3].contiguous(), x[:, 3:].contiguous()
        exact(f"A aos_rows n={m}", stg.aos_rows_cuda(xo, xd),
              torch.cat([xo.t(), xd.t()]).contiguous())
    exact("A aos_rows on views offset by one ray (scalar path)",
          stg.aos_rows_cuda(o1[1:], d1[1:]),
          torch.cat([o1[1:].t(), d1[1:].t()]).contiguous())
    # past a 256-column tile boundary: a ragged last tile, then no float4
    for c in (npad + 4, npad + 1, 3):
        x = torch.randn(16, c, device=dev, generator=gen)
        exact(f"A transpose [16, {c}]", stg.transpose_cuda(x),
              x.t().contiguous())
    del x, xo, xd
    a_rows_ms, _ = cuda_ms(lambda: stg.aos_rows_cuda(o1, d1), 20)
    a_feats_ms, _ = cuda_ms(lambda: stg.transpose_cuda(feats_t), 20)
    a_ms, _ = cuda_ms(lambda: (stg.aos_rows_cuda(o1, d1),
                               stg.transpose_cuda(feats_t)), 20)
    a_plain, _ = cuda_ms(lambda: (o1.t().contiguous(), d1.t().contiguous(),
                                  feats_t.t().contiguous()), 20)
    # the kernels' line counts A's launches, two a wave: its numbers are
    # per launch, half the wave's
    s3k["transpose"] = dict(
        ms=a_ms / 2, plain_ms=a_plain / 2, library_ms=a_plain / 2,
        max_abs_err=0.0, bound=bound(0, 4 * (6 * n + 16 * npad)))
    log(f"   A ({card}): AoS -> rows {a_rows_ms:.4f} ms (bound "
        f"{bound(0, 2 * 4 * 6 * n)[0]:.4f}), features -> ray-major "
        f"{a_feats_ms:.4f} ms (bound {bound(0, 2 * 4 * 16 * npad)[0]:.4f}),"
        f" both {a_ms:.4f} ms in 2 launches (bound "
        f"{2 * s3k['transpose']['bound'][0]:.4f}); .t().contiguous() x 3 "
        f"{a_plain:.4f} ms")

    # B: emit, kernel vs plain on the same slot tables; the plain walk
    # also counts kernel B's window loads
    b_args = (scal, smeta, bscal, knode, TMAX, stg.STEP_CAP, stg.PCAP)
    b_ms, (wk, ek) = cuda_ms(lambda: stg.emit_cuda(*b_args), 5)
    b_plain, b_st = emit_hold(stg, b_args + (stg.STEP_ROWS,), (wk, ek))
    if stg.emit_window() != stg.EMIT_WINDOW:
        raise AssertionError(f"kernel B's window {stg.emit_window()} is "
                             f"not EMIT_WINDOW {stg.EMIT_WINDOW}")
    b_bound, nodes, words, _ = emit_bounds(
        stg, [(b_args + (stg.STEP_ROWS,), ek)])[0]
    cnt = torch.clamp(ek[:, 0], max=stg.PCAP)
    log(f"   B emit: word lists and emeta identical on {nslot} slots "
        f"({words} words, {int(ek[:, 2].sum())} step windows of "
        f"{stg.STEP_ROWS} rows, {nodes} nodes, {int(ek[:, 1].sum())} "
        f"capped; longest walk {b_st['max_steps']} step windows, "
        f"{b_st['max_nodes']} nodes; {b_st['window_loads']} window loads "
        f"of {stg.EMIT_WINDOW} rows, "
        f"{nodes / max(b_st['window_loads'], 1):.2f} nodes a load, the "
        f"longest chain {b_st['max_window_loads']} loads)")
    s3k["emit"] = dict(
        ms=b_ms, plain_ms=b_plain, library_ms=None, max_abs_err=0.0,
        bound=b_bound, longest_walk=b_st["max_steps"],
        longest_walk_nodes=b_st["max_nodes"],
        nodes_per_load=nodes / max(b_st["window_loads"], 1),
        max_window_loads=b_st["max_window_loads"])

    # C: refine, kernel vs plain on the (identical) emitted lists
    slot_pkt = smeta[:, 0].contiguous()
    aabb8 = s3.leaf_aabb8(knode, kleaf.shape[0])
    ref_args = (slot_pkt, feats_t, aabb8, TMAX, stg.PCAP)
    c_ms, (rk, rek) = cuda_ms(lambda: stg.refine_cuda(wk, ek, *ref_args), 5)
    c_plain = refine_hold(stg, (wk, ek) + ref_args, (rk, rek))
    c_bound, words, kept = refine_bound(stg, wk, ek, rek, stg.PCAP)
    log(f"   C refine: kept lists identical ({kept} of {words} words kept; "
        f"longest list {int(cnt.max())})")
    s3k["refine"] = dict(
        ms=c_ms, plain_ms=c_plain, library_ms=None, max_abs_err=0.0,
        bound=c_bound, longest_list=int(cnt.max()))

    # D: pair intersection, kernel vs plain on the refined lists; its
    # bound counts the unparked rays of each kept (leaf, block) pair
    # against the leaf's triangle lanes (the plain version's stats)
    is_args = (rk, rek, slot_pkt, feats, kleaf, TMIN, TMAX, stg.PCAP, stable)
    d_run = isect_launch(stg, is_args)
    res_d = hold_launches("D isect", [d_run])
    log(f"   D isect ({card}): {d_run['pairs']} (leaf, block) pairs over "
        f"{d_run['leaves']} leaves, {d_run['ray_tests']} unparked rays in "
        f"them against {d_run['tri_tests']} triangles "
        f"({d_run['tri_tests'] / max(d_run['ray_tests'], 1):.2f} a ray); "
        f"kernel {d_run['ms']:.3f} ms, plain {d_run['plain_ms']:.3f} ms, "
        f"bound {d_run['bound'][0]:.4f} ms ({d_run['bound'][1]}; all 128 "
        f"lanes of every pair: "
        f"{d_run['pairs'] * stg.BLK * stg.T * FLOPS_PER_PAIR / FP32_FLOPS * 1e3:.4f}"
        f" ms), {d_run['bound'][0] / d_run['ms']:.3f} of it")
    s3k["isect"] = dict(
        ms=d_run["ms"], plain_ms=d_run["plain_ms"], library_ms=None,
        max_abs_err=res_d["max_abs_err"], bound=d_run["bound"])
    del wk, rk, d_run

    # the whole wave: stream3 (all four kernels) against the packet
    # kernel, two exact tracers on the same rays, then its stage times
    w_ms, (rec3, diag) = cuda_ms(lambda: s3.trace_rows_stream3(
        scene, rows, TMIN, TMAX, with_diag=True), 10)
    pw_ms, rec_pk = cuda_ms(lambda: pk.trace_rays_packet(
        scene, o1, d1, TMIN, TMAX), 10)
    results["stream3_1080p/vs_packet_kernel"] = hold_prims(
        "stream3 wave vs packet kernel", rec3.t, rec3.prim, rec_pk.t,
        rec_pk.prim)
    _, spans = stage_spans(s3, lambda: s3.trace_rows_stream3(
        scene, s3.rows_from_aos_fast(o1, d1), TMIN, TMAX))
    s3_diag = {k: (int(v) if not isinstance(v, int) else v)
               for k, v in diag.items()
               if k in ("words", "kept_words", "steps", "capped", "flagged",
                        "residual_rays")}
    log(f"[5] stream3 primary 1080p ({card}): {w_ms:.3f} ms per wave "
        f"({n / w_ms / 1e3:.2f} Mrays/s) vs trace_rays_packet {pw_ms:.3f} "
        f"ms and the packet kernel alone {wave_ms['primary'][0]:.3f} ms; "
        f"diag {json.dumps(s3_diag)}")
    log(f"    stage ms (CUDA events): "
        f"{json.dumps({k: round(v, 3) for k, v in spans.items()})}")
    windows = {"[5] city tile-ordered primary": step_rows_wave(
        "[5] the city's tile-ordered 1080p primary", stg, s3,
        lambda: s3.trace_rows_stream3(scene, rows, TMIN, TMAX,
                                      with_diag=True), card)}
    for key, r in s3k.items():
        per = " (per launch)" if key == "transpose" else ""
        log(f"    {key}{per}: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} "
            f"ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    log(f"[5] done in {time.time() - t0:.1f} s")
    del rec3, rec_pk, feats, feats_t

    # ---- 6. the main path --------------------------------------------
    # two city frames and sample1's Cornell box, with the launch counts
    # reset just before and read just after; every launch of the packet
    # kernel and of D recorded (arguments and output) and timed on its own
    # shape from torch.profiler's kernel records
    res = city_resources(dev, verts, tris, W, H)
    cscene, cres = cornell_inputs(dev, CW)
    torch.cuda.synchronize()

    def fused_launches():
        return dict(prep=mc.material_prep.launches,
                    finish=mc.material_finish.launches)

    def main_frames(calls):
        pk.packet_trace_cuda.launches.clear()
        stg.reset_launches()
        mc.material_prep.launches = mc.material_finish.launches = 0
        frame_ms = []
        accum = torch.zeros(n, 3, device=dev)
        ts = 0
        calls.tag = "city"
        for _ in range(2):
            t0 = time.time()
            accum, image = tracer.render(scene, res, accum, ts, W, H,
                                         batch=4, depth=4)
            torch.cuda.synchronize()
            frame_ms.append((time.time() - t0) * 1e3)
            ts += 4
        city_launches = dict(pk.packet_trace_cuda.launches)
        city_s3 = {k: fn.launches for k, fn in stg.KERNELS.items()}
        city_fused = fused_launches()
        calls.tag = "cornell"
        t0 = time.time()
        caccum, cimage = tracer.render(cscene, cres,
                                       torch.zeros(CW * CW, 3, device=dev),
                                       0, CW, CW, batch=16, depth=4)
        torch.cuda.synchronize()
        cornell_ms = (time.time() - t0) * 1e3
        return (frame_ms, accum, image, city_launches, city_s3, city_fused,
                caccum, cimage, cornell_ms)

    # each try of the profile resets the counts and renders anew
    ((frame_ms, accum, image, city_launches, city_s3, city_fused, caccum,
      cimage, cornell_ms), main_calls, main_ms) = profiled(pk, s3,
                                                           main_frames)
    launches = dict(pk.packet_trace_cuda.launches)
    s3_launches = {k: fn.launches for k, fn in stg.KERNELS.items()}
    # the fused material wave's launches on the main path: every wave of
    # the city frames and of sample1 (the default SBT) takes it
    main_fused = dict(city=city_fused, cornell={
        k: v - city_fused[k] for k, v in fused_launches().items()})

    log(f"[6] city 1920x1080 batch 4 depth 4 ({card}; under "
        f"torch.profiler): frames "
        f"{', '.join(f'{m:.1f}' for m in frame_ms)} ms; "
        f"{4 * 4 * 2 * n / (frame_ms[-1] / 1e3) / 1e6:.3f} Mrays/s "
        f"(batch*depth*2*n / frame time); launches {city_launches}, "
        f"stream3 {city_s3}")
    check_frame("city", accum, image, n)
    log(f"[6] sample1 Cornell 512x512 batch 16 depth 4: {cornell_ms:.1f} ms; "
        f"launches after both {launches}, stream3 {s3_launches}, fused "
        f"material wave {main_fused}")
    if any(v <= 0 for c in main_fused.values() for v in c.values()):
        raise AssertionError(f"the main path missed the fused material "
                             f"wave: {main_fused}")
    check_frame("sample1", caccum, cimage, CW * CW)
    for var in PATH_VARIANTS:
        if launches.get(var, 0) <= 0:
            raise AssertionError(f"main path never launched variant {var}")
    if any(city_launches.get(v, 0) <= 0 for v in PATH_VARIANTS):
        raise AssertionError(f"city frame missed a variant: {city_launches}")
    city_keys = ("aos_rows", "transpose", "emit", "refine", "isect", "oscal")
    if any(city_s3[k] <= 0 for k in city_keys):
        raise AssertionError(f"city frame missed a stream3 kernel: {city_s3}")
    del accum, image, caccum, cimage

    # each launch's kernel ms, its plain version's ms and bound
    log(f"    kernel records of {sum(map(len, main_ms.values()))} launches "
        f"read")
    groups = {}             # (variant, scene, tables) -> [call]
    pk_ms = {}              # (variant, scene) -> [kernel ms a launch]
    for call, ms in zip(main_calls["packet_trace"],
                        main_ms["packet_trace"]):
        tag, a, k, _ = call
        var = pk.variant(k["any_hit"], a[2] is not None, k["stable"])
        groups.setdefault((var, tag, a[3].data_ptr(), a[4].data_ptr(),
                           float(a[5]), float(a[6])), []).append(call)
        pk_ms.setdefault((var, tag), []).append(ms)
    pk_plain = {}           # (variant, scene) -> [(plain ms, bound)]
    pk_errs = {}            # variant -> [max_abs_err of a group's hold]
    for (var, tag, *_), calls in groups.items():
        p_ms, bnd, held = packet_bounds(
            f"packet_trace[{var}] on {tag}'s {len(calls)} launches, sampled "
            f"packets", pk, calls, PLAIN_STRIDE[tag])
        pk_plain.setdefault((var, tag), []).append((p_ms, bnd))
        pk_errs.setdefault(var, []).append(held["max_abs_err"])
    log(f"    {len(groups)} plain walks over the packet launches (one "
        f"packet in {PLAIN_STRIDE}), each held against the kernel's "
        f"recorded output, in {time.time() - t0:.1f} s")
    main_pk = {}
    for var in PATH_VARIANTS:
        by_scene = {}
        for tag in ("city", "cornell"):
            if (var, tag) not in pk_ms:
                continue
            ms = pk_ms[(var, tag)]
            p_ms, bnds = zip(*pk_plain[(var, tag)])
            # the groups' plain ms and bounds spread evenly over their
            # launches, so that sums stay sums
            nl = len(ms)
            by_scene[tag] = summary(ms, [sum(p_ms) / nl] * nl,
                                    [(sum(b[0] for b in bnds) / nl,
                                      max(bnds)[1])] * nl)
        runs = sum(r["launches"] for r in by_scene.values())
        if runs != launches[var]:
            raise AssertionError(f"{var}: {runs} recorded launches, "
                                 f"{launches[var]} counted")
        main_pk[var] = summary(
            [m for tag in by_scene for m in pk_ms[(var, tag)]],
            [r["plain_ms_sum"] / r["launches"] for r in by_scene.values()
             for _ in range(r["launches"])],
            [(r["bound_ms"], r["bound_by"]) for r in by_scene.values()
             for _ in range(r["launches"])])
        main_pk[var]["by_scene"] = by_scene
        log_summary(f"packet_trace[{var}] over the main path's launches",
                    main_pk[var], card)
        for tag, r in by_scene.items():
            log_summary(f"  {tag}", r, card)
    t1 = time.time()
    d_city = [isect_launch(stg, a + (k["pcap"], k["stable"]), out)
              for _, a, k, out in main_calls["isect"]]
    log(f"    D's plain runs in {time.time() - t1:.1f} s")
    if len(d_city) != s3_launches["isect"]:
        raise AssertionError("D: recorded and counted launches differ")
    res_dm = hold_launches(f"D over the main path's {len(d_city)} launches",
                           d_city)
    d_lists = (main_ms["isect"], [r["plain_ms"] for r in d_city],
               [r["bound"] for r in d_city])
    d_main = summary(*d_lists)
    log_summary("D (stream3_isect) over the city frames' launches", d_main,
                card)
    # B and C on each city launch, every one held against its plain
    # version on its recorded arguments
    t1 = time.time()
    bc_city = chain_launches(stg, main_calls, main_ms, "city",
                             lambda rows: range(0, len(rows),
                                                CITY_HOLD_STRIDE))
    if any(len(bc_city[k]) != city_s3[k] for k in bc_city):
        raise AssertionError("B, C: recorded and counted launches differ")
    log(f"    B's and C's plain runs on the city launches in "
        f"{time.time() - t1:.1f} s")
    log_chains("city", bc_city, card)
    log(f"    C's test kernel: {stg.refine_grid(dev)} blocks of 256 threads "
        f"share each launch's chunks")
    # F on each city launch (the stream3 primaries' preps), its four
    # outputs held against its plain version on the recorded arguments
    if len(main_calls["oscal"]) != s3_launches["oscal"]:
        raise AssertionError("F: recorded and counted launches differ")
    f_lists = oscal_launches(stg, main_calls["oscal"],
                             main_ms["oscal"], "city")
    f_city = summary(*f_lists)
    log_summary("F (stream3_oscal) over the city frames' launches, each "
                "equal to plain", f_city, card)
    log(f"[6] per-launch plain runs in {time.time() - t0:.1f} s")
    del main_calls, d_city

    # ---- 7. the many-instance stream path, kernels E and F -----------
    t0 = time.time()
    # F on the city's 1080p primary rows in object space (padded to whole
    # groups), unmasked (the bench wave) and masked by the primary hits
    prep_args = (rows, knode, scene.inst_inv[0])
    rows_o = s3._stage_prep(*prep_args, stable=stable)[0]
    npad = rows_o[0].shape[0]
    npk = npad // stg.PKT
    live_o = torch.zeros(npad, dtype=torch.bool, device=dev)
    live_o[:n] = hit1
    oscal = {}
    for mode, lv in (("unmasked", None), ("masked", live_o)):
        f_ms, out_k = device_ms(lambda: stg.oscal_cuda(rows_o, lv, npk), 10)
        f_call, _ = cuda_ms(lambda: stg.oscal_cuda(rows_o, lv, npk), 10)
        f_plain, out_p = cuda_ms(lambda: stg._oscal_plain(rows_o, lv, npk),
                                 3)
        same = oscal_equal(out_k, out_p)
        bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      if a.is_floating_point() else torch.equal(a, b)
                      for a, b in zip(out_k, out_p))
        oscal[mode] = dict(ms=f_ms, plain_ms=f_plain, max_abs_err=0.0,
                           library_ms=None,
                           bound=oscal_bound(rows_o, lv, out_k))
        log(f"   F oscal {mode} ({card}): {npk} packets (cand, present, "
            f"full and {out_k[3].shape[0]} sub-frustum rows), equal to "
            f"plain {same} (bit for bit {bitwise}); kernel {f_ms:.4f} ms "
            f"(calls queued behind a sleep; a wrapper call by CUDA events "
            f"{f_call:.4f} ms), plain {f_plain:.4f} ms, bound "
            f"{oscal[mode]['bound'][0]:.4f} ms, "
            f"{oscal[mode]['bound'][0] / f_ms:.3f} of it")
        if not same:
            raise AssertionError(f"oscal {mode}: kernel differs from plain")

    def prep_ms(plain):
        s3.octant_scalars = stg._oscal_plain if plain else stg.octant_scalars
        try:
            return cuda_ms(lambda: s3._stage_prep(*prep_args, stable=stable),
                           5)[0]
        finally:
            s3.octant_scalars = stg.octant_scalars

    prep = [(prep_ms(True), prep_ms(False)) for _ in range(2)]
    log(f"   whole _stage_prep on the 1080p primary ({card}), the plain "
        f"route (octant and 32-ray sub-frustum scalars in torch) vs kernel "
        f"F (two turns): "
        f"{'; '.join(f'{a:.3f} vs {b:.3f} ms' for a, b in prep)}")

    # E on the city's 1080p shadow wave (bench shadow rays from the
    # primary hits toward light_vec, live = primary hit), on both list
    # forms: the emitted lists, and the lists refined by kernel C
    so, sd = waves["shadow"]
    srows, slive = s3._pad_wave(s3.park_dead(s3.rows_from_aos_fast(so, sd),
                                             hit1), hit1)
    _, sfeats_t, sscal, ssmeta, sbscal, _ = s3._stage_prep(
        srows, knode, scene.inst_inv[0], live=slive, stable=stable)
    swords, semeta = stg.emit_cuda(sscal, ssmeta, sbscal, knode, TMAX,
                                   stg.STEP_CAP, stg.PCAP)
    sslot = ssmeta[:, 0].contiguous()
    c_args = (swords, semeta, sslot, sfeats_t,
              s3.leaf_aabb8(knode, kleaf.shape[0]), TMAX, stg.PCAP)
    sc_ms, (rwords, remeta) = cuda_ms(lambda: stg.refine_cuda(*c_args), 5)
    sfeats = stg.transpose_cuda(sfeats_t)
    alive = ssmeta[:, 1] > 0
    # a slot's lanes are its packet's rays; only live ones count
    lane_live = slive.view(-1, stg.PKT)[ssmeta[:, 0].long()] & alive[:, None]
    e_city = {}
    for form, (ww, ee) in (("emitted", (swords, semeta)),
                           ("refined", (rwords, remeta))):
        e_args = (ww, ee, sslot, sfeats, kleaf, TMIN, TMAX, stg.PCAP, stable)
        e_ms, out_k = cuda_ms(lambda: stg.isect_occl_cuda(*e_args), 5)
        e_st = {}
        e_plain, out_p = cuda_ms(lambda: stg._isect_occl_plain(
            *e_args, stats=e_st, live=slive), 1, warmup=False)
        if not bool((out_k == out_p).all(dim=2)[~lane_live].all()):
            raise AssertionError(f"isect_occl differs from plain on a dead "
                                 f"lane ({form} lists)")
        res_e = hold_occluded(f"E isect_occl vs plain, {form} lists (live "
                              f"slot lanes)", out_k[..., 0] == 0,
                              out_p[..., 0] == 0, lane_live)
        e_bound, nwords, nleaves = pair_bound(stg, e_args, e_st, out_k)
        e_city[form] = dict(ms=e_ms, plain_ms=e_plain, library_ms=None,
                            max_abs_err=1.0 - res_e["live_agree"],
                            bound=e_bound, occ=out_k[..., 0] == 0)
        log(f"   E isect_occl ({card}), {form} lists: shadow wave "
            f"{int(hit1.sum())} live rays, {int(alive.sum())} live slots, "
            f"{nwords} words over {nleaves} leaves, {e_st['pairs']} (leaf, "
            f"block) pairs tested under the reference's schedule, "
            f"{e_st['ray_tests']} live unoccluded rays in them "
            f"({e_st['ray_tests'] / max(e_st['pairs'] * stg.BLK, 1):.4f} of "
            f"their lanes) against {e_st['tri_tests']} triangles "
            f"({e_st['tri_tests'] / max(e_st['ray_tests'], 1):.2f} a ray); "
            f"kernel {e_ms:.3f} ms, plain {e_plain:.3f} ms, "
            f"bound {e_bound[0]:.4f} ms ({e_bound[1]}), "
            f"{e_bound[0] / e_ms:.3f} of it")
        del out_k, out_p
    hold_occluded("E on refined vs emitted lists", e_city["refined"]["occ"],
                  e_city["emitted"]["occ"], lane_live)
    log(f"   C refine on the shadow wave's lists: {sc_ms:.3f} ms; C + E "
        f"{sc_ms + e_city['refined']['ms']:.3f} ms vs E alone on the emitted "
        f"lists {e_city['emitted']['ms']:.3f} ms")
    del swords, semeta, rwords, remeta, e_args, sfeats_t, sfeats

    # the whole occlusion wave through stream3 (kernels F, B, C, A and E)
    # against the packet kernel's live-masked any-hit: two exact tracers
    ow_ms, (rec_o, diag_o) = cuda_ms(lambda: s3.trace_rows_stream3(
        scene, s3.rows_from_aos_fast(so, sd), TMIN, TMAX, live=hit1,
        occl=True, with_diag=True), 3)
    pw_ms, rec_a = cuda_ms(lambda: pk.trace_rays_packet(
        scene, so, sd, TMIN, TMAX, any_hit=True, live=hit1), 3)
    if bool((rec_o.hit | rec_a.hit)[~hit1].any()):
        raise AssertionError("a dead lane of the shadow wave is occluded")
    res_o = hold_occluded("stream3 occlusion wave vs packet any-hit",
                          rec_o.hit, rec_a.hit, hit1)
    log(f"[7] stream3 occlusion 1080p shadow wave ({card}): {ow_ms:.3f} ms "
        f"vs the packet kernel's any-hit "
        f"{pw_ms:.3f} ms; occluded agreement {res_o['live_agree']:.7f} of "
        f"live rays, {res_o['occluded_agree']:.7f} of occluded ones; "
        f"flagged {diag_o['flagged']}, residual rays "
        f"{diag_o['residual_rays']}")
    del rec_o, rec_a

    # the 64-instance scene of bench.py --multi on the bench's primary rays
    tb = time.time()
    mscene, mres, mtlas = multi64_scene(dev, W, H)
    torch.cuda.synchronize()
    mt = s3m.multi_tables(mscene)
    log(f"   64-instance scene: {len(mscene.inst_kblas)} instances of "
        f"{len(mt.uniq)} BLASes, {MULTI_TRIS} triangles; built in "
        f"{time.time() - tb:.1f} s")
    # E and F timed at the pipeline's call sites (stream3's dispatchers,
    # which call nothing but the kernel on the card); the largest call of
    # each is kept to hold the kernel against its plain version
    e_f = {"stage_isect": lambda *a: a[0].shape[0],
           "octant_scalars": lambda *a: a[2]}
    mrows = s3.rows_from_aos_fast(o1, d1)
    m_ms, (mrec, mdiag) = cuda_ms(lambda: s3m.trace_rows_multi(
        mscene, mt, mrows, TMIN, TMAX, with_diag=True), 3)
    pm_ms, prec = cuda_ms(lambda: pk.trace_rays_packet_multi(
        mscene, o1, d1, TMIN, TMAX), 3)
    res_m = hold_prims("64-instance primary vs packet sweeps", mrec.t,
                       mrec.prim, prec.t, prec.prim)
    both = mrec.hit & prec.hit
    slot_agree = float((mrec.slot == prec.slot)[both].float().mean())
    log(f"[7] 64-instance primary 1080p ({card}): trace_rows_multi "
        f"{m_ms:.3f} ms ({n / m_ms / 1e3:.2f} Mrays/s) vs "
        f"trace_rays_packet_multi {pm_ms:.3f} ms ({n / pm_ms / 1e3:.2f} "
        f"Mrays/s); instance slot agreement {slot_agree:.7f}; diag "
        f"{json.dumps(mdiag)}, poisoned share {mdiag['poisoned'] / n:.7f}")
    if slot_agree < BARS["prim"]:
        raise AssertionError(f"64-instance slots disagree: {slot_agree}")
    windows["[7] multi64 scan primary"] = step_rows_wave(
        "[7] multi64's 1080p primary on the scan", stg, s3,
        lambda: s3m.trace_rows_multi(mscene, mt, mrows, TMIN, TMAX,
                                     with_diag=True), card)
    _, m_spans, m_big = call_spans(s3, list(e_f), lambda: s3m.trace_rows_multi(
        mscene, mt, mrows, TMIN, TMAX), keep=e_f)

    # its shadow wave (bench.py's: from the primary hits toward light_vec)
    mo2, _ = bounce_rays(rmath, o1, d1, mrec.t, FLT_MAX)
    mlive = mrec.hit
    srows_m = s3.rows_from_aos_fast(mo2, light)
    mso_ms, (mocc, mdiag_s) = cuda_ms(lambda: s3m.trace_rows_multi(
        mscene, mt, srows_m, TMIN, TMAX, live=mlive, occl=True,
        with_diag=True), 2)
    pms_ms, pocc = cuda_ms(lambda: pk.trace_rays_packet_multi(
        mscene, mo2, light, TMIN, TMAX, any_hit=True), 3)
    if bool(mocc.hit[~mlive].any()):
        raise AssertionError("a dead lane of the 64-instance shadow wave is "
                             "occluded")
    res_ms = hold_occluded("64-instance shadow wave vs packet sweeps",
                           mocc.hit, pocc.hit, mlive)
    log(f"[7] 64-instance shadow wave ({card}): trace_rows_multi(occl) "
        f"{mso_ms:.3f} ms vs trace_rays_packet_multi(any_hit) "
        f"{pms_ms:.3f} ms; occluded "
        f"agreement {res_ms['live_agree']:.7f} of live rays, "
        f"{res_ms['occluded_agree']:.7f} of occluded ones; diag "
        f"{json.dumps(mdiag_s)}, poisoned share "
        f"{mdiag_s['poisoned'] / max(int(mlive.sum()), 1):.7f} of live rays")
    _, s_spans, s_big = call_spans(s3, list(e_f), lambda: s3m.trace_rows_multi(
        mscene, mt, srows_m, TMIN, TMAX, live=mlive, occl=True), keep=e_f)
    for wave, sp in (("primary", m_spans), ("shadow", s_spans)):
        for name, v in sp.items():
            kern = {"octant_scalars": "F",
                    "stage_isect": "E" if wave == "shadow" else "D"}[name]
            if v:
                log(f"    {wave} {kern} ({name}): {len(v)} launches, "
                    f"{sum(v) / len(v):.4f} ms mean, {max(v):.4f} ms max")
    # E and F against their plain versions on the largest launch of each;
    # trace_rows_multi parks a sub-wave's dead lanes at origin 1e30, so
    # the live lanes are those with a nearer object-space origin
    fa = m_big["octant_scalars"]
    ea = s_big["stage_isect"] + (stg.PCAP, bool(mscene.stable_frames))
    if not oscal_equal(stg.oscal_cuda(*fa), stg._oscal_plain(*fa)):
        raise AssertionError("oscal differs from plain on a multi launch")
    e_big = occl_launch(stg, ea)
    hold_occluded(f"E on the largest multi64 launch ({ea[0].shape[0]} "
                  f"slots)", e_big["occ_k"], e_big["occ_p"], e_big["live"],
                  need_occluded=False)
    log(f"    largest launches: oscal {fa[2]} packets, equal to plain; "
        f"isect_occl {ea[0].shape[0]} slots ({card}): {e_big['words']} "
        f"words over {e_big['leaves']} leaves, {e_big['pairs']} pairs, "
        f"{e_big['ray_tests']} live unoccluded rays in them against "
        f"{e_big['tri_tests']} triangles; kernel {e_big['ms']:.4f} ms, "
        f"plain {e_big['plain_ms']:.3f} ms, bound {e_big['bound'][0]:.4f} "
        f"ms ({e_big['bound'][1]}), {e_big['bound'][0] / e_big['ms']:.3f} "
        f"of it")
    del mrec, prec, mocc, pocc, m_big, s_big, fa, ea, e_big

    # the main path on the 64-instance scene: one engine frame, its
    # launches of D, E and F recorded and timed on their own shapes from
    # torch.profiler's kernel records; then each held against its plain
    # version, which also bounds it
    scan = s3m.trace_rows_multi

    def mframe(calls):      # each try resets the counts and renders anew
        stg.reset_launches()
        waves_seen = []

        def tagged(*a, **k):    # each engine wave's launches tagged by wave
            waves_seen.append("shadow" if k.get("occl") else "closest")
            calls.tag = f"multi64/{len(waves_seen)}-{waves_seen[-1]}"
            return scan(*a, **k)

        s3m.trace_rows_multi = tagged
        try:
            tf0 = time.time()
            out = tracer.render(mscene, mres, torch.zeros(n, 3, device=dev),
                                0, W, H, batch=1, depth=2)
            torch.cuda.synchronize()
            return out, (time.time() - tf0) * 1e3
        finally:
            s3m.trace_rows_multi = scan

    ((maccum, mimage), mframe_ms), m_calls, m_ms = profiled(pk, s3, mframe)
    m_launches = {k: fn.launches for k, fn in stg.KERNELS.items()}
    log(f"[7] 64-instance frame 1920x1080 batch 1 depth 2 ({card}; under "
        f"torch.profiler): {mframe_ms:.1f} ms; stream3 launches "
        f"{m_launches}")
    check_frame("64-instance", maccum, mimage, n)
    # the scan takes column views of the engine's rays, so no AoS -> rows
    if any(v <= 0 for k, v in m_launches.items() if k != "aos_rows"):
        raise AssertionError(f"64-instance frame missed a kernel: "
                             f"{m_launches}")
    t1 = time.time()
    for key in ("emit", "refine", "isect", "isect_occl", "oscal"):
        if len(m_calls[key]) != m_launches[key]:
            raise AssertionError(f"{key}: recorded and counted launches "
                                 f"differ")
    d_multi = [isect_launch(stg, a + (k["pcap"], k["stable"]), out)
               for _, a, k, out in m_calls["isect"]]
    res_dm2 = hold_launches(f"D over the 64-instance frame's "
                            f"{len(d_multi)} launches", d_multi)
    dm_lists = (m_ms["isect"], [r["plain_ms"] for r in d_multi],
                [r["bound"] for r in d_multi])
    d_frame = summary(*dm_lists)
    log_summary("D (stream3_isect) over the 64-instance frame's launches",
                d_frame, card)
    e_runs = [occl_launch(stg, a + (k["pcap"], k["stable"]), out)
              for _, a, k, out in m_calls["isect_occl"]]
    e_live = sum(int(r["live"].sum()) for r in e_runs)
    e_agree = sum(int(((r["occ_k"] == r["occ_p"]) & r["live"]).sum())
                  for r in e_runs) / max(e_live, 1)
    log(f"    E over the 64-instance frame's {len(e_runs)} launches: "
        f"occluded agreement {e_agree:.7f} of {e_live} live lanes")
    if e_agree < BARS["hit"]:
        raise AssertionError(f"E disagrees with plain over a frame: "
                             f"{e_agree} of {e_live} live lanes")
    e_frame = summary(m_ms["isect_occl"], [r["plain_ms"] for r in e_runs],
                      [r["bound"] for r in e_runs])
    log_summary("E (stream3_isect_occl) over the 64-instance frame's "
                "launches", e_frame, card)
    fm_lists = oscal_launches(stg, m_calls["oscal"], m_ms["oscal"],
                              "64-instance frame")
    log(f"    the 64-instance frame's plain runs (D, E, F) in "
        f"{time.time() - t1:.1f} s")
    f_frame = summary(*fm_lists)
    log_summary("F (stream3_oscal) over the 64-instance frame's launches, "
                "each equal to plain", f_frame, card)
    t1 = time.time()
    bc_multi = chain_launches(stg, m_calls, m_ms, "multi64", multi_held)
    log(f"    B's and C's bounds on the 64-instance frame's "
        f"{len(bc_multi['emit'])} launches, and plain runs on "
        f"{sum('plain_ms' in r for r in bc_multi['emit'])} of them, in "
        f"{time.time() - t1:.1f} s")
    log_chains("multi64", bc_multi, card)
    del m_calls, d_multi, e_runs
    # a second frame, its traces' diagnostics recorded: the share of rays
    # that the reference's contract poisons (slot -2) in each engine wave
    waves_diag = []
    scan = s3m.trace_rows_multi

    def recorded(*a, **k):
        rec, diag = scan(*a, with_diag=True, **k)
        waves_diag.append(dict(diag, occl=bool(k.get("occl")),
                               rays=int(rec.t.shape[0])))
        return rec

    s3m.trace_rows_multi = recorded
    try:
        tracer.render(mscene, mres, maccum, 1, W, H, batch=1, depth=2)
    finally:
        s3m.trace_rows_multi = scan
    for dg in waves_diag:
        log(f"    engine wave ({'shadow' if dg['occl'] else 'closest'}): "
            f"{json.dumps(dg)}, poisoned share "
            f"{dg['poisoned'] / dg['rays']:.7f}")
    # the same first frame on the route scenes of 2-8 instances take (one
    # packet sweep per instance): the baseline of the scan's frame, and a
    # second tracer for its image
    from radiance_tpu_torch.engine import pathtracer
    scan_min = pathtracer.MULTI_SCAN_MIN_INSTANCES
    pathtracer.MULTI_SCAN_MIN_INSTANCES = len(mscene.inst_kblas) + 1
    try:
        sweep_ms = []
        for _ in range(2):
            tf0 = time.time()
            _, simage = tracer.render(mscene, mres,
                                      torch.zeros(n, 3, device=dev), 0, W, H,
                                      batch=1, depth=2)
            torch.cuda.synchronize()
            sweep_ms.append((time.time() - tf0) * 1e3)
    finally:
        pathtracer.MULTI_SCAN_MIN_INSTANCES = scan_min
    rmse = float((simage[..., :3].float() - mimage[..., :3].float())
                 .pow(2).mean().sqrt())
    log(f"[7] 64-instance frame on the per-instance sweeps ({card}): "
        f"{', '.join(f'{m:.1f}' for m in sweep_ms)} ms (the scan's "
        f"{mframe_ms:.1f} ms); u8 RMSE against the scan's image {rmse:.4f}")
    if rmse >= 3.0:
        raise AssertionError(f"64-instance frame: scan and sweeps differ, "
                             f"RMSE {rmse}")
    log(f"[7] done in {time.time() - t0:.1f} s")

    # ---- 8. the RD API -----------------------------------------------
    # sample1, the city GLB and sample2 through Platform and TraceRays,
    # each run with the launch counts reset just before and read just
    # after
    t0 = time.time()
    rd_counts = rd_api(dev, card, verts, tris, pk, s3, s3m, stg)
    log(f"[8] done in {time.time() - t0:.1f} s")

    # ---- 9. the walk and the animated scene --------------------------
    t0 = time.time()
    walk = walk_and_animated(dev, card, scene, verts, tris, waves, sl, mtlas,
                             pk, s3, s3m, stg)
    log(f"[9] done in {time.time() - t0:.1f} s")

    # ---- 10. the TLAS-native route -----------------------------------
    t0 = time.time()
    tlas = tlas_native(dev, card, tracer, light, pk, s3, s3m, stg)
    log(f"[10] done in {time.time() - t0:.1f} s")

    # ---- 11. temporal t-bounds ---------------------------------------
    t0 = time.time()
    tbound = temporal_bounds(dev, card, tracer, bench, pk, s3, s3m, stg)
    interior = tbound.pop("interior")
    log(f"[11] done in {time.time() - t0:.1f} s")

    # ---- 12. ray and word ordering -----------------------------------
    t0 = time.time()
    order = ordering_modes(dev, card, tracer, scene, res, verts, tris, waves,
                           hit1, interior, bench, pk, s3, stg)
    log(f"[12] done in {time.time() - t0:.1f} s")

    # ---- 13. sharded frames ------------------------------------------
    t0 = time.time()
    shard = sharded_frames(dev, card, tracer, scene, res, pk, stg)
    log(f"[13] done in {time.time() - t0:.1f} s")

    # ---- 14. LEAF64: leaf cap 64, 7-bit words ------------------------
    t0 = time.time()
    l64 = leaf64(dev, card, tracer, city_tlas, scene, res, verts, tris,
                 waves, hit1, pk, s3, stg)
    log(f"[14] done in {time.time() - t0:.1f} s")

    # ---- 15. wide leaves ---------------------------------------------
    t0 = time.time()
    wide = wide_leaves(dev, card, city_tlas, scene, waves, hit1, sl, pk, s3,
                       stg)
    log(f"[15] done in {time.time() - t0:.1f} s")

    # ---- 16. many BLASes at leaf cap 64 ------------------------------
    t0 = time.time()
    mb64 = many_blas64(dev, card, pk, s3m, stg)
    log(f"[16] done in {time.time() - t0:.1f} s")

    # ---- 17. the viewers ---------------------------------------------
    t0 = time.time()
    views = viewers(dev, card, pk, stg)
    log(f"[17] done in {time.time() - t0:.1f} s")

    # ---- 18. the SAH-driven leaf collapse ----------------------------
    t0 = time.time()
    coll = collapse_and_windows(dev, card, tracer, city_tlas, res, verts,
                                tris, waves, hit1, sl, pk, s3, s3m, stg)
    del city_tlas
    windows.update(order.pop("step_windows"))
    windows.update(l64.pop("step_windows"))
    log(f"[18] step windows (8 rows, the default, against 1): "
        f"{json.dumps(windows)}")
    log(f"[18] done in {time.time() - t0:.1f} s")

    # ---- 19. the fused material wave ---------------------------------
    t0 = time.time()
    fused = fused_material_wave(dev, card, tracer, scene, res)
    log(f"[19] done in {time.time() - t0:.1f} s")

    # ---- 20. the interior's diffuse bounce wave ----------------------
    t0 = time.time()
    diffuse = diffuse_bounce_wave(dev, card, interior, bench, pk)
    del interior
    log(f"[20] done in {time.time() - t0:.1f} s")

    # ---- 21. results -------------------------------------------------
    # per kernel: the main path's launches (the packet kernel: the city
    # frames and sample1; B, C, D and F: the city frames and the
    # 64-instance frame; E: the 64-instance frame), each timed on its own
    # shape; ms, plain_ms and bound_ms are means a launch over them, the
    # *_sum keys their sums (B's and C's plain keys only the held
    # launches').  A: phase [5]'s 1080p primary wave.  rd_api_launches:
    # each phase [8] path's own run; walk_phase_launches: phase [9]'s;
    # tlas_phase_launches: the native route's runs in phase [10], and
    # tlas_wave_1080p its launch on phase [10]'s primary (E: shadow) wave;
    # tbound_phase_launches: the bounded runs of phase [11], and D's
    # tbound_wave_1080p its mean launch on the interior's bounded samples;
    # ordering_phase_launches: the driven runs of phase [12];
    # sharding_phase_launches: the sharded runs of phase [13].  The new
    # forms' rows (C's tq sort, D's lean and cull): launches are those of
    # phase [12] (f)'s path (build_tracer with every mode on, on the two
    # 1080p primaries), ms, plain ms and bound their launch on the 1080p
    # primary's tq-sorted lists (C: the sorted refine), as phase [12] (c)
    # timed it.
    kernels = []
    for var in PATH_VARIANTS:
        errs = [r["max_abs_err"] for k, r in results.items()
                if k.rsplit("/", 1)[1] == var] + pk_errs[var]
        r = main_pk[var]
        kernels.append({
            "name": f"packet_trace[{var}]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": launches[var], "max_abs_err": max(errs),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "ms_sum": r["ms_sum"],
            "bound_ms_sum": r["bound_ms_sum"], "by_scene": r["by_scene"],
            "wave_1080p": dict(zip(("ms", "plain_ms"), times[var]),
                               bound_ms=pk_bounds[var][0]),
            "diffuse_bounce_1080p": (diffuse if var == "closest" else None),
            "packet": pk.PACKET_RAYS, "plain_packet_stride": PLAIN_STRIDE,
            "rd_api_launches": {k: c.get(f"packet_trace[{var}]", 0)
                                for k, c in rd_counts.items()},
            "walk_phase_launches": walk["launches"].get(
                f"packet_trace[{var}]", 0),
            "tlas_phase_launches": tlas["launches"].get(
                f"packet_trace[{var}]", 0),
            "tbound_phase_launches": tbound["launches"].get(
                f"packet_trace[{var}]", 0),
            "ordering_phase_launches": order["launches"].get(
                f"packet_trace[{var}]", 0),
            "sharding_phase_launches": shard["launches"].get(
                f"packet_trace[{var}]", 0)})
    d_all = summary(*(x + y for x, y in zip(d_lists, dm_lists)))
    frame_rows = {"isect": dict(d_all, max_abs_err=max(
        res_dm["max_abs_err"], res_dm2["max_abs_err"],
        s3k["isect"]["max_abs_err"]), by_scene={
            "city": d_main, "multi64": d_frame},
            wave_1080p=dict(ms=s3k["isect"]["ms"],
                            bound_ms=s3k["isect"]["bound"][0])),
        "isect_occl": dict(e_frame, max_abs_err=1.0 - e_agree),
        "oscal": dict(summary(*(x + y for x, y in zip(f_lists, fm_lists))),
                      max_abs_err=0.0, by_scene={
                          "city": f_city, "multi64": f_frame},
                      wave_1080p=dict(ms=oscal["masked"]["ms"],
                                      plain_ms=oscal["masked"]["plain_ms"],
                                      bound_ms=oscal["masked"]["bound"][0]))}
    for key in ("emit", "refine"):     # every city and multi64 launch
        w = s3k[key]
        frame_rows[key] = dict(
            chain_summary(bc_city[key] + bc_multi[key], key),
            max_abs_err=0.0, by_scene={
                "city": chain_summary(bc_city[key], key),
                "multi64": chain_summary(bc_multi[key], key)},
            wave_1080p=dict(ms=w["ms"], plain_ms=w["plain_ms"],
                            bound_ms=w["bound"][0]))
    for key, (name, src, replaced) in S3_KERNELS.items():
        if key in frame_rows:
            r = dict(frame_rows[key], library_ms=None)
            launched = r.pop("launches")
        else:
            r = s3k[key]
            r = dict(r, bound_ms=r["bound"][0], bound_by=r["bound"][1])
            del r["bound"]
            # A's two wrappers (AoS -> rows, features) are one entry
            launched = s3_launches[key] + (s3_launches["aos_rows"]
                                           if key == "transpose" else 0)
        kernels.append(dict({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaced[0], "also_replaces": replaced[1:],
            "launches": launched, "rd_api_launches": {
                k: c[key] + (c["aos_rows"] if key == "transpose" else 0)
                for k, c in rd_counts.items()},
            "walk_phase_launches": walk["launches"][key] + (
                walk["launches"]["aos_rows"] if key == "transpose" else 0),
            "tlas_phase_launches": tlas["launches"][key] + (
                tlas["launches"]["aos_rows"] if key == "transpose" else 0),
            "tlas_wave_1080p": tlas["held"][key],
            "tbound_phase_launches": tbound["launches"][key] + (
                tbound["launches"]["aos_rows"] if key == "transpose" else 0),
            "ordering_phase_launches": order["launches"].get(key, 0) + (
                order["launches"].get("aos_rows", 0)
                if key == "transpose" else 0),
            "sharding_phase_launches": shard["launches"].get(key, 0) + (
                shard["launches"].get("aos_rows", 0)
                if key == "transpose" else 0)},
            **r))
    kernels[[k["name"] for k in kernels].index("stream3_isect")][
        "tbound_wave_1080p"] = tbound["isect_1080p"]
    for name, (key, src, replaced) in ORDER_FORMS.items():
        form = ("refine/sort=True" if key == "refine[tqsort]" else
                "isect/sort=True/lean=True/cull=False"
                if key == "isect[lean]" else
                "isect/sort=True/lean=False/cull=True")
        f = order["forms"]["city"][form]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaced,
            "launches": order["build_tracer"]["main_launches"][key],
            "max_abs_err": f.get("max_abs_err", 0.0), "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": None,
            "ordering_phase_launches": order["launches"][key],
            "sharding_phase_launches": shard["launches"].get(key, 0),
            "interior_1080p": order["forms"]["interior"][form],
            "forms_1080p": {w: {k: v for k, v in fs.items()
                                if k.startswith(key.split("[")[0])}
                            for w, fs in order["forms"].items()}})
    # phases [14]-[17]: each row's launches in each driven path, and its
    # numbers at leaf cap 64 / tq 7 (the 1080p waves: [14] (c), (d)) and
    # on the 256-lane probe ([15])
    count_keys = {f"packet_trace[{v}]": (f"packet_trace[{v}]",)
                  for v in PATH_VARIANTS}
    count_keys.update({name: (key,) + (("aos_rows",) if key == "transpose"
                                       else ())
                       for key, (name, _, _) in S3_KERNELS.items()})
    count_keys.update({name: (key,) for name, (key, _, _)
                       in ORDER_FORMS.items()})
    paths = {"leaf64_launches": l64["launches"],
             "wide256_launches": wide["launches"],
             "multi64_leaf64_launches": mb64["launches"],
             "viewer_web_launches": views["web_launches"],
             "viewer_file_launches": views["file_launches"],
             "collapse_launches": coll["launches"]}
    pk_waves = {"closest": ("primary/closest", "bounce/closest"),
                "any_hit": ("shadow/any_hit",),
                "masked_any_hit": ("shadow/masked_any_hit",)}
    for row in kernels:
        for k, counts in paths.items():
            row[k] = sum(counts.get(c, 0) for c in count_keys[row["name"]])
        key = next((k for k, (name, _, _) in S3_KERNELS.items()
                    if name == row["name"]), None)
        if row["name"].startswith("packet_trace["):
            var = row["name"][len("packet_trace["):-1]
            row["leaf64_1080p"] = {w: l64["waves"][w]
                                   for w in pk_waves[var]}
            probe = {"closest": "primary", "any_hit": "shadow"}.get(var)
            if probe:
                row["wide256_probe"] = wide["packet"][probe]
                # phase [18]: each build's 1080p wave (greedy and SAH at
                # caps 128 and 64), the SAH builds' probes' holds
                row["collapse_1080p"] = dict(
                    {b: w[f"packet_{probe}_ms"]
                     for b, w in coll["waves"].items()},
                    sah_probe_max_abs_err=max(
                        h[f"packet_{probe}"]["max_abs_err"]
                        for h in coll["holds"].values()))
        elif key in ("emit", "refine", "isect", "isect_occl"):
            # B and C: the primary's launch; E: the shadow wave's
            for name, ph in (("leaf64_1080p", l64), ("wide256_probe", wide)):
                st = ph["shadow_stages" if key == "isect_occl"
                        else "stages"][key]
                row[name] = dict({k: v for k, v in st.items()
                                  if k != "bound"}, bound_ms=st["bound"][0],
                                 bound_by=st["bound"][1])
            if key == "isect":
                row["leaf64_1080p"].update(d_ms_in_turns=l64["d_ms_64"],
                                           d_ms_cap128=l64["d_ms_128"])
            # phase [18]: each build's launch on the 1080p primary (E: the
            # shadow wave), and the SAH builds' held launches
            stage = {"emit": "B", "refine": "C", "isect": "D",
                     "isect_occl": "E"}[key]
            wave = "shadow" if stage == "E" else "primary"
            row["collapse_1080p"] = {b: w[f"{stage}_{wave}_ms"]
                                     for b, w in coll["waves"].items()}
            for cap, h in coll["holds"].items():
                st = h["shadow_stages" if stage == "E" else "stages"][key]
                row["collapse_1080p"][f"sah{cap}_held"] = dict(
                    {k: v for k, v in st.items() if k != "bound"},
                    bound_ms=st["bound"][0], bound_by=st["bound"][1])
            if key == "emit":   # B: the step windows' waves
                row["step_windows"] = windows
    log(f"[14] metrics: " + json.dumps(
        {k: v for k, v in l64.items()
         if k not in ("launches", "stages", "shadow_stages")}))
    log(f"[15] metrics: " + json.dumps(
        {k: v for k, v in wide.items()
         if k not in ("launches", "stages", "shadow_stages")}))
    log(f"[16] metrics: " + json.dumps(
        {k: v for k, v in mb64.items() if k != "launches"}))
    log(f"[18] metrics: " + json.dumps(
        {k: v for k, v in coll.items() if k not in ("launches", "holds")}))
    log(f"[10] metrics: {json.dumps({k: v for k, v in tlas.items() if k not in ('launches', 'held')})}")
    log(f"[11] metrics: "
        f"{json.dumps({k: v for k, v in tbound.items() if k != 'launches'})}")
    log(f"[12] metrics: "
        f"{json.dumps({k: v for k, v in order.items() if k != 'launches'})}")
    log(f"[13] metrics: "
        f"{json.dumps({k: v for k, v in shard.items() if k != 'launches'})}")
    log(f"total {time.time() - t_start:.1f} s")
    # the fused material wave: launches the main path's ([6]: prep +
    # finish, the city frames and sample1), ms, plain_ms and bound_ms
    # phase [19]'s primary wave (ms the two kernels, plain_ms the SBT
    # path's shading and update without the wave's traces)
    prim = fused["primary"]
    kernels.append({
        "name": "shade_material", "route": "cuda",
        "source": "radiance_tpu_torch/csrc/shade_material.cu",
        "replaces": None,
        "launches": sum(v for c in main_fused.values() for v in c.values()),
        "main_launches": main_fused,
        "max_abs_err": max(fused[w]["max_abs_err"]
                           for w in ("primary", "bounce")),
        "ms": prim["prep_ms"] + prim["finish_ms"],
        "plain_ms": prim["plain_shade_ms"],
        "bound_ms": prim["prep_bound_ms"] + prim["finish_bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "fused_phase_launches": fused["launches"],
        "wave_1080p": {w: fused[w] for w in ("primary", "bounce")}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
