"""Packet-table ray traversal: the CUDA kernel, its plain PyTorch version,
and the tracing entry points around them.

Port of radiance_tpu/ops/packet_trace.py.  The TPU kernel (`_kernel`,
launched by `_run`) walks the escape-threaded octant node tables of
bvh/kernel_pack.py with one cursor per 1024-ray packet and intersects
leaves as [1024, 16] @ [16, 4T] Pluecker matrix products on the MXU.
Here:

  * on a CUDA tensor, `packet_trace_cuda` launches the hand-written
    kernel csrc/packet_trace.cu: packets of PACKET_RAYS rays, one block
    each, walking the packet-mean octant's table (`packet_bases`) with a
    cursor per ray, each leaf tested by a warp for the rays standing at
    it (the ray-private walk; see the source's header for its design);
  * on a CPU tensor, `_packet_trace_reference` runs the plain PyTorch
    version.  It keeps the TPU kernel's packet schedule, vectorised over
    packets -- one cursor per packet, a union box test, a batched
    [k,1024,16] @ [k,16,4T] leaf product for the packets at a leaf, the
    packet clip refreshed every 2nd leaf, a first-lane per-ray reduction
    -- so it matches the interpret-mode Pallas kernel up to matmul
    summation order.  It is also the card's comparison oracle.

The kernel is built with nvcc at first use (never at import) into the
git-ignored radiance_tpu_torch/_build/ and bound with ctypes
(ops/cuda_build.py).

The wrapper keeps the JAX epilogue: rays are moved into the instance's
object space, dead lanes of a live-masked wave are parked on an
out-of-scene ray, prim = kprim[tri], barycentrics are recomputed from
ktri_geo for the winning triangle, and slot = 0 on a hit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from radiance_tpu_torch.bvh.kernel_pack import check_leaf_cap
from radiance_tpu_torch.core import math as rmath
from radiance_tpu_torch.ops import compaction, cuda_build
from radiance_tpu_torch.ops.intersect import FLT_MAX, intersect_triangle
# HitRecord lives with the walk (ops/traversal.py), as in the JAX package;
# it is re-exported here for existing imports
from radiance_tpu_torch.ops.traversal import HitRecord
from radiance_tpu_torch.utils import profiling

PACKET = 1024                 # rays per packet in the plain version
PACKET_RAYS = 64              # rays per packet (and block) of the kernel:
                              # kP in csrc/packet_trace.cu
_REF_CHUNK = 64               # packets per batched leaf product


def supports(scene) -> bool:
    """True when the single-instance packet path applies."""
    return scene.knode_f is not None and scene.inst_inv.shape[0] == 1


def supports_multi(scene) -> bool:
    """True when instance-sequential packet sweeps apply."""
    return (scene.kblas is not None and scene.inst_kblas is not None
            and len(scene.inst_kblas) >= 1)


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

KERNEL = cuda_build.KernelLib("packet_trace", (("rt_packet_trace", (
    cuda_build.P, cuda_build.P, cuda_build.P, cuda_build.P, cuda_build.P,
    cuda_build.P, cuda_build.I64, cuda_build.I32, cuda_build.F32,
    cuda_build.F32, cuda_build.I32, cuda_build.I32, cuda_build.P,
    cuda_build.P, cuda_build.P)),))


def load_kernel():
    """Build (once per process, if the .so is missing or stale) and load
    the kernel library, one for every leaf cap (a leaf is tested in
    passes of 32 lanes, never staged whole);
    cuda_build.BUILD_INFO["packet_trace"] then holds the build seconds
    and nvcc's ptxas report."""
    return cuda_build.load(KERNEL)


def variant(any_hit: bool, masked: bool, stable: bool) -> str:
    """Launch-count key of a kernel variant."""
    name = ("masked_" if masked else "") + ("any_hit" if any_hit
                                            else "closest")
    return name if stable else name + "_legacy"


def packet_bases(d: torch.Tensor, packet: int, nk_local: int
                 ) -> torch.Tensor:
    """Each packet's node-table row base: [ceil(n / packet)] i32, octant
    * nk_local, the octant that of the packet's summed direction (the
    JAX package's _run, packet_trace.py:522-530); rays past n in the last
    packet add nothing.  d: [n, 3] f32."""
    n = d.shape[0]
    npk = -(-n // packet)
    dsum = torch.nn.functional.pad(d, (0, 0, 0, npk * packet - n)).view(
        npk, packet, 3).sum(dim=1)
    oct_ = ((dsum[:, 0] < 0).to(torch.int32)
            + 2 * (dsum[:, 1] < 0).to(torch.int32)
            + 4 * (dsum[:, 2] < 0).to(torch.int32))
    return oct_ * nk_local


def packet_trace_cuda(o, d, live, nodef, kleaf, tmin, tmax, *,
                      any_hit: bool, stable: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: (t [n] f32, tri [n] i32) on o's device.

    o, d: [n, 3] f32 object-space rays; live: [n] bool or None;
    nodef: [8*Nk, 16] f32; kleaf: [Nl, 16, 4T] f32, T a leaf cap (a
    multiple of 32 in [32, 512]).  Packets of PACKET_RAYS rays.
    """
    dev = o.device
    if dev.type != "cuda":
        raise ValueError("packet_trace_cuda needs CUDA tensors")
    n = o.shape[0]
    fn = "packet_trace_cuda"
    cuda_build.check_tensor(fn, "o", o, torch.float32, (n, 3), dev)
    cuda_build.check_tensor(fn, "d", d, torch.float32, (n, 3), dev)
    cuda_build.check_tensor(fn, "nodef", nodef, torch.float32, (None, 16),
                            dev)
    cuda_build.check_tensor(fn, "kleaf", kleaf, torch.float32,
                            (None, 16, None), dev)
    if nodef.shape[0] % 8 or kleaf.shape[2] % 4:
        raise ValueError(f"bad table shapes {tuple(nodef.shape)}, "
                         f"{tuple(kleaf.shape)}")
    lanes = check_leaf_cap(kleaf.shape[2] // 4)
    live_u8 = None
    if live is not None:
        if live.shape != (n,) or live.device != dev:
            raise ValueError("live must be [n] on the rays' device")
        live_u8 = live.to(torch.uint8).contiguous()
    lib = load_kernel()
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_tri = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out_t, out_tri
    base = packet_bases(d, PACKET_RAYS, nodef.shape[0] // 8)
    with cuda_build.on_device(dev) as stream:
        err = lib.rt_packet_trace(
            o.data_ptr(), d.data_ptr(),
            None if live_u8 is None else live_u8.data_ptr(), base.data_ptr(),
            nodef.data_ptr(), kleaf.data_ptr(), n, lanes,
            float(tmin), float(tmax), int(any_hit), int(stable),
            out_t.data_ptr(), out_tri.data_ptr(), stream)
    cuda_build.check_launch("packet_trace", err)
    cuda_build.count_launch(packet_trace_cuda,
                            key=variant(any_hit, live is not None, stable))
    return out_t, out_tri


# launches of the kernel per variant name (see variant()); counted only
# where a launch succeeds
packet_trace_cuda.launches = {}


# ---------------------------------------------------------------------------
# Plain PyTorch version (the TPU kernel's packet schedule)
# ---------------------------------------------------------------------------

def _packet_trace_reference(o, d, live, nodef, kleaf, tmin, tmax, *,
                            any_hit: bool, stable: bool, stats=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (t [n] f32, tri [n] i32).

    Same arguments as packet_trace_cuda, on any device.  Follows
    radiance_tpu/ops/packet_trace.py::_kernel step for step, with every
    packet advanced in lockstep: packet i's cursor, clip and pending-leaf
    pipeline are exactly the TPU kernel's grid step i.

    stats, a dict if given, receives the walk's counts, from which a
    caller bounds the kernel's work: packet node steps, distinct node
    rows and leaves touched, and ray_leaf_tris, the sum over staged
    leaves of (rays of the packet inside the leaf box) x (its triangles).
    """
    f32, i64 = torch.float32, torch.int64
    dev = o.device
    n = o.shape[0]
    T = kleaf.shape[2] // 4
    masked = live is not None
    fmax = torch.tensor(FLT_MAX, dtype=f32, device=dev)
    tmin_t = torch.tensor(float(tmin), dtype=f32, device=dev)
    tmax_t = torch.tensor(float(tmax), dtype=f32, device=dev)
    if n == 0:
        return (torch.empty(0, dtype=f32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))

    pad = (-n) % PACKET
    if pad:
        o = torch.cat([o, o[:1].expand(pad, 3)])
        d = torch.cat([d, d[:1].expand(pad, 3)])
    npk = (n + pad) // PACKET
    if masked:
        alive = torch.cat([live.bool(), torch.zeros(pad, dtype=torch.bool,
                                                    device=dev)])
        o = torch.where(alive[:, None], o, 1e30)
        d = torch.where(alive[:, None], d, 1.0)
        alive_pk = alive.view(npk, PACKET)
    mom = torch.zeros_like(o) if stable else rmath.cross(o, d)
    tail = torch.zeros(o.shape[0], 6, dtype=f32, device=dev)
    if masked:
        tail[:, 1] = alive.to(f32)
    feats = torch.cat([d, mom, o, torch.ones(o.shape[0], 1, dtype=f32,
                                             device=dev), tail], dim=1)
    feats = feats.view(npk, PACKET, 16)
    invd = 1.0 / d
    ox, oy, oz = (o[:, k].reshape(npk, PACKET) for k in range(3))
    ix, iy, iz = (invd[:, k].reshape(npk, PACKET) for k in range(3))

    # packet-mean direction octant -> row base into the 8 node tables
    dsum = d.view(npk, PACKET, 3).sum(dim=1)
    oct_ = ((dsum[:, 0] < 0).to(i64) + 2 * (dsum[:, 1] < 0).to(i64)
            + 4 * (dsum[:, 2] < 0).to(i64))
    base = oct_ * (nodef.shape[0] // 8)

    idx = torch.zeros(npk, dtype=i64, device=dev)
    clip = torch.full((npk,), FLT_MAX, dtype=f32, device=dev)
    p_row = torch.zeros(npk, dtype=i64, device=dev)
    p_start = torch.zeros(npk, dtype=torch.int32, device=dev)
    cnt = torch.zeros(npk, dtype=i64, device=dev)
    best_t = torch.full((npk, PACKET, T), FLT_MAX, dtype=f32, device=dev)
    best_tri = torch.full((npk, PACKET, T), -1, dtype=torch.int32,
                          device=dev)
    lanes = torch.arange(T, dtype=torch.int32, device=dev)
    node_seen = torch.zeros(nodef.shape[0], dtype=torch.bool, device=dev)
    leaf_seen = torch.zeros(kleaf.shape[0], dtype=torch.bool, device=dev)
    ray_leaf_tris = torch.zeros((), dtype=i64, device=dev)
    node_steps = 0

    def process_leaf(pk, rows, starts, do_clip):
        """Intersect the leaves `rows` with packets `pk` (one leaf each)."""
        for c in range(0, pk.numel(), _REF_CHUNK):
            q = pk[c:c + _REF_CHUNK]
            w = kleaf[rows[c:c + _REF_CHUNK]]                 # [k, 16, 4T]
            x = feats[q]                                      # [k, P, 16]
            m = torch.bmm(x, w)                               # [k, P, 4T]
            if stable:
                # leaf-local ray moment (o - c) x d on the edge rows 3-5
                dv = x[:, :, 0:3]
                lo0 = x[:, :, 6:7] - w[:, 12, 0][:, None, None]
                lo1 = x[:, :, 7:8] - w[:, 13, 0][:, None, None]
                lo2 = x[:, :, 8:9] - w[:, 14, 0][:, None, None]
                rm0 = lo1 * dv[:, :, 2:3] - lo2 * dv[:, :, 1:2]
                rm1 = lo2 * dv[:, :, 0:1] - lo0 * dv[:, :, 2:3]
                rm2 = lo0 * dv[:, :, 1:2] - lo1 * dv[:, :, 0:1]
                m = (m + rm0 * w[:, 3:4, :] + rm1 * w[:, 4:5, :]
                     + rm2 * w[:, 5:6, :])
            s0, s1, s2 = m[..., :T], m[..., T:2 * T], m[..., 2 * T:3 * T]
            num = m[..., 3 * T:]
            ssum = s0 + s1 + s2
            b0 = s0.view(torch.int32)
            b1 = s1.view(torch.int32)
            b2 = s2.view(torch.int32)
            inside = ((b0 ^ b1) | (b1 ^ b2)) >= 0
            t = -num / ssum                      # ssum == 0 -> NaN -> miss
            clip_q = clip[q]
            ok = inside & (t > tmin_t) & (
                t < torch.minimum(clip_q, tmax_t)[:, None, None])
            if masked:
                ok = ok & alive_pk[q][:, :, None]
            tt = torch.where(ok, t, fmax)
            bt = best_t[q]
            improve = tt < bt
            bt = torch.where(improve, tt, bt)
            best_t[q] = bt
            best_tri[q] = torch.where(
                improve, starts[c:c + _REF_CHUNK][:, None, None] + lanes,
                best_tri[q])
            dc = do_clip[c:c + _REF_CHUNK]
            if bool(dc.any()):
                rmin = bt.amin(dim=2)                          # [k, P]
                if masked:
                    rmin = torch.where(alive_pk[q], rmin, -fmax)
                clip[q] = torch.where(
                    dc, torch.minimum(clip_q, rmin.amax(dim=1)), clip_q)

    while True:
        act = torch.nonzero(idx >= 0).squeeze(1)
        if act.numel() == 0:
            break
        if stats is not None:
            node_steps += act.numel()
            node_seen[base[act] + idx[act]] = True
        row = nodef[base[act] + idx[act]]                     # [k, 16]
        a_ = row[:, 8].to(i64)
        esc = row[:, 9].to(i64)
        ntri = row[:, 10].to(i64)
        tri_start = row[:, 11].to(torch.int32)
        clip_eff = torch.minimum(clip[act], tmax_t)[:, None]
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
        hit = (tf >= torch.maximum(tn, torch.zeros_like(tn))) & (tn < clip_eff)
        if masked:
            hit = hit & alive_pk[act]
        box_hit = hit.any(dim=1)
        is_leaf = ntri > 0
        stage = is_leaf & box_hit
        if bool(stage.any()):
            if stats is not None:
                leaf_seen[a_[stage]] = True
                ray_leaf_tris += (hit[stage].sum(dim=1) * ntri[stage]).sum()
            s = act[stage]
            pend = cnt[s] > 0
            if bool(pend.any()):
                # two-slot pipeline: staging leaf k processes leaf k-1,
                # refreshing the clip when k is odd
                q = s[pend]
                process_leaf(q, p_row[q], p_start[q], (cnt[q] & 1) == 1)
            p_row[s] = a_[stage]
            p_start[s] = tri_start[stage]
            cnt[s] += 1
        nxt = torch.where(is_leaf, esc, torch.where(box_hit, a_, esc))
        if any_hit:
            nxt = torch.where(clip[act] < FLT_MAX * 0.5, -1, nxt)
        idx[act] = nxt

    # drain: the last staged leaf of each packet is still unprocessed
    q = torch.nonzero(cnt > 0).squeeze(1)
    if q.numel():
        process_leaf(q, p_row[q], p_start[q],
                     torch.zeros(q.numel(), dtype=torch.bool, device=dev))

    if stats is not None:
        stats.update(node_steps=node_steps, node_rows=int(node_seen.sum()),
                     leaves=int(leaf_seen.sum()),
                     ray_leaf_tris=int(ray_leaf_tris))
    # per-ray reduction: min over lanes, first lane wins ties
    pr = best_t.amin(dim=2)
    match = best_t == pr[..., None]
    jmin = torch.where(match, lanes, T).amin(dim=2)
    tri = torch.gather(best_tri, 2, jmin[..., None].to(i64)).squeeze(2)
    return pr.reshape(-1)[:n], tri.reshape(-1)[:n]


def packet_trace(o, d, live, nodef, kleaf, tmin, tmax, *, any_hit: bool,
                 stable: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if o.device.type == "cuda":
        return packet_trace_cuda(o, d, live, nodef, kleaf, tmin, tmax,
                                 any_hit=any_hit, stable=stable)
    if o.device.type == "cpu":
        return _packet_trace_reference(o, d, live, nodef, kleaf, tmin, tmax,
                                       any_hit=any_hit, stable=stable)
    raise ValueError(f"packet_trace: no route for device {o.device}")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _run(origin, direction, tmin, tmax, nodef, kleaf, kprim, ktri_geo,
         inv0, *, any_hit: bool, live=None, stable: bool) -> HitRecord:
    with profiling.span("packet.trace"):
        o = rmath.mat4_transform_point(inv0, origin.to(torch.float32))
        d = rmath.mat4_transform_dir(inv0, direction.to(torch.float32))
        if live is not None:
            live = live.bool()
            # dead lanes may carry NaN/Inf: park them on an out-of-scene ray
            o = torch.where(live[:, None], o, 1e30)
            d = torch.where(live[:, None], d, 1.0)
        t, tri = packet_trace(o.contiguous(), d.contiguous(), live, nodef,
                              kleaf, tmin, tmax, any_hit=any_hit,
                              stable=stable)
        hit = t < FLT_MAX
        tri_c = tri.clamp(0, kprim.shape[0] - 1).to(torch.int64)
        prim = torch.where(hit, kprim[tri_c], -1)
        slot = torch.where(hit, 0, -1).to(torch.int32)
        # barycentrics of the winning triangle, recomputed from the
        # per-face geometry table (object-space ray)
        geo = ktri_geo[tri_c]
        _, _, b1, b2 = intersect_triangle(o, d, geo[:, 0:3], geo[:, 3:6],
                                          geo[:, 6:9])
        return HitRecord(t=t, prim=prim, slot=slot,
                         b1=torch.where(hit, b1, 0.0),
                         b2=torch.where(hit, b2, 0.0))


def trace_rays_packet(scene, origin, direction, tmin, tmax,
                      any_hit: bool = False, live=None) -> HitRecord:
    """Trace a wavefront [N, 3] against a single-instance scene.

    any_hit=True is occlusion mode: a ray stops at its first accepted
    hit; the returned t is a true hit distance.  live ([N] bool) selects
    the live-mask variant: dead lanes trace nothing and come back as a
    miss.  Caller must check supports(scene).
    """
    return _run(origin, direction, tmin, tmax, scene.knode_f, scene.kleaf,
                scene.kprim, scene.ktri_geo, scene.inst_inv[0],
                any_hit=any_hit, live=live, stable=scene.stable_frames)


def trace_rays_packet_multi(scene, origin, direction, tmin, tmax,
                            any_hit: bool = False) -> HitRecord:
    """Multi-instance tracing: one sweep per instance in its object
    space, hits min-combined across instances (earlier slot wins ties)."""
    best = None
    for slot, bi in enumerate(scene.inst_kblas):
        nodef, kleaf, kprim, ktri_geo = scene.kblas[bi]
        rec = _run(origin, direction, tmin, tmax, nodef, kleaf, kprim,
                   ktri_geo, scene.inst_inv[slot], any_hit=any_hit,
                   stable=scene.stable_frames)
        rec.slot = torch.where(rec.hit, slot, -1).to(torch.int32)
        if best is None:
            best = rec
        else:
            take = rec.t < best.t
            best = HitRecord(*(torch.where(take, getattr(rec, f.name),
                                           getattr(best, f.name))
                               for f in dataclasses.fields(HitRecord)))
    return best


def _part1by2(v):
    """Spread 10 bits to every 3rd bit (Morton interleave helper)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def coherence_key(origin, direction) -> torch.Tensor:
    """Sort key grouping rays into traversal-coherent packets: direction
    octant (major) then a 30-bit Morton code of the origin.  [N] int32."""
    i64 = torch.int64
    oct_ = ((direction[:, 0] < 0).to(i64) + 2 * (direction[:, 1] < 0).to(i64)
            + 4 * (direction[:, 2] < 0).to(i64))
    lo = origin.amin(dim=0)
    hi = origin.amax(dim=0)
    q = (origin - lo) / torch.clamp(hi - lo, min=1e-20) * 1023.0
    q = torch.clamp(q, 0.0, 1023.0).to(torch.int32).to(i64)
    morton = (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
              | (_part1by2(q[:, 2]) << 2))
    return ((oct_ << 28) + (morton >> 2)).to(torch.int32)


def trace_rays_packet_sorted(scene, origin, direction, tmin, tmax,
                             any_hit: bool = False) -> HitRecord:
    """trace_rays_packet over rays sorted by coherence_key (a stable
    argsort, as the JAX module's), results gathered back to caller
    order."""
    perm = torch.argsort(coherence_key(origin, direction), stable=True)
    rec = trace_rays_packet(scene, origin[perm], direction[perm], tmin, tmax,
                            any_hit=any_hit)
    return rec.take(compaction.invert_perm(perm))


def build_tracer(scene, any_hit: bool = False):
    """A standalone tracer for one single-instance DeviceScene:
    fn(origin [N,3], direction [N,3], tmin, tmax, live=None) -> HitRecord."""
    if not supports(scene):
        raise ValueError("packet kernel requires a single-instance scene "
                         "with kernel tables (see kernel_pack.py)")

    def run(origin, direction, tmin, tmax, live=None):
        return trace_rays_packet(scene, origin, direction, tmin, tmax,
                                 any_hit=any_hit, live=live)

    return run
