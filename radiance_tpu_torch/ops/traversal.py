"""Two-level BVH traversal, vectorized over ray wavefronts: the walk.

Port of radiance_tpu/ops/traversal.py (reference: the per-ray stack walk
of radiance/shader/radiance.cl:41-192).  Each ray carries three cursors
(TLAS node, instance-leaf cursor, BLAS node) over the escape-threaded
node table `DeviceScene.node_packed`, so the left-first threaded order
visits nodes as the reference's push-right/pop-left stack does.  A node
step is one packed-row gather and a slab test; a ray that reaches a
triangle leaf parks, and parked rays intersect their 8-wide leaf bundle
(`bundle_packed`) together in a leaf phase.

The walk is the tracer of every case the packet tables cannot take:
custom any-hit programs (AnyHitCandidates), scenes without kernel tables
(more than MAX_KERNEL_INSTANCES instances, the on-device LBVH) and the
exact oracle of the other tracers.

What stays as in the JAX module, because results depend on it:
  * the step: TLAS step, instance-leaf enter and exit, BLAS step,
    parking at a triangle leaf, in that order of precedence;
  * the flush rule: UNROLL node steps, then the leaf phase only when no
    ray walks or the parked rays are at least as many as the walking
    ones.  A ray is parked until its leaf is taken, so its own leaf order
    and hit never depend on when the phase runs, but a custom program
    sees whole leaf bundles in the order the walk offers them;
  * the accept window tmin < t < tmax, t below the ray's best, the
    first lane on ties (torch.argmin returns the first minimum);
  * any_hit_terminate retires a ray on any improvement; a program's
    terminate acts once per leaf bundle;
  * chunks of config.DEFAULT_RAY_CHUNK rays, the last one padded with
    copies of the wave's first rays (their results are dropped).

`lax.while_loop` and `lax.cond` become a Python loop on the scene's
device with one host read an iteration: the walking and parked counts,
stacked.  There is no CPU fallback and no kernel of its own: every op
runs where the scene's tensors are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from radiance_tpu_torch import config
from radiance_tpu_torch.bvh.device import (KIND_INNER, META_A_MASK,
                                           META_COUNT_SHIFT, META_KIND_SHIFT)
from radiance_tpu_torch.core import math as rmath
from radiance_tpu_torch.ops.intersect import (FLT_MAX, intersect_aabb,
                                              intersect_triangle)

UNROLL = 4          # node steps between leaf-phase decisions


@dataclasses.dataclass
class HitRecord:
    """Closest-hit result (reference: radiance.cl HitData, :8-18).

    t: hit distance (FLT_MAX on miss), the same in world and object space;
    prim: primID of the hit triangle within its mesh (-1 on miss);
    slot: index into the DeviceScene instance arrays (-1 on miss);
    b1, b2: barycentrics of v1/v2.
    """
    t: torch.Tensor
    prim: torch.Tensor
    slot: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor

    @property
    def hit(self) -> torch.Tensor:
        return self.t < FLT_MAX

    def take(self, index: torch.Tensor) -> "HitRecord":
        """Gather every field by `index` (a permutation or mask)."""
        return HitRecord(*(getattr(self, f.name)[index]
                           for f in dataclasses.fields(self)))

    def masked_miss(self, miss: torch.Tensor) -> "HitRecord":
        """Force the lanes in `miss` to report a miss."""
        return HitRecord(
            t=torch.where(miss, FLT_MAX, self.t),
            prim=torch.where(miss, -1, self.prim),
            slot=torch.where(miss, -1, self.slot),
            b1=torch.where(miss, 0.0, self.b1),
            b2=torch.where(miss, 0.0, self.b2))


@dataclasses.dataclass
class AnyHitCandidates:
    """One leaf bundle's candidate hits, handed to a custom any-hit program
    (the reference's callAnyHit, radiance.cl:90-102, shader.cl:574-583).

    Arrays are [N, W] (W = leaf bundle width) with `valid` marking the
    real in-window candidates.  A program returns (accept [N, W] bool,
    terminate [N, W] bool): accept=False ignores the candidate (an alpha
    test); an accepted candidate with terminate=True stops the ray after
    this leaf (the reference's anyShadow cont=false).
    """
    t: torch.Tensor            # [N, W] candidate hit distance
    prim: torch.Tensor         # [N, W] primitiveIndex
    b1: torch.Tensor           # [N, W]
    b2: torch.Tensor           # [N, W]
    valid: torch.Tensor        # [N, W] bool: in-window candidate mask
    slot: torch.Tensor         # [N] instance slot (scene.inst_* index)
    sbt_offset: torch.Tensor   # [N] instanceSBTOffset of that slot
    ray_origin: torch.Tensor   # [N, 3] world-space ray
    ray_dir: torch.Tensor      # [N, 3]


def _unpack_node(node_packed, idx):
    """One packed-row gather -> (bmin, bmax, a, count, kind, esc).  Words
    6 and 7 are int32 bit patterns and are read as such, never by value."""
    row = node_packed[idx]                                # [N, 8] f32
    words = row[:, 6:8].contiguous().view(torch.int32)
    meta, esc = words[:, 0], words[:, 1]
    a = meta & META_A_MASK
    count = (meta >> META_COUNT_SHIFT) & 0xF
    kind = (meta >> META_KIND_SHIFT) & 0x3
    return row[:, 0:3], row[:, 3:6], a, count, kind, esc


def _trace_chunk(scene, origin, direction, tmin, tmax,
                 any_hit_terminate: bool, any_hit_program=None) -> HitRecord:
    dev = scene.device
    n = origin.shape[0]
    f32, i32 = torch.float32, torch.int32
    w = scene.bundle_packed.shape[1]
    lanes = torch.arange(w, dtype=i32, device=dev)
    rows = torch.arange(n, device=dev)
    nodes = scene.node_packed

    world_o = origin.to(dev, f32)
    world_d = direction.to(dev, f32)
    world_inv = 1.0 / world_d
    tmin = torch.tensor(tmin, dtype=f32, device=dev)
    tmax = torch.tensor(tmax, dtype=f32, device=dev)

    tidx = torch.zeros(n, dtype=i32, device=dev)
    inst_j = torch.full((n,), -1, dtype=i32, device=dev)
    bidx = torch.full((n,), -1, dtype=i32, device=dev)
    parked_a = torch.full((n,), -1, dtype=i32, device=dev)  # -1: walking
    parked_count = torch.zeros(n, dtype=i32, device=dev)
    pending = torch.zeros(n, dtype=i32, device=dev)
    cur_o, cur_d, cur_inv = world_o, world_d, world_inv
    t = torch.full((n,), FLT_MAX, dtype=f32, device=dev)
    prim = torch.full((n,), -1, dtype=i32, device=dev)
    slot = torch.full((n,), -1, dtype=i32, device=dev)
    b1 = torch.zeros(n, dtype=f32, device=dev)
    b2 = torch.zeros(n, dtype=f32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)

    while True:
        # ---- phase A: UNROLL node steps ----
        for _ in range(UNROLL):
            act = ~done & (parked_a < 0)
            in_blas = act & (bidx >= 0)
            in_leaf = act & ~in_blas & (inst_j >= 0)
            in_tlas = act & ~in_blas & ~in_leaf & (tidx >= 0)
            clip = torch.minimum(t, tmax)

            # BLAS node visit
            b_min, b_max, b_a, b_count, b_kind, b_esc = _unpack_node(
                nodes, torch.where(in_blas, bidx, 0))
            b_inner = b_kind == KIND_INNER
            box_hit = intersect_aabb(cur_o, cur_inv, b_min, b_max,
                                     t_clip=clip)
            # a triangle leaf parks the ray (bundle index + count); the
            # cursor moves on to the escape
            is_tri = in_blas & ~b_inner
            parked_a = torch.where(is_tri, b_a, parked_a)
            parked_count = torch.where(is_tri, b_count, parked_count)
            bidx = torch.where(in_blas,
                               torch.where(b_inner & box_hit, b_a, b_esc),
                               bidx)

            # TLAS node fetch, shared by the instance-leaf and TLAS steps
            t_min_n, t_max_n, t_a, t_count, t_kind, t_esc = _unpack_node(
                nodes, torch.where(in_leaf | in_tlas, tidx, 0))

            # instance-leaf advance: enter the next instance or leave
            entering = in_leaf & (inst_j < t_count)
            exiting = in_leaf & ~entering
            slot_idx = torch.where(entering, t_a + inst_j, 0)
            inv = scene.inst_inv[slot_idx]
            o_l = rmath.mat4_transform_point(inv, world_o)
            d_l = rmath.mat4_transform_dir(inv, world_d)
            em = entering[:, None]
            cur_o = torch.where(em, o_l, cur_o)
            cur_d = torch.where(em, d_l, cur_d)
            cur_inv = torch.where(em, 1.0 / d_l, cur_inv)
            pending = torch.where(entering, slot_idx, pending)
            bidx = torch.where(entering, scene.inst_blas_root[slot_idx], bidx)
            inst_j = torch.where(entering, inst_j + 1,
                                 torch.where(exiting, -1, inst_j))
            tidx = torch.where(exiting, t_esc, tidx)

            # TLAS step (world-ray AABB)
            t_inner = t_kind == KIND_INNER
            t_box = intersect_aabb(world_o, world_inv, t_min_n, t_max_n,
                                   t_clip=clip)
            tidx = torch.where(in_tlas & t_inner,
                               torch.where(t_box, t_a, t_esc), tidx)
            inst_j = torch.where(in_tlas & ~t_inner, 0, inst_j)

        parked = ~done & (parked_a >= 0)
        walking = (~done & (parked_a < 0)
                   & ((bidx >= 0) | (inst_j >= 0) | (tidx >= 0)))
        n_walk, n_park = torch.stack([walking.sum(), parked.sum()]).tolist()
        if n_walk + n_park == 0:
            # nothing alive: the JAX loop's exit test (the steps above
            # changed no ray that was not alive)
            break
        if not (n_walk == 0 or n_park >= max(n_walk, 1)):
            continue

        # ---- phase B: the parked rays' leaf bundles ----
        rowdata = scene.bundle_packed[torch.where(parked, parked_a, 0)]
        v0 = rowdata[:, :, 0:3]
        e1 = rowdata[:, :, 3:6]
        e2 = rowdata[:, :, 6:9]
        pid = rowdata[:, :, 9].contiguous().view(torch.int32)
        valid, tt, tb1, tb2 = intersect_triangle(
            cur_o[:, None, :], cur_d[:, None, :], v0, e1, e2)
        ok = (valid
              & (lanes[None, :] < parked_count[:, None])
              & (tt > tmin) & (tt < tmax)
              & (tt < t[:, None])
              & parked[:, None])
        if any_hit_program is not None:
            sl = torch.clamp(pending, 0, scene.inst_sbt.shape[0] - 1)
            accept, term = any_hit_program(AnyHitCandidates(
                t=tt, prim=pid, b1=tb1, b2=tb2, valid=ok, slot=pending,
                sbt_offset=scene.inst_sbt[sl], ray_origin=world_o,
                ray_dir=world_d))
            ok = ok & accept
            # the ray stops after this bundle
            done = done | (ok & term).any(dim=1)
        tm = torch.where(ok, tt, FLT_MAX)
        j = torch.argmin(tm, dim=1)
        tj = tm[rows, j]
        improved = tj < t
        t = torch.where(improved, tj, t)
        prim = torch.where(improved, pid[rows, j], prim)
        slot = torch.where(improved, pending, slot)
        b1 = torch.where(improved, tb1[rows, j], b1)
        b2 = torch.where(improved, tb2[rows, j], b2)
        if any_hit_terminate:
            done = done | improved
        parked_a = torch.full_like(parked_a, -1)
    return HitRecord(t=t, prim=prim, slot=slot, b1=b1, b2=b2)


def trace_rays(scene, origin: torch.Tensor, direction: torch.Tensor, tmin,
               tmax, any_hit_terminate: bool = False,
               chunk_size: Optional[int] = None,
               any_hit_program=None) -> HitRecord:
    """Trace a wavefront of N rays against the two-level scene.

    origin/direction: [N, 3] float32 (direction need not be normalized),
    moved to the scene's device.  tmin/tmax: the accept window, a hit is
    recorded iff tmin < t < tmax and t improves the ray's best
    (radiance.cl:90-91).  any_hit_terminate: occlusion mode, a ray stops
    at its first accepted hit (shader.cl:567-572).  chunk_size: rays per
    chunk (default config.DEFAULT_RAY_CHUNK).  any_hit_program: a custom
    any-hit shader (AnyHitCandidates) -> (accept [N, W], terminate [N, W])
    evaluated once per leaf bundle; within a bundle every candidate is
    offered before a terminate takes effect.
    """
    n = origin.shape[0]
    chunk = chunk_size or config.DEFAULT_RAY_CHUNK
    if n <= chunk:
        return _trace_chunk(scene, origin, direction, tmin, tmax,
                            any_hit_terminate, any_hit_program)
    pad = (-n) % chunk
    if pad:
        # pad rays reuse the wave's first rays (the JAX module's padding)
        origin = torch.cat([origin, origin[:pad]])
        direction = torch.cat([direction, direction[:pad]])
    recs = [_trace_chunk(scene, origin[i:i + chunk],
                         direction[i:i + chunk], tmin, tmax,
                         any_hit_terminate, any_hit_program)
            for i in range(0, n + pad, chunk)]
    return HitRecord(*(torch.cat([getattr(r, f.name) for r in recs])[:n]
                       for f in dataclasses.fields(HitRecord)))
