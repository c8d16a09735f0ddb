"""Many-instance stream tracing: TLAS-level block culling + an instance
scan over the stream3 single-instance pipeline.

Port of radiance_tpu/ops/stream3_multi.py's instance scan
(trace_rows_multi, :242-399).  A pass over the wave tests every 128-ray
block's world interval frustum against every instance's world AABB (the
TLAS level, [nblk, ninst] slab tests) and builds a compact block list per
instance.  A host loop over the instances, in slot order, then gathers
each instance's active blocks into a sub-wave, runs the stream3 pipeline
(ops/stream3._run: kernels F, B, C, A and D, or E on occlusion waves)
against that instance's own tables, and min-folds the hits into the
running best.  Cost scales with the block/instance overlap, not with the
instance count, unlike the per-instance packet sweeps
(packet_trace.trace_rays_packet_multi).

Differences from the JAX module, none visible in a hit record:
  * the JAX module stacks every unique BLAS's tables padded to one shape,
    so that one compiled lax.scan body serves all instances.  Here each
    unique BLAS keeps its own tables and each instance walks with the
    node count of its own table, which is the same walk;
  * the JAX scan runs every instance on a sub-wave of `bcap` blocks.  Here
    an instance with no overlapping block is not run, and a sub-wave holds
    the instance's blocks rounded up to whole groups of G packets.  The
    dropped packets hold only dead lanes, which emit nothing, so the
    hits, the flags and the poisoning are the reference's;
  * no environment variable is read: the scan route (not
    RADIANCE_MULTI=native), f32; occlusion sub-waves refine their word
    lists before kernel E (stream3._run, the JAX module's
    exact_refine=True), an exact change that no hit can show.

The reference's contract is kept: there is no residual re-walk.  A ray of
a sub-wave packet that was step-capped or word-overflowed, or of a block
that overflowed some instance's `bcap` list, comes back as a miss with
slot == -2 (stream3_multi.py:360-393).  On an occlusion wave such a ray
reads as unoccluded, as in the JAX engine.

Not ported: trace_rows_tlas with _prep_tlas and _glue_tlas (:404-761)
and temporal t-bounds (blk_bound).
"""

from __future__ import annotations

import numpy as np
import torch

from radiance_tpu_torch.ops import stream3 as s3
from radiance_tpu_torch.ops.intersect import FLT_MAX
from radiance_tpu_torch.ops.traversal import HitRecord
from radiance_tpu_torch.ops.stream3_stages import G, group_scalars

BLK = s3.BLK
PKT = s3.PKT
_GROUP_BLOCKS = G * PKT // BLK          # blocks per group of G packets


def supports(scene) -> bool:
    """True when per-BLAS kernel tables exist for every instance."""
    return (getattr(scene, "kblas", None) is not None
            and scene.inst_kblas is not None
            and len(scene.inst_kblas) >= 2)


class MultiTables:
    """Host tables of the instance scan (stream3_multi.py:42-167, the
    scan's fields).

    uniq: the scene's kblas indices of the unique BLASes (sorted);
    inst_idx [ninst] i32: instance slot -> entry of uniq, so copies of a
    mesh share one table; aabb_w [ninst, 6] f32: each instance's world
    AABB, the octant-0 root box's 8 corners under inst_transform (numpy,
    the same arithmetic as the JAX module); aabb_dev: aabb_w on the
    scene's device.  The instance's walk reads scene.kblas[uniq[u]]
    directly (see the module docstring)."""

    def __init__(self, scene):
        self.uniq = tuple(sorted(set(scene.inst_kblas)))
        self.ninst = len(scene.inst_kblas)
        self.refit_aabbs(scene)

    def refit_aabbs(self, scene) -> "MultiTables":
        """Derive the per-slot fields anew from the scene's instance arrays
        (stream3_multi.py:169-189): the world AABBs from the (refitted)
        transforms, and inst_idx from inst_kblas.  The JAX method
        recomputes the AABBs alone; here a refit may also have moved each
        BLAS to another slot (bvh/device.update_tlas).  The per-BLAS tables
        are object-space and stay."""
        u_of = {b: i for i, b in enumerate(self.uniq)}
        self.inst_idx = np.asarray([u_of[b] for b in scene.inst_kblas],
                                   np.int32)
        aabbs = np.zeros((self.ninst, 6), np.float32)
        tf = scene.inst_transform.cpu().numpy()
        for i, bi in enumerate(scene.inst_kblas):
            root = scene.kblas[bi][0][0].cpu().numpy()    # octant-0 root
            lo, hi = root[0:3], root[3:6]
            cs = np.stack(np.meshgrid(*[(lo[k], hi[k])
                                        for k in range(3)]),
                          -1).reshape(-1, 3)
            m = tf[i]
            wc = cs @ m[:3, :3].T + m[:3, 3]
            aabbs[i, 0:3] = wc.min(0)
            aabbs[i, 3:6] = wc.max(0)
        self.aabb_w = aabbs
        self.aabb_dev = torch.from_numpy(aabbs).to(scene.device)
        return self


def multi_tables(scene) -> MultiTables:
    """MultiTables of `scene`, built at its first call and kept on the
    scene (scene.multi), as the JAX engine attaches them
    (attach_multi_tables, _maybe_attach_multi)."""
    if scene.multi is None:
        scene.multi = MultiTables(scene)
    return scene.multi


def _block_overlap(rows_w, aabb_w, tmin, tmax, live=None):
    """[nblk, ninst] bool: does the block's world interval frustum hit the
    instance's world AABB (the conservative slab test of the TLAS level,
    stream3_multi.py:213-239).  With `live`, dead lanes are excluded from
    the block frusta and all-dead blocks overlap nothing."""
    mask = None if live is None else live.reshape(-1, BLK)
    bscal = group_scalars(rows_w, BLK, mask=mask)          # [nblk, 16]
    sgn = bscal[:, None, 0:3]
    olo = bscal[:, None, 3:6]
    ohi = bscal[:, None, 6:9]
    ilo = bscal[:, None, 9:12]
    ihi = bscal[:, None, 12:15]
    lo = aabb_w[None, :, 0:3]
    hi = aabb_w[None, :, 3:6]
    m0 = sgn * lo
    m1 = sgn * hi
    lod = torch.minimum(m0, m1) - ohi
    hid = torch.maximum(m0, m1) - olo
    tn = lod * torch.where(lod >= 0.0, ilo, ihi)
    tf = hid * torch.where(hid >= 0.0, ihi, ilo)
    mixed = sgn == 0.0
    tn = torch.where(mixed, 0.0, tn).amax(dim=2)
    tf = torch.where(mixed, 3.4e38, tf).amin(dim=2)
    tmax_t = torch.tensor(tmax, dtype=torch.float32, device=tf.device)
    tf = torch.minimum(tf, tmax_t)
    return (tf >= torch.clamp(tn, min=0.0)) & (tn < tmax_t)


def trace_rows_multi(scene, mt, rows_w, tmin, tmax, *, bcap_blocks=None,
                     live=None, occl: bool = False, with_diag: bool = False):
    """Many-instance trace of six world-space [N] rows: closest hit, or
    with occl an occlusion wave (t = 0 on occluded rays).

    bcap_blocks: per-instance block capacity (default: a quarter of the
    wave's blocks, at least G packets' worth), rounded up to whole groups
    of G packets.  `live` ([N] bool) masks dead lanes out of the TLAS cull
    and every sub-wave frustum; dead lanes report a miss.  Rays poisoned
    by the reference's contract (module docstring), dead or not, report
    slot == -2.
    With with_diag, returns (rec, diag): "instances_run", "pairs"
    (overlapping (block, instance) pairs), "flagged" (sub-wave packets
    flagged) and "poisoned" (rays)."""
    n = rows_w[0].shape[0]
    dev = rows_w[0].device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    if live is not None:
        live = live.bool()
        rows_w = s3.park_dead(rows_w, live)
    else:
        rows_w = tuple(r.to(f32) for r in rows_w)
    rows_p, live_p = s3._pad_wave(rows_w, live)
    npad = rows_p[0].shape[0]
    nblk = npad // BLK
    if bcap_blocks is None:
        bcap_blocks = max(nblk // 4, _GROUP_BLOCKS)
    bcap = -(-bcap_blocks // _GROUP_BLOCKS) * _GROUP_BLOCKS

    ov = _block_overlap(rows_p, mt.aabb_dev, tmin, tmax, live=live_p)
    # per-instance compact block lists [ninst, bcap] (fill nblk); the
    # mode="drop" scatter of the reference as a masked write
    rank = torch.cumsum(ov.to(i32), dim=0) - 1
    ok = ov & (rank < bcap)
    bi, ii = torch.nonzero(ok, as_tuple=True)
    lists = torch.full((mt.ninst, bcap), nblk, dtype=i64, device=dev)
    lists[ii, rank[bi, ii].to(i64)] = bi
    blk_overflowed = (ov & (rank >= bcap)).any(dim=1)
    n_act = ok.sum(dim=0).tolist()                  # active blocks per inst

    # running best; row npad takes the writes of lanes that take nothing
    bt = torch.full((npad + 1,), FLT_MAX, dtype=f32, device=dev)
    bp = torch.full((npad + 1,), -1, dtype=i32, device=dev)
    bs = torch.full((npad + 1,), -1, dtype=i32, device=dev)
    b1 = torch.zeros(npad + 1, dtype=f32, device=dev)
    b2 = torch.zeros(npad + 1, dtype=f32, device=dev)
    bbad = torch.zeros(npad + 1, dtype=torch.bool, device=dev)
    lane = torch.arange(BLK, device=dev)
    stable = bool(scene.stable_frames)
    runs = flagged = 0
    for i in range(mt.ninst):
        if n_act[i] == 0:
            continue                    # an all-dead sub-wave finds nothing
        runs += 1
        nsub = -(-n_act[i] // _GROUP_BLOCKS) * _GROUP_BLOCKS
        blist = lists[i, :nsub]
        gsel = (torch.clamp(blist, max=nblk - 1)[:, None] * BLK
                + lane).reshape(-1)
        live_i = (blist < nblk).repeat_interleave(BLK)
        if live_p is not None:
            live_i = live_i & live_p[gsel]
        # dead lanes parked far outside the scene, pointing away
        sub = s3.park_dead(tuple(r[gsel] for r in rows_p), live_i,
                           (1.0, 0.0, 0.0))
        nodef, kleaf = scene.kblas[mt.uniq[mt.inst_idx[i]]][:2]
        rec, diag = s3._run(sub, tmin, tmax, nodef, kleaf, scene.inst_inv[i],
                            live=live_i, stable=stable, occl=occl,
                            with_diag=True)
        # a step-capped or word-overflowed sub-packet lost hits for this
        # instance: its rays are poisoned, not returned as silent misses
        pkt_bad = diag["pkt_flag"] > 0
        if with_diag:
            flagged += int(pkt_bad.sum())
        sub_bad = pkt_bad.repeat_interleave(PKT) & live_i
        take = live_i & (rec.t < bt[gsel])  # the earlier instance wins ties
        tgt = torch.where(take, gsel, npad)
        bt[tgt] = rec.t
        bp[tgt] = rec.prim
        bs[tgt] = i
        b1[tgt] = rec.b1
        b2[tgt] = rec.b2
        bbad[torch.where(sub_bad, gsel, npad)] = True
    hit = bt[:n] < FLT_MAX
    bad = blk_overflowed.repeat_interleave(BLK)[:n] | bbad[:n]
    rec = HitRecord(t=torch.where(bad, FLT_MAX, bt[:n]),
                    prim=torch.where(bad, -1, bp[:n]),
                    slot=torch.where(bad, -2, torch.where(hit, bs[:n], -1)),
                    b1=torch.where(bad, 0.0, b1[:n]),
                    b2=torch.where(bad, 0.0, b2[:n]))
    if not with_diag:
        return rec
    return rec, {"instances_run": runs, "pairs": int(ov.sum()),
                 "flagged": flagged, "poisoned": int(bad.sum())}
