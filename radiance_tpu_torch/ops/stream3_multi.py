"""Many-instance stream tracing: TLAS-level block culling with two routes
over the stream3 single-instance pipeline, the instance scan and the
TLAS-native slots.

Port of radiance_tpu/ops/stream3_multi.py.  Both routes start from one
pass over the wave that tests every 128-ray block's world interval
frustum against every instance's world AABB (the TLAS level, [nblk,
ninst] slab tests).

The instance scan (trace_rows_multi, :242-399), the default: each
instance's active blocks are gathered into a sub-wave and moved into the
instance's object space; one run of the stream3 pipeline
(ops/stream3._run: kernels F, B, C, A and D, or E on occlusion waves)
traces every sub-wave, each a segment with the octant slot pool it would
have alone, against the unique BLASes' tables end to end (the native
route's MultiTables.nodef_cat, kleaf_cat, aabb8_cat), each packet walking
its instance's BLAS; where the global leaf rows pass the word format's
reach (supports_native false), one run a BLAS over its instances'
sub-waves, on its own tables.  One min-fold then takes, per ray, the
nearest hit, the lowest instance on a tie, as folding the instances one
by one in slot order would.  Cost scales with the block/instance
overlap, not with the instance count, unlike the per-instance packet
sweeps (packet_trace.trace_rays_packet_multi), and the host's share does
not grow with the instances.

The TLAS-native route (trace_rows_tlas, :574-761; trace_rows_multi with
native=True): every (packet, instance) pair that survives the cull is a
SLOT, its packet's rays moved into the instance's object space.  One
launch each of F, B, C, A and D (or E) then serves every slot of the
wave, against the unique BLASes' tables concatenated with global leaf
ids (MultiTables.nodef_cat, kleaf_cat, aabb8_cat), and a per-ray minimum
over the slots (_glue_tlas) folds the hits.

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
  * the JAX scan traces one instance a step; here the instances share a
    stream3 run, every packet with the slots of its instance's run alone
    (stream3._stage_prep's segments), so the records are those of one run
    per instance (tests/test_torch_multi64_view.py).  On the tables end
    to end a walk's step windows are clamped at the end of nodef_cat, as
    on the native route (below): only a walk cut at STEP_CAP could tell;
  * no environment variable is read: the route is an argument (the
    reference's RADIANCE_MULTI, default scan), so is the native route's
    slot capacity (RADIANCE_TLAS_SCAP); f32, one emit walk a slot (no
    work stealing or treelets, which emit the same words), its step cap
    counted in the compiled walks' 8-row windows with their global clamp
    at the end of nodef_cat (stream3_stages._emit_plain).  Occlusion
    waves refine their word lists before kernel E on both routes
    (stream3._run, the JAX module's exact_refine=True; the JAX native
    route refines closest-hit waves only), an exact change that no hit
    can show;
  * MultiTables.refit_aabbs re-derives every per-slot field from the
    scene's inst_kblas (a refit may move a BLAS to another slot,
    bvh/device.update_tlas); the JAX method recomputes the AABBs alone.

The scan keeps the reference's contract: there is no residual re-walk.
A ray of a sub-wave packet that was step-capped or word-overflowed, or of
a block that overflowed some instance's `bcap` list, comes back as a miss
with slot == -2 (stream3_multi.py:360-393).  On an occlusion wave such a
ray reads as unoccluded, as in the JAX engine.  Under a temporal bound
(below) a poisoned ray whose block bound is finite is re-traced.

The native route re-traces every flagged packet exactly (a slot walk cut
at STEP_CAP, a word list past PCAP, or a packet whose slots did not fit
the pool), so it never returns slot == -2.  The reference re-walks them
with its two-level walk (ops/traversal.py); here they go through the
per-instance packet sweeps (packet_trace.trace_rays_packet_multi: the
CUDA packet kernel on the card, any-hit on occlusion waves with t
normalised to 0 / FLT_MAX), as the stream3 residual does.  Both are exact
tracers; the walk costs a second or more a call on the card whatever its
ray count.

Temporal t-bounds (blk_bound, stream3.py's contract) on both routes: the
bound of a caller-order block is valid inside every instance, so the scan
gives each instance's sub-wave its gathered blocks' bounds (FLT_MAX for
fill blocks) and culls in each stream3._run (stream3_multi.py:298-352),
and the native route culls per storage slot, a slot's 8 sub-blocks being
its packet's 8 blocks (FLT_MAX for pool padding; :669-681).  Each route
then runs the temporal residual over the whole wave (stream3._tb_residual:
:394-398 after the scan's poisoning, :758-760 after the native route's
live mask) through the per-instance packet sweeps, where the reference
re-walks it with its two-level walk; rays past the residual's cap come
back marked slot == -2.

Word format and leaf width: both routes take tq_bits (stream3's; 5..9,
default 9), and every BLAS of a scene shares the scene's leaf cap
(MultiTables.leaf_cap).  A narrower tq reaches more GLOBAL leaf ids:
supports_native(mt, tq_bits) is the reference's check under
RADIANCE_TQ_BITS.
"""

from __future__ import annotations

import numpy as np
import torch

from radiance_tpu_torch.ops import packet_trace
from radiance_tpu_torch.ops import stream3 as s3
from radiance_tpu_torch.ops.intersect import FLT_MAX
from radiance_tpu_torch.ops.stream3 import retrace_flagged
from radiance_tpu_torch.ops.traversal import HitRecord
from radiance_tpu_torch.ops.stream3_stages import (
    BIG, FMAX, G, PCAP, W_LEAF_MAX, W_TQ_BITS, feats_rows_to_major,
    group_scalars, octant_scalars, stage_emit, stage_isect, stage_refine,
    word_format)
from radiance_tpu_torch.utils import profiling

BLK = s3.BLK
PKT = s3.PKT
_GROUP_BLOCKS = G * PKT // BLK          # blocks per group of G packets


def supports(scene) -> bool:
    """True when per-BLAS kernel tables exist for every instance."""
    return (getattr(scene, "kblas", None) is not None
            and scene.inst_kblas is not None
            and len(scene.inst_kblas) >= 2)


class MultiTables:
    """Tables of the two many-instance routes (stream3_multi.py:42-167).

    The scan's: uniq, the scene's kblas indices of the unique BLASes
    (sorted); inst_idx [ninst] i32 (numpy): instance slot -> entry of
    uniq, so copies of a mesh share one table; aabb_w [ninst, 6] f32
    (numpy): each instance's world AABB, the octant-0 root box's 8
    corners under inst_transform (the same arithmetic as the JAX module);
    aabb_dev: aabb_w on the scene's device.  An instance's scan walk reads
    scene.kblas[uniq[u]] directly (see the module docstring).

    The native route's, on the scene's device (:110-152): the unique
    BLASes' tables concatenated unpadded in uniq order, nodef_cat [8 *
    sum nk, 16] f32 with each leaf row's kleaf index (word 8, an f32
    value) rewritten to its GLOBAL row of kleaf_cat [sum nl, 16, 4T] f32,
    so that the single-instance kernels serve every instance; aabb8_cat
    [ceil8(sum nl), 8] f32, the leaf boxes of kernel C; and per slot
    inst_node_off [ninst] i32, the first row of its BLAS in nodef_cat,
    and inst_nk [ninst] i32, its BLAS's rows per octant (an octant's
    table starts at inst_node_off + oct * inst_nk); leaf_cap, the scene's
    (kleaf_cat [sum nl, 16, 4 * leaf_cap])."""

    def __init__(self, scene):
        self.uniq = tuple(sorted(set(scene.inst_kblas)))
        self.ninst = len(scene.inst_kblas)
        self.leaf_cap = scene.leaf_cap
        nodefs = [scene.kblas[b][0] for b in self.uniq]
        kleafs = [scene.kblas[b][1] for b in self.uniq]
        cat, boxes = [], []
        leaf_acc = row_acc = 0
        node_off, nk = [], []
        for nd, kl in zip(nodefs, kleafs):
            glob = nd.clone()
            glob[:, 8] = torch.where(nd[:, 10] > 0,
                                     nd[:, 8] + float(leaf_acc), nd[:, 8])
            cat.append(glob)
            node_off.append(row_acc)
            nk.append(nd.shape[0] // 8)
            rows0 = nd[:nk[-1]]
            l0 = rows0[:, 10] > 0
            ab = torch.zeros(kl.shape[0], 6, dtype=torch.float32,
                             device=nd.device)
            ab[rows0[l0, 8].to(torch.int64)] = rows0[l0, 0:6]
            boxes.append(ab)
            row_acc += nd.shape[0]
            leaf_acc += kl.shape[0]
        self.nodef_cat = torch.cat(cat).contiguous()
        self.kleaf_cat = torch.cat(kleafs).contiguous()
        self.aabb8_cat = torch.zeros(-(-leaf_acc // 8) * 8, 8,
                                     dtype=torch.float32,
                                     device=self.nodef_cat.device)
        self.aabb8_cat[:leaf_acc, :6] = torch.cat(boxes)
        self._node_off_u = np.asarray(node_off, np.int64)
        self._nk_u = np.asarray(nk, np.int64)
        self.refit_aabbs(scene)

    def refit_aabbs(self, scene) -> "MultiTables":
        """Derive the per-slot fields anew from the scene's instance arrays
        (stream3_multi.py:169-189): the world AABBs from the (refitted)
        transforms, and inst_idx, inst_node_off and inst_nk from
        inst_kblas.  The JAX method recomputes the AABBs alone; here a
        refit may also have moved each BLAS to another slot
        (bvh/device.update_tlas).  The per-BLAS tables and their
        concatenation are object-space and stay."""
        u_of = {b: i for i, b in enumerate(self.uniq)}
        self.inst_idx = np.asarray([u_of[b] for b in scene.inst_kblas],
                                   np.int32)
        dev = scene.device
        self.inst_node_off = torch.from_numpy(
            self._node_off_u[self.inst_idx].astype(np.int32)).to(dev)
        self.inst_nk = torch.from_numpy(
            self._nk_u[self.inst_idx].astype(np.int32)).to(dev)
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
        self.aabb_dev = torch.from_numpy(aabbs).to(dev)
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
    tmax_t = torch.full((), tmax, dtype=torch.float32, device=tf.device)
    tf = torch.minimum(tf, tmax_t)
    return (tf >= torch.clamp(tn, min=0.0)) & (tn < tmax_t)


def trace_rows_multi(scene, mt, rows_w, tmin, tmax, *, bcap_blocks=None,
                     live=None, occl: bool = False, with_diag: bool = False,
                     native: bool = False, blk_bound=None,
                     tq_bits: int = W_TQ_BITS):
    """Many-instance trace of six world-space [N] rows: closest hit, or
    with occl an occlusion wave (t = 0 on occluded rays).

    native: take the TLAS-native route (trace_rows_tlas) where
    supports_native(mt, tq_bits) holds, as the reference does under
    RADIANCE_MULTI=native (stream3_multi.py:269-274); its diag is
    trace_rows_tlas's.  tq_bits: the word format's tq width on either
    route.  Otherwise the instance scan:

    bcap_blocks: per-instance block capacity (default: a quarter of the
    wave's blocks, at least G packets' worth), rounded up to whole groups
    of G packets.  `live` ([N] bool) masks dead lanes out of the TLAS cull
    and every sub-wave frustum; dead lanes report a miss.  Rays poisoned
    by the reference's contract (module docstring), dead or not, report
    slot == -2.
    blk_bound ([ceil(N / BLK)] f32, stream3.trace_rows_stream3's): every
    instance's sub-wave culls leaves provably past its blocks' bounds, and
    the rays whose combined result is not definitive (t past the bound,
    unoccluded or poisoned under a finite bound) are re-traced exactly
    through the per-instance packet sweeps, up to stream3's cap; past it
    they are marked slot == -2.
    With with_diag, returns (rec, diag): "instances_run", "pairs"
    (overlapping (block, instance) pairs), "flagged" (sub-wave packets
    flagged) and "poisoned" (rays); with blk_bound also "block_pairs" and
    "block_pairs_bounded" (the (word, block) pairs of all sub-waves before
    and after the cull), "tb_residual", "tb_cap" and "tb_marked"
    (stream3.trace_rows_stream3's).

    Its span, multi.trace, notes "rays" (N), "instances" (mt.ninst),
    "instances_run" (the sub-waves run), "blocks" (the padded wave's
    128-ray blocks), "block_pairs" (the (block, instance) pairs the TLAS
    cull passes, within bcap) and, only while the span is live, since it
    takes a host read, "poisoned" (rays returned with slot == -2).  Its
    child multi.cull holds the cull, the block lists and their host read;
    each sub-wave's stream3 stage spans nest in it, and the gathers and
    the min-fold are its own time."""
    if native and supports_native(mt, tq_bits):
        return trace_rows_tlas(scene, mt, rows_w, tmin, tmax, live=live,
                               occl=occl, with_diag=with_diag,
                               blk_bound=blk_bound, tq_bits=tq_bits)
    with profiling.span("multi.trace") as sp:
        rec, diag, counts = _scan(scene, mt, rows_w, tmin, tmax, bcap_blocks,
                                  live, occl, with_diag, blk_bound, tq_bits)
        if sp.live:
            counts["poisoned"] = _poisoned(rec)
        sp.note(**counts)
    return (rec, diag) if with_diag else rec


def _poisoned(rec) -> int:
    """The rays a trace returned poisoned (slot == -2): a host read."""
    return int((rec.slot == -2).sum())


def _scan(scene, mt, rows_w, tmin, tmax, bcap_blocks, live, occl,
          with_diag, blk_bound, tq_bits):
    """The instance scan of trace_rows_multi: (rec, diag or None, the
    multi.trace span's counts that are on the host without a read)."""
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
    bbv_p = (None if blk_bound is None
             else s3.pad_blk_bound(blk_bound, nblk).to(dev))
    if bcap_blocks is None:
        bcap_blocks = max(nblk // 4, _GROUP_BLOCKS)
    bcap = -(-bcap_blocks // _GROUP_BLOCKS) * _GROUP_BLOCKS

    with profiling.span("multi.cull"):
        ov = _block_overlap(rows_p, mt.aabb_dev, tmin, tmax, live=live_p)
        # per-instance compact block lists [ninst, bcap] (fill nblk); the
        # mode="drop" scatter of the reference, its dropped writes to a
        # spare entry (scanned along the blocks of an instance's contiguous
        # row: torch's scan down the outer dimension of [nblk, ninst] is
        # far slower)
        rank = (torch.cumsum(ov.t().to(i32).contiguous(), dim=1) - 1).t()
        ok = ov & (rank < bcap)
        spare = mt.ninst * bcap
        dst = torch.where(
            ok, torch.arange(mt.ninst, dtype=i64, device=dev) * bcap + rank,
            spare)
        lists = torch.full((spare + 1,), nblk, dtype=i64, device=dev)
        lists.scatter_(0, dst.reshape(-1), torch.arange(
            nblk, dtype=i64, device=dev).repeat_interleave(mt.ninst))
        lists = lists[:spare].view(mt.ninst, bcap)
        blk_overflowed = (ov & (rank >= bcap)).any(dim=1)
        n_act = ok.sum(dim=0).tolist()              # active blocks per inst

    # the sub-waves: each instance's active blocks, moved into its object
    # space, a segment of one stream3 run over the BLASes' tables end to
    # end, or, where their global leaf rows pass the word format's reach,
    # of its own BLAS's run
    runs = sum(a > 0 for a in n_act)
    cat = supports_native(mt, tq_bits)
    plan, s3_runs = _plan(mt, n_act, cat)
    inst_b, pos_b, seg_b = torch.from_numpy(plan).to(dev)
    blist = lists[inst_b, pos_b]
    blk = torch.clamp(blist, max=nblk - 1)
    gsel = (blk[:, None] * BLK + torch.arange(BLK, device=dev)).reshape(-1)
    live_s = (blist < nblk).repeat_interleave(BLK)
    if live_p is not None:
        live_s = live_s & live_p[gsel]
    # dead lanes parked far outside the scene, pointing away
    sub = s3.park_dead(tuple(r[gsel] for r in rows_p), live_s,
                       (1.0, 0.0, 0.0))
    sub = tuple(r.reshape(-1) for r in s3.to_object(
        [r.view(-1, BLK) for r in sub], scene.inst_inv[inst_b][:, None]))
    bb_s = None
    if bbv_p is not None:
        # the sub-wave keeps block granularity: its bounds are the gathered
        # blocks' (the wave's closest-t bound holds inside every instance)
        bb_s = torch.where(blist < nblk, bbv_p[blk], FLT_MAX)
    stable = bool(scene.stable_frames)
    flagged = 0
    bpairs = [0, 0]
    recs, bads = [], []
    for k0, k1, nseg in s3_runs:
        r0, r1 = k0 * BLK, k1 * BLK
        if cat:
            inst_p = inst_b[k0:k1:PKT // BLK]
            nodef, kleaf, aabb8 = mt.nodef_cat, mt.kleaf_cat, mt.aabb8_cat
            tables = (mt.inst_node_off[inst_p], mt.inst_nk[inst_p])
        else:
            u = mt.inst_idx[int(plan[0, k0])]
            nodef, kleaf = scene.kblas[mt.uniq[u]][:2]
            aabb8 = tables = None
        rec, diag = s3._run(
            tuple(r[r0:r1] for r in sub), tmin, tmax, nodef, kleaf, None,
            live=live_s[r0:r1], stable=stable, occl=occl, flags=True,
            blk_bound=None if bb_s is None else bb_s[k0:k1],
            count_pairs=with_diag, tq_bits=tq_bits,
            segments=(seg_b[k0:k1:PKT // BLK], nseg), tables=tables,
            aabb8=aabb8)
        # a step-capped or word-overflowed sub-packet lost hits for its
        # instance: its rays are poisoned, not returned as silent misses
        pkt_bad = diag["pkt_flag"] > 0
        if with_diag:
            flagged += int(pkt_bad.sum())
            if bb_s is not None:
                bpairs[0] += int(diag["block_pairs"])
                bpairs[1] += int(diag["block_pairs_bounded"])
        recs.append(rec)
        bads.append(pkt_bad.repeat_interleave(PKT))
    bt, bp, bs, b1, b2, bbad = _fold(recs, bads, gsel, live_s,
                                     inst_b.repeat_interleave(BLK), npad,
                                     mt.ninst)
    hit = bt[:n] < FLT_MAX
    bad = blk_overflowed.repeat_interleave(BLK)[:n] | bbad[:n]
    rec = HitRecord(t=torch.where(bad, FLT_MAX, bt[:n]),
                    prim=torch.where(bad, -1, bp[:n]),
                    slot=torch.where(bad, -2, torch.where(hit, bs[:n], -1)),
                    b1=torch.where(bad, 0.0, b1[:n]),
                    b2=torch.where(bad, 0.0, b2[:n]))
    tb = {}
    if blk_bound is not None:
        tb = s3._tb_residual(rows_w, rec, blk_bound,
                             _sweeps(scene, tmin, tmax, occl), occl=occl,
                             live=live, n=n)
        tb["block_pairs"], tb["block_pairs_bounded"] = bpairs
    counts = dict(rays=n, instances=mt.ninst, instances_run=runs,
                  blocks=nblk, block_pairs=sum(n_act))
    if not with_diag:
        return rec, None, counts
    return rec, {"instances_run": runs, "pairs": int(ov.sum()),
                 "flagged": flagged, "poisoned": int(bad.sum()),
                 **tb}, counts


def _plan(mt, n_act, one_run):
    """The scan's sub-waves on the host: (plan [3, nb] i64 over the
    sub-wave blocks, run by run and instance by instance within: each
    block's instance, its place in that instance's block list and its
    instance's segment within its run; runs, a (first block, end block,
    segments) per stream3 run: one in all (one_run), else one a BLAS).
    An instance takes its n_act blocks rounded up to whole groups of G
    packets (fill entries name block nblk); one with none is not run."""
    n_act = np.asarray(n_act, dtype=np.int64)
    live = np.flatnonzero(n_act)
    grp = (np.zeros(len(live), np.int64) if one_run
           else np.asarray(mt.inst_idx, np.int64)[live])
    order = np.argsort(grp, kind="stable")
    live, grp = live[order], grp[order]             # run by run
    if not len(live):
        return np.zeros((3, 0), np.int64), []
    nsub = -(-n_act[live] // _GROUP_BLOCKS) * _GROUP_BLOCKS
    end = np.cumsum(nsub)
    first = np.flatnonzero(np.r_[True, grp[1:] != grp[:-1]])   # of a run
    last = np.r_[first[1:], len(live)]
    k = np.arange(len(live)) - np.repeat(first, last - first)
    runs = [(int(end[a] - nsub[a]), int(end[b - 1]), int(b - a))
            for a, b in zip(first, last)]
    return np.stack([np.repeat(live, nsub),
                     np.arange(end[-1]) - np.repeat(end - nsub, nsub),
                     np.repeat(k, nsub)]).astype(np.int64), runs


def _fold(recs, bads, gsel, live, inst, npad, ninst):
    """The sub-waves' records min-folded into wave rows [npad + 1] (row
    npad takes the writes of lanes that take nothing): per ray the least t
    below FLT_MAX among its live lanes, the lowest instance on a tie, as
    folding the instances one by one in slot order with a strict `<`
    would; and the rays any of whose packets were flagged (bads)."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    dev = gsel.device
    t, prim, b1, b2 = (torch.cat([getattr(r, f) for r in recs]) if recs
                       else torch.zeros(0, dtype=d, device=dev)
                       for f, d in (("t", f32), ("prim", i32), ("b1", f32),
                                    ("b2", f32)))
    cand = live & (t < FLT_MAX)
    tk = torch.where(cand, t, FLT_MAX)
    least = torch.full((npad + 1,), FLT_MAX, dtype=f32, device=dev)
    least = least.scatter_reduce(0, gsel, tk, "amin")
    win = cand & (tk == least[gsel])
    first = torch.full((npad + 1,), ninst, dtype=i64, device=dev)
    first = first.scatter_reduce(0, gsel, torch.where(win, inst, ninst),
                                 "amin")
    tgt = torch.where(win & (inst == first[gsel]), gsel, npad)
    bt = torch.full((npad + 1,), FLT_MAX, dtype=f32, device=dev)
    bp = torch.full((npad + 1,), -1, dtype=i32, device=dev)
    bs = torch.full((npad + 1,), -1, dtype=i32, device=dev)
    bb1 = torch.zeros(npad + 1, dtype=f32, device=dev)
    bb2 = torch.zeros(npad + 1, dtype=f32, device=dev)
    bt[tgt], bp[tgt], bs[tgt] = t, prim, inst.to(i32)
    bb1[tgt], bb2[tgt] = b1, b2
    bbad = torch.zeros(npad + 1, dtype=torch.bool, device=dev)
    if bads:
        bbad.index_fill_(0, torch.where(torch.cat(bads) & live, gsel,
                                        npad), True)
    return bt, bp, bs, bb1, bb2, bbad


def _sweeps(scene, tmin, tmax, occl):
    """The exact tracer of both routes' residuals: one packet sweep per
    instance (any-hit on occlusion waves)."""
    def trace(o, d):
        return packet_trace.trace_rays_packet_multi(scene, o, d, tmin, tmax,
                                                    any_hit=occl)
    return trace


# ------------------------------------------------------ TLAS-native slots

def supports_native(mt, tq_bits: int = W_TQ_BITS) -> bool:
    """The native route applies when every GLOBAL leaf id of the
    concatenated tables fits a tq_bits word's leaf field
    (stream3_multi.py:404-412; the same bound as stream3.supports:
    W_LEAF_MAX, doubled by each tq bit given up)."""
    return (mt.kleaf_cat.shape[0] + 1
            < W_LEAF_MAX << (W_TQ_BITS - word_format(tq_bits).tq_bits))


def _prep_tlas(mt, inst_inv, rows_p, tmin, tmax, live_p, scap, *,
               stable: bool):
    """The native route's prep (stream3_multi.py:415-529).  A slot is a
    (packet, instance) pair that survives the TLAS block cull, taken in
    packet-major order into a pool of `scap`; each slot holds its packet's
    rays moved into its instance's object space, dead lanes parked after
    the transform, so the stream3 stages run unchanged over a per-slot
    feature table.

    smeta lanes: 0 the slot's own index (the kernels index the 32-ray
    rows bscal and the refine/isect features through it), 1 alive, 2 its
    octant table's first row in nodef_cat, 3 its packet (npk on an empty
    slot), 4 its instance.  Returns (feats_t [16, scap * PKT], scal, smeta
    (both sorted heavy-walk first, dead slots last), bscal [scap * 32,
    16], order (the stable sort's permutation), pkt_of, inst_of, alive
    (storage order), pool_of [npk] i32: packets with a slot that did not
    fit)."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    dev = rows_p[0].device
    npk = rows_p[0].shape[0] // PKT
    ninst = mt.ninst
    with profiling.span("multi.cull"):
        ov = _block_overlap(rows_p, mt.aabb_dev, tmin, tmax, live=live_p)
        valid0 = ov.view(npk, PKT // BLK, ninst).any(dim=1).reshape(-1)
        rank = torch.cumsum(valid0.to(i64), 0) - 1
        fit = valid0 & (rank < scap)
        pair = torch.arange(npk * ninst, dtype=i64, device=dev)
        pkt_ids, inst_ids = pair // ninst, pair % ninst
        # the reference's mode="drop" scatters: row scap takes the rest
        sidx = torch.where(fit, rank, scap)
        pkt_of = torch.full((scap + 1,), npk, dtype=i32, device=dev)
        pkt_of[sidx] = pkt_ids.to(i32)
        inst_of = torch.zeros(scap + 1, dtype=i32, device=dev)
        inst_of[sidx] = inst_ids.to(i32)
        valid = torch.zeros(scap + 1, dtype=torch.bool, device=dev)
        valid[sidx] = True
        pkt_of, inst_of, valid = pkt_of[:scap], inst_of[:scap], valid[:scap]
        pool_of = torch.zeros(npk, dtype=i32, device=dev).scatter_reduce(
            0, pkt_ids, (valid0 & ~fit).to(i32), "amax")

    pc = torch.clamp(pkt_of, max=npk - 1).to(i64)
    gw = [r.view(npk, PKT)[pc] for r in rows_p]             # [scap, PKT]
    live_s = valid[:, None].expand(scap, PKT)
    if live_p is not None:
        live_s = live_s & live_p.view(npk, PKT)[pc]
    m = inst_inv[inst_of.to(i64)].to(f32)                   # [scap, 4, 4]

    def mc(r, c):
        return m[:, r, c, None]

    # elementwise f32, as the reference: no product may round through TF32
    ox = mc(0, 0) * gw[0] + mc(0, 1) * gw[1] + mc(0, 2) * gw[2] + mc(0, 3)
    oy = mc(1, 0) * gw[0] + mc(1, 1) * gw[1] + mc(1, 2) * gw[2] + mc(1, 3)
    oz = mc(2, 0) * gw[0] + mc(2, 1) * gw[1] + mc(2, 2) * gw[2] + mc(2, 3)
    dx = mc(0, 0) * gw[3] + mc(0, 1) * gw[4] + mc(0, 2) * gw[5]
    dy = mc(1, 0) * gw[3] + mc(1, 1) * gw[4] + mc(1, 2) * gw[5]
    dz = mc(2, 0) * gw[3] + mc(2, 1) * gw[4] + mc(2, 2) * gw[5]
    # parked after the transform: garbage world rays would reach the
    # frusta through inf/nan arithmetic
    rows_o = tuple(torch.where(live_s, v, p).reshape(-1) for v, p in
                   ((ox, BIG), (oy, BIG), (oz, BIG), (dx, 1.0), (dy, 1.0),
                    (dz, 1.0)))
    ox, oy, oz, dx, dy, dz = rows_o
    ones = torch.ones_like(ox)
    zeros = torch.zeros_like(ox)
    if stable:
        # the isect stage computes the ray moment per leaf as (o - c) x d
        mx = my = mz = zeros
    else:
        mx = oy * dz - oz * dy
        my = oz * dx - ox * dz
        mz = ox * dy - oy * dx
    feats_t = torch.stack([dx, dy, dz, mx, my, mz, ox, oy, oz, ones,
                           zeros, zeros, zeros, zeros, zeros, zeros])

    # the slot frusta and their 32-ray sub-frusta: kernel F over the slot
    # rows (its whole-packet scalars are the reference's _group_scalars)
    _, _, scal, bscal = octant_scalars(rows_o, live_s.reshape(-1), scap)
    oct_full = ((scal[:, 0] < 0).to(i32) + 2 * (scal[:, 1] < 0).to(i32)
                + 4 * (scal[:, 2] < 0).to(i32))
    i_of = inst_of.to(i64)
    alive = valid & live_s.any(dim=1)
    smeta = torch.zeros(scap, 8, dtype=i32, device=dev)
    smeta[:, 0] = torch.arange(scap, dtype=i32, device=dev)
    smeta[:, 1] = alive.to(i32)
    smeta[:, 2] = mt.inst_node_off[i_of] + oct_full * mt.inst_nk[i_of]
    smeta[:, 3] = pkt_of
    smeta[:, 4] = inst_of
    # slots sorted by a walk-length proxy, heavy first; dead slots last
    # (stable: jnp.argsort is)
    spread = scal[:, 6:9] - scal[:, 3:6]
    score = (torch.log2(torch.clamp(scal[:, 12:15], 1.0, 1e8)).sum(dim=1)
             + torch.log2(torch.clamp(spread, 1e-3, 1e4)).sum(dim=1))
    score = torch.where(alive, score, -BIG)
    order = torch.argsort(-score, stable=True)
    return (feats_t, scal[order], smeta[order], bscal, order, pkt_of,
            inst_of, alive, pool_of)


def _glue_tlas(out_u, pkt_of, inst_of, alive, npk, n) -> HitRecord:
    """Fold storage-order slot results [scap, PKT, 4] into per-ray winners
    (stream3_multi.py:532-571): t is the minimum over the ray's slots
    (through its float bits), and prim, b1, b2 and the instance each the
    maximum over the slots whose t equals that minimum, field by field
    (the reference's tie rule; exact t ties between two surfaces are
    measure-zero)."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    dev = out_u.device
    kx = torch.where(alive[:, None], out_u[:, :, 0], FMAX).view(i32)
    # row npk takes the dead slots (the reference's mode="drop")
    rows = torch.where(alive, pkt_of, npk).to(i64)[:, None].expand(-1, PKT)
    fmax_bits = torch.tensor(FMAX, dtype=f32).view(i32).item()
    kmin = torch.full((npk + 1, PKT), fmax_bits, dtype=i32, device=dev) \
        .scatter_reduce(0, rows, kx, "amin")[:npk]
    km_g = kmin[torch.clamp(pkt_of, max=npk - 1).to(i64)]
    match = alive[:, None] & (kx == km_g)

    def fold(src, fill):
        init = torch.full((npk + 1, PKT), fill, dtype=src.dtype, device=dev)
        return init.scatter_reduce(0, rows, torch.where(match, src, fill),
                                   "amax")[:npk].reshape(-1)[:n]

    prim = fold(out_u[:, :, 1], -FMAX)
    b1 = fold(out_u[:, :, 2], -FMAX)
    b2 = fold(out_u[:, :, 3], -FMAX)
    inst = fold(inst_of[:, None].expand(-1, PKT), -1)
    t = kmin.view(f32).reshape(-1)[:n]
    hit = (t < FLT_MAX) & (prim >= 0.0)
    return HitRecord(t=torch.where(hit, t, FLT_MAX),
                     prim=torch.where(hit, prim.to(i32), -1),
                     slot=torch.where(hit, inst, -1),
                     b1=torch.where(hit, b1, 0.0),
                     b2=torch.where(hit, b2, 0.0))


def trace_rows_tlas(scene, mt, rows_w, tmin, tmax, *, live=None,
                    occl: bool = False, scap=None, blk_bound=None,
                    with_diag: bool = False, tq_bits: int = W_TQ_BITS):
    """TLAS-native many-instance trace of six world-space [N] rows
    (stream3_multi.py:574-761): closest hit, or with occl an occlusion
    wave (t = 0 on occluded rays).  Check supports_native(mt, tq_bits);
    tq_bits is the word format's tq width.

    One launch each of kernel F (the slot frusta), B (emit over
    nodef_cat), C (refine over aabb8_cat), A (the features, ray-major)
    and D, or E on occlusion waves (over kleaf_cat) serves every (packet,
    instance) slot of the wave; _glue_tlas folds the slots into per-ray
    hits.  scap: the slot pool (default the reference's: every pair when
    npk * ninst is small, else 2 slots a packet, at least 1024), rounded
    up to a multiple of 8 and at least G.  Every packet flagged by the
    pipeline (a slot walk cut at STEP_CAP, a word list past PCAP, a slot
    that did not fit the pool) is re-traced exactly through the
    per-instance packet sweeps (stream3.retrace_flagged), so no ray is
    poisoned.  `live` ([N] bool) masks dead lanes out of the cull and
    every slot frustum; dead lanes report a miss.

    blk_bound ([ceil(N / BLK)] f32, stream3.trace_rows_stream3's): the
    cull per storage slot, a slot's 8 sub-blocks being its packet's 8
    caller-order blocks (FLT_MAX on pool padding), then, after the live
    mask, the temporal residual over the whole wave through the same
    sweeps (stream3._tb_residual; past its cap, rays are marked
    slot == -2).

    With with_diag, returns (rec, diag): "slots_alive", "scap",
    "pool_overflow" (packets with a slot past scap), "flagged" (packets
    re-traced), "residual_rays", "words", "kept_words", "steps" (slot walk
    step windows) and "capped" (slots cut at STEP_CAP); with blk_bound also
    "block_pairs" and "block_pairs_bounded" ((word, block) pairs before
    and after the cull), "tb_residual", "tb_cap" and "tb_marked".

    Its span is trace_rows_multi's, multi.trace, noting "rays",
    "instances" and "blocks", and while it is live "poisoned"; the slot
    construction is its multi.cull."""
    with profiling.span("multi.trace") as sp:
        out = _tlas(scene, mt, rows_w, tmin, tmax, live=live, occl=occl,
                    scap=scap, blk_bound=blk_bound, with_diag=with_diag,
                    tq_bits=tq_bits)
        n = rows_w[0].shape[0]
        # the blocks of the wave padded to whole groups (stream3._pad_wave)
        counts = dict(rays=n, instances=mt.ninst,
                      blocks=-(-n // (G * PKT)) * _GROUP_BLOCKS)
        if sp.live:
            counts["poisoned"] = _poisoned(out[0] if with_diag else out)
        sp.note(**counts)
    return out


def _tlas(scene, mt, rows_w, tmin, tmax, *, live, occl, scap, blk_bound,
          with_diag, tq_bits):
    """trace_rows_tlas without its span."""
    n = rows_w[0].shape[0]
    if live is not None:
        live = live.bool()
        rows_w = s3.park_dead(rows_w, live)
    else:
        rows_w = tuple(r.to(torch.float32) for r in rows_w)
    rows_p, live_p = s3._pad_wave(rows_w, live)
    npk = rows_p[0].shape[0] // PKT
    if scap is None:
        scap = min(npk * mt.ninst, max(npk * 2, 1024))
    scap = max(-(-int(scap) // 8) * 8, G)
    stable = bool(scene.stable_frames)
    (feats_t, scal, smeta, bscal, order, pkt_of, inst_of, alive,
     pool_of) = _prep_tlas(mt, scene.inst_inv[:mt.ninst], rows_p, tmin,
                           tmax, live_p, scap, stable=stable)
    words, emeta = stage_emit(scal, smeta, bscal, mt.nodef_cat, tmax,
                              step_cap=s3.STEP_CAP, pcap=PCAP,
                              tq_bits=tq_bits)
    slot_pkt = smeta[:, 0].contiguous()
    words_i, emeta_i = stage_refine(words, emeta, slot_pkt, feats_t,
                                    mt.aabb8_cat, tmax, pcap=PCAP,
                                    tq_bits=tq_bits)
    words_b = words_i
    if blk_bound is not None:
        # slot_pkt maps word rows to storage slots, as for the refine
        bb8 = s3.pad_blk_bound(blk_bound, npk * (PKT // BLK)).to(
            words.device).reshape(npk, PKT // BLK)
        bb_slot = torch.where((pkt_of < npk)[:, None],
                              bb8[torch.clamp(pkt_of, max=npk - 1).long()],
                              FLT_MAX)
        words_b = s3._apply_block_bound(words_i, slot_pkt,
                                        bb_slot.reshape(-1), tq_bits)
    feats = feats_rows_to_major(feats_t)
    out_s = stage_isect(words_b, emeta_i, slot_pkt, feats, mt.kleaf_cat,
                        tmin, tmax, stable=stable, pcap=PCAP, occl=occl,
                        tq_bits=tq_bits)
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(order.shape[0], device=order.device)
    rec = _glue_tlas(out_s[inv_order], pkt_of, inst_of, alive, npk, n)

    # truncation flags (sorted slot space; smeta lane 3 is the packet)
    alive_s = smeta[:, 1] > 0
    trunc = alive_s & ((emeta[:, 1] > 0) | (emeta[:, 0] > PCAP))
    pkt_flag = torch.zeros(npk + 1, dtype=torch.int32,
                           device=alive_s.device).scatter_reduce(
        0, smeta[:, 3].to(torch.int64), trunc.to(torch.int32), "amax")
    pkt_flag = torch.maximum(pool_of, pkt_flag[:npk])
    sweeps = _sweeps(scene, tmin, tmax, occl)
    n_flag, n_res = retrace_flagged(rec, rows_w, pkt_flag, occl, sweeps)
    if live is not None:
        rec = rec.masked_miss(~live)
    tb = {}
    if blk_bound is not None:
        tb = s3._tb_residual(rows_w, rec, blk_bound, sweeps, occl=occl,
                             live=live, n=n)
    if not with_diag:
        return rec
    a64 = alive_s.to(torch.int64)
    if blk_bound is not None:
        cnt = torch.clamp(emeta_i[:, 0], max=PCAP)
        tb["block_pairs"] = int(s3._kept_pairs(words_i, cnt, alive_s,
                                               tq_bits))
        tb["block_pairs_bounded"] = int(s3._kept_pairs(words_b, cnt,
                                                       alive_s, tq_bits))
    return rec, {
        "slots_alive": int(alive.sum()), "scap": scap,
        "pool_overflow": int((pool_of > 0).sum()),
        "flagged": n_flag, "residual_rays": n_res,
        "words": int((torch.clamp(emeta[:, 0], max=PCAP) * a64).sum()),
        "kept_words": int((torch.clamp(emeta_i[:, 0], max=PCAP)
                           * a64).sum()),
        "steps": int(emeta[:, 2].to(torch.int64).sum()),
        "capped": int(((emeta[:, 1] > 0) & alive_s).sum()), **tb}
