"""Stream tracer v6 (stream3): the closest-hit and occlusion pipelines.

Port of radiance_tpu/ops/stream3.py::trace_rows_stream3 (:2728) and the
stages it runs (`_run`, :2459):

  prep    object-space rows, phase-2 features [16, Npad], 32-ray
          sub-frustum scalars, and the slot tables: a packet whose rays
          share one direction octant is one slot; a mixed packet becomes
          one slot per present octant, drawn from an EXTRA pool.  The
          octant and sub-frustum scalars are kernel F (one pass); the
          rest is plain torch;
  emit    (kernel B) every slot walks the octant node table once with its
          interval frustum and appends one i32 word per overlapped leaf;
  refine  (kernel C) the exact per-ray slab test of every (leaf, 128-ray
          block) pair; empty words are dropped.  Closest-hit and occlusion
          waves both refine: on the card the refine costs less than the
          pairs it drops save kernel E (PERF.md, section 6);
  isect   the Pluecker tests of every kept pair: per-ray closest hit with
          the winner's prim and barycentrics (kernel D), or, on occlusion
          waves, any hit in (tmin, tmax) (kernel E: t = 0 when occluded);
  glue    (plain torch) slot results folded into per-packet winners;
  residual  packets whose walk was cut (STEP_CAP step windows) or whose
          list overflowed (PCAP) are re-traced exactly, ray by ray.

The layout transposes (rows_from_aos_fast, feats_rows_to_major) are
kernel A.  The kernels and their plain versions live in
ops/stream3_stages.py; on CPU tensors every stage runs its plain version.

Differences from the JAX module, none visible in a hit record:
  * the octant scalars take the JAX module's single-pass kernel
    (_oscal_kernel, opt-in there through RADIANCE_PREP_KERNEL=1) on the
    card; the reference states that it is bit-identical to the XLA form
    it runs by default (stream3.py:303-305), which is kernel F's plain
    version, so no hit can change;
  * the residual drain re-walks flagged packets through the packet
    tracer (packet_trace.trace_rays_packet: the CUDA packet kernel on the
    card, any-hit on occlusion waves), where the JAX module uses its
    per-ray traversal walk (ops/traversal.py, whose port costs a second
    or more a call on the card).  Both are exact tracers.  All flagged
    packets drain in one call (the JAX drain runs RES_CAP packets a chunk
    under a while_loop);
  * occlusion waves refine their word lists, the JAX module's
    exact_refine=True (its default skips the refine there, a TPU trade);
    both forms are exact, so no occluded-or-not can change;
  * no environment variable is read: the reference's knobs are keywords
    of _run, trace_rows_stream3 and build_tracer (presort, tqsort for
    RADIANCE_TQSORT, lean for RADIANCE_ISECT_LEAN, cull for kernel D's tq
    occlusion cull), each off by default; the other constants are the
    compiled-TPU defaults: exact refine on closest-hit waves, f32 only,
    the lockstep walk's slot order (one GPU
    warp per slot replaces the TPU's lockstep, treelet and work-stealing
    walks, which all emit the same words);
  * kernel D's tq occlusion cull is off by default (the reference's is
    on): at an exact t tie it can drop a lower lane, so the prim can
    differ there, never t; off, the default route keeps its hits bit for
    bit;
  * the tq word width (the reference's import-time RADIANCE_TQ_BITS) is
    the tq_bits keyword of supports, _run, trace_rows_stream3,
    trace_rows_cascade and build_tracer (5..9, default 9;
    stream3_stages.WordFormat), and the leaf width is the scene's tables'
    (DeviceScene.leaf_cap, the reference's RADIANCE_LEAF_CAP): its LEAF64
    configuration is a scene built with leaf_cap=64 traced at tq_bits=7;
  * the step cap (STEP_CAP) counts 8-row step windows, as the compiled
    treelet walks do (_emit3t_kernel, _emit3wst_kernel; the JAX module's
    default off interpret mode): stream3_stages.stage_emit's step_rows.
    emeta lane 2 counts each slot's own windows (the TPU kernels stamp
    the group's count or the work-stealing loop's), and diag["steps"]
    sums them.

Temporal t-bounds (blk_bound; stream3.py:1749-1801, :2647-2725): a
per-128-ray-block upper bound on t, the previous progressive sample's
worst hit (block_bound_from_t).  Between refine and isect the cull
(_apply_block_bound, plain torch: an elementwise pass over the word
lists, as the reference's XLA glue is) clears the keep bit of every
(word, block) pair whose quantised entry distance lies past the block's
bound, so kernels D and E skip those pairs.  Rays whose result the
bounded trace cannot prove (closest hit: t past the bound; occlusion:
unoccluded under a finite bound) form the temporal residual: the first
max(TB_RES_RAYS, n // 128) of them in index order are re-traced exactly,
the rest marked slot == -2, t = FLT_MAX (the reference's don't-trust
marker).  The residual re-traces through the packet tracer, as the drain
of flagged packets does; the JAX module re-walks it with its per-ray
traversal walk (traversal.trace_rays), which on the card costs a second
or more a call whatever its ray count.  Both are exact.

Ordering modes and kernel forms (stream3.py:222-291, :1703-1737,
:1870-1946, :2411-2456): presort (_block_sort) traces a wave's 128-ray
blocks sorted by their mean rays and restores caller order, its flagged
packets mapped back through diag["blk_perm"]; tqsort orders each refined
list near leaves first (kernel C's sort form); cull skips a (word, block)
pair whose entry bound is at or past every ray's best (kernel D's cull
form); lean leaves the barycentrics out of kernel D and recomputes the
winner's (_winner_barys).  trace_rows_cascade traces a wave first to a
near distance, then its misses over the full window; build_tracer is
trace_rows_stream3 of one scene with its modes fixed (the reference's
_residual_retrace is its flagged drain), without the reference's probe
self-checks.
"""

from __future__ import annotations

import torch

from radiance_tpu_torch.ops import compaction, packet_trace
from radiance_tpu_torch.ops.intersect import FLT_MAX
from radiance_tpu_torch.ops.traversal import HitRecord
from radiance_tpu_torch.ops.stream3_stages import (
    BIG, BLK, EXTRA, FMAX, G, PCAP, PKT, STEP_CAP, W_LEAF_MAX, W_TQ_BITS,
    feats_rows_to_major, lb_bits, octant_scalars, rows_from_aos_fast,
    stage_emit, stage_isect, stage_refine, word_format)
from radiance_tpu_torch.utils import profiling

# the temporal residual's floor: a wave re-traces at most
# max(TB_RES_RAYS, n // 128) rays past their block bounds (stream3.py:65)
TB_RES_RAYS = 16384


def leaf_reach(tq_bits: int = W_TQ_BITS) -> int:
    """The bound leaf + 1 must stay below in a word of tq_bits: W_LEAF_MAX
    (the 9-bit format's, 2^14), doubled by each tq bit given up
    (word_format(tq_bits).leaf_max)."""
    return W_LEAF_MAX << (W_TQ_BITS - word_format(tq_bits).tq_bits)


def supports(scene, tq_bits: int = W_TQ_BITS) -> bool:
    """True when the single-instance stream3 path applies: kernel tables,
    one instance, and every leaf id within a tq_bits word's reach."""
    return (getattr(scene, "knode_f", None) is not None
            and scene.inst_inv.shape[0] == 1
            and scene.kleaf.shape[0] + 1 < leaf_reach(tq_bits))


def rows_from_aos(origin, direction):
    """[N, 3] -> six [N] component rows (column views)."""
    o = origin.to(torch.float32)
    d = direction.to(torch.float32)
    return (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])


def leaf_tables(nodef, n_leaves):
    """(tstart [1, Nl] i32, aabb [Nl, 6] f32) keyed by kleaf row, from
    the octant-0 node rows (leaf meta words 8-11 are f32 values)."""
    nk = nodef.shape[0] // 8
    rows = nodef[:nk]
    isleaf = rows[:, 10] > 0
    idx = torch.where(isleaf, rows[:, 8].to(torch.int64), 0)
    lt = torch.where(isleaf, rows[:, 11].to(torch.int32), 0)
    tstart = torch.zeros(n_leaves, dtype=torch.int32, device=nodef.device)
    tstart = tstart.scatter_reduce(0, idx, lt, "amax")
    box = torch.where(isleaf[:, None], rows[:, 0:6], -FMAX)
    aabb = torch.full((n_leaves, 6), -FMAX, dtype=torch.float32,
                      device=nodef.device)
    aabb = aabb.scatter_reduce(0, idx[:, None].expand(-1, 6), box, "amax")
    return tstart[None, :], aabb


def leaf_aabb8(nodef, n_leaves):
    """Leaf boxes padded to [ceil8(Nl), 8] f32 (kernel C's table)."""
    _, aabb = leaf_tables(nodef, n_leaves)
    nlp = ((n_leaves + 7) // 8) * 8
    out = torch.zeros(nlp, 8, dtype=torch.float32, device=nodef.device)
    out[:n_leaves, :6] = aabb
    return out


# ---------------------------------------------------------------- prep

def _pad_wave(rows_w, live):
    """Pad rows to whole groups of G packets with copies of ray 0; padded
    lanes are not live."""
    n = rows_w[0].shape[0]
    pad = (-n) % (G * PKT)
    if pad:
        rows_w = tuple(torch.cat([r, r[:1].expand(pad)]) for r in rows_w)
        if live is not None:
            live = torch.cat([live, torch.zeros(pad, dtype=torch.bool,
                                                device=live.device)])
    return rows_w, live


def _block_sort(rows_w, live=None):
    """Block presort (stream3.py::_block_sort, :222-291): the wave's
    128-ray blocks stably sorted by a key of their mean rays -- the sign
    octant of the mean direction, then 4-bit-an-axis Morton code of the
    mean direction, then 5-bit-an-axis Morton code of the mean origin,
    each quantised between the wave's block extremes -- so that a
    scattered wave's packets become direction-coherent, and a tile-
    ordered one keeps its order within a cell.  With `live`, dead lanes
    are left out of the means and blocks with no live ray sort last.
    rows_w: six [npad] rows, npad whole blocks.  Returns (sorted rows, inv
    [nb] i64: caller block i's sorted position, sorted live or None).

    A mean is the f32 sum of the block's 128 values over 128 (or over its
    live count), as jnp.mean and jnp.sum / count compute it: the keys then
    equal the JAX module's as long as the two sums round alike
    (tests/test_torch_stream3_modes.py holds them bit-equal)."""
    i32, f32 = torch.int32, torch.float32
    nb = rows_w[0].shape[0] // BLK
    if live is None:
        def bmean(v):
            return v.reshape(nb, BLK).sum(dim=1) / BLK
        nlive = None
    else:
        lv = live.reshape(nb, BLK).to(f32)
        nlive = lv.sum(dim=1)
        denom = torch.clamp(nlive, min=1.0)

        def bmean(v):
            return (v.reshape(nb, BLK) * lv).sum(dim=1) / denom

    dmean = [bmean(rows_w[3 + k].to(f32)) for k in range(3)]
    omean = [bmean(rows_w[k].to(f32)) for k in range(3)]
    oct_b = ((dmean[0] < 0).to(i32) + 2 * (dmean[1] < 0).to(i32)
             + 4 * (dmean[2] < 0).to(i32))

    def norm_q(ms, bits):
        top = (1 << bits) - 1
        out = []
        for m in ms:
            lo, hi = m.amin(), m.amax()
            q = ((m - lo) / torch.clamp(hi - lo, min=1e-6) * top).to(i32)
            out.append(torch.clamp(q, 0, top))
        return out

    def spread2(v):
        # 8 bits interleaved with 2-bit gaps (a Morton component)
        v = (v | (v << 8)) & 0x0F00F
        v = (v | (v << 4)) & 0xC30C3
        return (v | (v << 2)) & 0x249249

    dq = norm_q(dmean, 4)
    oq = norm_q(omean, 5)
    dmorton = (spread2(dq[0]) | (spread2(dq[1]) << 1)
               | (spread2(dq[2]) << 2)) & 0xFFF
    omorton = (spread2(oq[0]) | (spread2(oq[1]) << 1)
               | (spread2(oq[2]) << 2)) & 0x7FFF
    key = (oct_b << 27) | (dmorton << 15) | omorton
    if nlive is not None:
        key = torch.where(nlive > 0, key, 2 ** 31 - 1)
    perm = torch.argsort(key, stable=True)
    inv = compaction.invert_perm(perm)
    rows_s = tuple(r.reshape(nb, BLK)[perm].reshape(-1) for r in rows_w)
    live_s = None if live is None else live.reshape(nb, BLK)[perm].reshape(-1)
    return rows_s, inv, live_s


def to_object(rows_w, m):
    """Six world-space rows moved to object space by the inverse transform
    m: one [4, 4] matrix for every ray, or [..., 4, 4] whose m[..., r, k]
    broadcast against the rows (a matrix a block); the same f32 products
    and sums either way.  m None: the rows are in object space already."""
    f32 = torch.float32
    ox_w, oy_w, oz_w, dx_w, dy_w, dz_w = (r.to(f32) for r in rows_w)
    if m is None:
        return ox_w, oy_w, oz_w, dx_w, dy_w, dz_w
    m = m.to(f32)

    def e(r, k):
        return m[..., r, k]

    return (e(0, 0) * ox_w + e(0, 1) * oy_w + e(0, 2) * oz_w + e(0, 3),
            e(1, 0) * ox_w + e(1, 1) * oy_w + e(1, 2) * oz_w + e(1, 3),
            e(2, 0) * ox_w + e(2, 1) * oy_w + e(2, 2) * oz_w + e(2, 3),
            e(0, 0) * dx_w + e(0, 1) * dy_w + e(0, 2) * dz_w,
            e(1, 0) * dx_w + e(1, 1) * dy_w + e(1, 2) * dz_w,
            e(2, 0) * dx_w + e(2, 1) * dy_w + e(2, 2) * dz_w)


def _pool_rank(flat, pkt_ids, segments):
    """Rank of each set entry of `flat` ([npk * 8] bool, packet-major)
    among the set entries of its segment: the wave's when segments is
    None, else of its sub-wave (segments: pkt_seg [npk] i64, nondecreasing,
    and their count)."""
    rank = torch.cumsum(flat.to(torch.int64), 0) - 1
    if segments is None:
        return rank
    pkt_seg, nseg = segments
    cnt = flat.view(-1, 8).sum(dim=1)
    before = torch.cumsum(cnt, 0) - cnt          # set entries before a packet
    base = torch.zeros(nseg, dtype=torch.int64, device=flat.device)
    base = base.scatter_reduce(0, pkt_seg, before, "amin", include_self=False)
    return rank - base[pkt_seg][pkt_ids]


def _stage_prep(rows_w, nodef, inv0, live=None, *, stable: bool,
                segments=None, tables=None):
    """Object-space rows, phase-2 features [16, Npad], sub-block scalars
    and the slot tables (stream3.py::_stage_prep, :449-590).

    `live` ([N] bool) drops dead lanes from every interval frustum;
    packets with no live ray get no active slot.  inv0: to_object's m.
    segments (pkt_seg [npk] i64, nondecreasing, and their count nseg): the
    wave is nseg sub-waves of whole packets, each with an EXTRA pool of
    its own, so that every packet gets the slots it would get in a wave of
    its sub-wave alone.  tables (base [npk] i32, nk [npk] i32): nodef is
    several BLASes' tables end to end (MultiTables.nodef_cat), a packet's
    octant o table starting at row base + o * nk; None: nodef is one
    BLAS's.  Returns (rows, feats_t, scal [nslot, 16] f32,
    smeta [nslot, 8] i32 (lanes 0 packet, 1 alive, 2 node-table base row),
    bscal [npk*32, 16] f32, order [nslot] i64): slots sorted heavy-walk
    first, order the stable sort permutation."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    rows_w, live = _pad_wave(rows_w, live)
    rows = to_object(rows_w, inv0)
    ox, oy, oz, dx, dy, dz = rows
    dev = ox.device
    npad = ox.shape[0]
    npk = npad // PKT
    nk_local = nodef.shape[0] // 8

    def table_row(pkt, octant):
        """The first row of packet pkt's octant table in nodef."""
        if tables is None:
            return octant * nk_local
        return tables[0][pkt] + octant * tables[1][pkt]

    ones = torch.ones(npad, dtype=f32, device=dev)
    zeros = torch.zeros(npad, dtype=f32, device=dev)
    if stable:
        # the isect stage computes the ray moment per leaf as (o - c) x d
        mx = my = mz = zeros
    else:
        mx = oy * dz - oz * dy
        my = oz * dx - ox * dz
        mz = ox * dy - oy * dx
    feats_t = torch.stack([dx, dy, dz, mx, my, mz, ox, oy, oz, ones,
                           zeros, zeros, zeros, zeros, zeros, zeros])

    # ----- slot construction -----
    # octant, whole-packet and 32-ray sub-frustum scalars (bscal: sub s
    # of block j at row s*8 + j of its packet), one pass of kernel F
    cand, present, full_pkt, bscal = octant_scalars(
        rows, None if live is None else live.contiguous(), npk)
    pure = present.sum(dim=1) == 1
    oct_idx = torch.argmax(present.to(i32), dim=1)
    full = torch.where(pure[:, None],
                       cand[torch.arange(npk, device=dev), oct_idx],
                       full_pkt)
    oct_full = ((full[:, 0] < 0).to(i32) + 2 * (full[:, 1] < 0).to(i32)
                + 4 * (full[:, 2] < 0).to(i32))

    nseg = 1 if segments is None else segments[1]
    nslot = npk + nseg * EXTRA
    # row nslot takes the octant writes that do not fit (mode="drop")
    scal = torch.zeros(nslot + 1, 16, dtype=f32, device=dev)
    scal[:npk] = torch.where(pure[:, None], full, 0.0)
    smeta = torch.zeros(nslot + 1, 8, dtype=i32, device=dev)
    smeta[:npk, 0] = torch.arange(npk, dtype=i32, device=dev)
    smeta[:npk, 1] = pure.to(i32)
    smeta[:npk, 2] = table_row(slice(None), oct_full)

    # octant sub-slots: a mixed packet takes them only if ALL its octants
    # fit in the pool, else its base slot walks the whole-packet frustum
    valid0 = (~pure)[:, None] & present                    # [npk, 8]
    pkt_ids = torch.arange(npk, dtype=i64, device=dev).repeat_interleave(8)
    rank0 = _pool_rank(valid0.reshape(-1), pkt_ids, segments)
    maxrank = torch.full((npk,), -1, dtype=i64, device=dev).scatter_reduce(
        0, pkt_ids, torch.where(valid0.reshape(-1), rank0, -1), "amax")
    fits = (~pure) & (maxrank < EXTRA)
    vflat = valid0.reshape(-1) & fits[pkt_ids]
    rank = _pool_rank(vflat, pkt_ids, segments)
    fit = vflat & (rank < EXTRA)
    if segments is not None:
        rank = segments[0][pkt_ids] * EXTRA + rank   # the sub-wave's pool
    slot_of = torch.where(fit, npk + rank, nslot)
    oct_ids = torch.arange(8, dtype=i32, device=dev).repeat(npk)
    scal[slot_of] = cand.reshape(-1, 16)
    smeta[slot_of, 0] = pkt_ids.to(i32)
    smeta[:, 1].index_fill_(0, slot_of, 1)     # no scalar upload
    smeta[slot_of, 2] = table_row(pkt_ids, oct_ids)
    scal, smeta = scal[:nslot], smeta[:nslot]

    conserv = (~pure) & (~fits)
    scal[:npk] = torch.where(conserv[:, None], full, scal[:npk])
    smeta[:npk, 1] = torch.maximum(smeta[:npk, 1], conserv.to(i32))
    # slots sorted by a walk-length proxy, heavy first; dead slots last
    # (stable: jnp.argsort is)
    spread = scal[:, 6:9] - scal[:, 3:6]
    score = (torch.log2(torch.clamp(scal[:, 12:15], 1.0, 1e8)).sum(dim=1)
             + torch.log2(torch.clamp(spread, 1e-3, 1e4)).sum(dim=1))
    score = torch.where(smeta[:, 1] > 0, score, -BIG)
    order = torch.argsort(-score, stable=True)
    return rows, feats_t, scal[order], smeta[order], bscal, order


# ----------------------------------------------------------------- glue

def _stage_glue(out_s, smeta, npk, n) -> HitRecord:
    """Fold storage-order slot results [nslot, PKT, 4] into per-ray
    winners (stream3.py::_stage_glue, :2353-2406): base slot p is packet
    p; an extra (octant) slot's row min-folds into its packet, ties to
    the base slot."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    t_all = out_s[:, :, 0]
    alive = smeta[:, 1] > 0
    kb = torch.where(alive[:npk, None], t_all[:npk], FMAX).view(i32)
    ex_pkt = smeta[npk:, 0].to(i64)
    keep = (ex_pkt >= 0) & (ex_pkt < npk)           # mode="drop"
    ex_alive = alive[npk:] & keep       # (a dead extra slot takes nothing)
    ex_pkt, ex = torch.where(keep, ex_pkt, 0), out_s[npk:]
    kx = torch.where(ex_alive[:, None], ex[:, :, 0], FMAX).view(i32)
    rows = ex_pkt[:, None].expand(-1, PKT)
    kmin = kb.scatter_reduce(0, rows, kx, "amin")
    t = kmin.view(f32)
    take = ex_alive[:, None] & (kx == kmin[ex_pkt])

    def fold(lane, fill, base):
        ext = torch.full((npk, PKT), fill, dtype=f32, device=out_s.device)
        ext = ext.scatter_reduce(0, rows, torch.where(take, ex[:, :, lane],
                                                      fill), "amax")
        return torch.where(kmin == kb, base, ext)

    prim_f = fold(1, -FMAX, torch.where(alive[:npk, None], out_s[:npk, :, 1],
                                        -1.0))
    b1_f = fold(2, 0.0, out_s[:npk, :, 2])
    b2_f = fold(3, 0.0, out_s[:npk, :, 3])
    t, prim, b1, b2 = (v.reshape(-1)[:n] for v in (t, prim_f, b1_f, b2_f))
    hit = (t < FLT_MAX) & (prim >= 0.0)
    return HitRecord(t=torch.where(hit, t, FLT_MAX),
                     prim=torch.where(hit, prim.to(i32), -1),
                     slot=torch.where(hit, 0, -1).to(i32),
                     b1=torch.where(hit, b1, 0.0),
                     b2=torch.where(hit, b2, 0.0))


# ------------------------------------------------------ temporal t-bounds

def block_bound_from_t(t, slack: float = 1.02, eps: float = 1e-2):
    """Per-block temporal bound from a previous sample's hit t ([n] f32,
    FLT_MAX = miss) -> [ceil(n / BLK)] f32 for blk_bound
    (stream3.py:1780-1801): each block's largest t * slack + eps, in f32
    and in that order; a block holding a miss gets FLT_MAX (a miss cannot
    be bounded).  The slack trades cull volume against residual volume;
    exactness does not depend on it."""
    f32 = torch.float32
    t = t.to(f32)
    pad = (-t.shape[0]) % BLK
    if pad:
        t = torch.cat([t, torch.full((pad,), FLT_MAX, dtype=f32,
                                     device=t.device)])
    b = torch.where(t < FLT_MAX,
                    t * torch.tensor(slack, dtype=f32, device=t.device)
                    + torch.tensor(eps, dtype=f32, device=t.device),
                    FLT_MAX)
    return b.reshape(-1, BLK).amax(dim=1)


def pad_blk_bound(bbv, nblk):
    """Caller-order block bounds padded to `nblk` wave blocks with FLT_MAX
    (padding blocks hold copies of ray 0; an infinite bound culls nothing
    there; stream3.py:2647-2656)."""
    bbv = torch.as_tensor(bbv, dtype=torch.float32)
    if bbv.shape[0] < nblk:
        bbv = torch.cat([bbv, torch.full((nblk - bbv.shape[0],), FLT_MAX,
                                         dtype=torch.float32,
                                         device=bbv.device)])
    return bbv


def _apply_block_bound(words, slot_pkt, bounds_blk, tq_bits=W_TQ_BITS):
    """The temporal cull (stream3.py:1749-1777): clear the keep bit of
    every (word, block) pair whose leaf's quantised entry-distance lower
    bound, lb_bits (0 where tq == 0) in the format of tq_bits, exceeds
    the block's bound.  words [nslot, PCAP] i32, slot_pkt [nslot]
    (the packet whose 8 blocks a slot's keep bits name), bounds_blk
    [npk * 8] f32.  Bounds compare as the int32 bits of min(|b|, FLT_MAX),
    which order as the positive floats do.  A NaN bound stays NaN, as
    jnp.minimum keeps it, with the bits of |b| (torch.minimum's NaN on
    the CPU has all bits set, which as int32 would cull every pair): a
    positive NaN's bits cull nothing.  Zero words stay zero; a word whose
    keep mask empties keeps its place in the list."""
    i32 = torch.int32
    fmt = word_format(tq_bits)
    lb = lb_bits(words, tq_bits)
    fmax = torch.tensor(FLT_MAX, dtype=torch.float32, device=words.device)
    b = bounds_blk.to(torch.float32).abs()
    bb = torch.where(torch.isnan(b), b, torch.minimum(b, fmax)).view(i32)
    sb = bb.reshape(-1, 8)[slot_pkt.to(torch.int64)]           # [nslot, 8]
    kmask = fmt.keep(words)
    keep = torch.zeros_like(kmask)
    for k in range(8):
        ok = lb <= sb[:, k:k + 1]
        keep = keep | torch.where(ok, kmask & (1 << k), 0)
    return torch.where(words != 0,
                       (words & ~(255 << fmt.keep_shift))
                       | (keep << fmt.keep_shift),
                       words)


_POP8 = [bin(v).count("1") for v in range(256)]


def _kept_pairs(words, cnt, alive, tq_bits=W_TQ_BITS):
    """(word, 128-ray block) pairs a list names: the keep bits of the
    first min(cnt, PCAP) words of every alive slot, summed ([] i64)."""
    pop = torch.tensor(_POP8, dtype=torch.int64, device=words.device)
    pos = torch.arange(words.shape[1], device=words.device)
    used = (pos[None, :] < cnt[:, None]) & alive[:, None]
    kmask = word_format(tq_bits).keep(words).to(torch.int64)
    return torch.where(used, pop[kmask], 0).sum()


def _tb_residual(rows_w, rec, blk_bound, trace, *, occl: bool, live,
                 n: int):
    """The temporal residual (stream3.py:2659-2725), on `rec` in place:
    the rays whose result is not definitive under their block's bound
    (closest hit: t past the bound; occlusion: unoccluded under a finite
    bound), among the `live` ones, are re-traced exactly by
    trace(origin [k, 3], direction [k, 3]) -> HitRecord, the first
    min(n, max(TB_RES_RAYS, n // 128)) of them in index order (the
    reference's jnp.nonzero(size=cap)); the rest are marked slot = -2,
    t = FLT_MAX, prim = -1, b = 0: the reference's don't-trust marker,
    never a plain miss (on an occlusion wave a miss reads as unoccluded).
    On occlusion waves the re-traced t is normalised to 0 / FLT_MAX.
    Returns {"tb_residual": rays re-traced, "tb_cap": the cap,
    "tb_marked": rays marked -2}."""
    cap = min(n, max(TB_RES_RAYS, n // 128))
    bound = pad_blk_bound(blk_bound, -(-n // BLK)).to(rec.t.device)
    bound_ray = bound.repeat_interleave(BLK)[:n]
    if occl:
        resid = (rec.t >= FLT_MAX) & (bound_ray < FLT_MAX)
    else:
        resid = rec.t > bound_ray
    if live is not None:
        resid = resid & live[:n]
    idx = torch.nonzero(resid).squeeze(1)
    take, late = idx[:cap], idx[cap:]
    if take.numel():
        patch_retraced(rec, take,
                       trace(torch.stack([r[take] for r in rows_w[:3]], 1),
                             torch.stack([r[take] for r in rows_w[3:]], 1)),
                       occl)
    if late.numel():
        rec.t[late] = FLT_MAX
        rec.prim[late] = -1
        rec.slot[late] = -2
        rec.b1[late] = 0.0
        rec.b2[late] = 0.0
    return {"tb_residual": int(take.numel()), "tb_cap": cap,
            "tb_marked": int(late.numel())}


# ----------------------------------------------------------------- run

def _winner_barys(rows_w, inv0, kprim, ktri_geo, prim, t, n):
    """The winners' (b1, b2) of a lean wave (stream3.py::_winner_barys,
    :2411-2456): Moeller-Trumbore on the first n rays of the world-space
    rows, moved to object space per component, against the winning
    triangle's ktri_geo row (v0, e1, e2).  ktri_geo is indexed by kernel
    face, prim is the primitive id (kleaf row 10), so the gather goes
    through the inverse of kprim; its padding rows (-1) land on the last
    face, which no primitive id reaches.  Misses get (0, 0)."""
    i64 = torch.int64
    nf = kprim.shape[0]
    kp = kprim.to(i64)
    idx = torch.where(kp >= 0, kp, nf - 1)
    iprim = torch.zeros(nf, dtype=i64, device=kprim.device)
    iprim[idx] = torch.arange(nf, dtype=i64, device=kprim.device)
    hit = (t < FLT_MAX) & (prim >= 0)
    geo = ktri_geo[iprim[torch.clamp(prim.to(i64), 0, nf - 1)]]
    ox, oy, oz, dx, dy, dz = to_object([r[:n] for r in rows_w[:6]], inv0)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = geo.unbind(1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    inv_det = 1.0 / (e1x * px + e1y * py + e1z * pz)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    b1 = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    b2 = (dx * qx + dy * qy + dz * qz) * inv_det
    return torch.where(hit, b1, 0.0), torch.where(hit, b2, 0.0)


def _run(rows_w, tmin, tmax, nodef, kleaf, inv0, *, live=None,
         stable: bool, occl: bool = False, with_diag: bool = False,
         flags: bool = False, blk_bound=None, count_pairs: bool = False,
         presort: bool = False, tqsort: bool = False, lean: bool = False,
         cull: bool = False, kprim=None, ktri_geo=None,
         tq_bits: int = W_TQ_BITS, segments=None, tables=None,
         aabb8=None):
    """The pipeline on world-space component rows (stream3.py::_run,
    non-work-stealing branch), moved to object space by inv0 (to_object's
    m; None: the rows are in object space).  segments and tables:
    _stage_prep's, the instance scan's sub-waves of whole groups each with
    its octant pool, and the BLAS tables end to end with each packet's
    BLAS (MultiTables: nodef_cat, kleaf_cat with global leaf rows, and
    their leaf boxes aabb8, aabb8_cat; default leaf_aabb8 of nodef).
    Returns a HitRecord, and with with_diag
    (rec, diag): diag["pkt_flag"] [npk] i32 marks packets whose walk was
    cut or whose list overflowed -- the caller must re-trace them --
    beside the sums "words", "kept_words", "steps" and "capped"; flags
    alone returns (rec, diag) without the sums (the residual's needs:
    "pkt_flag", "blk_perm" and count_pairs' keys).  Dead
    lanes of `live` come back as garbage for the caller to mask.  occl
    runs an occlusion wave: kernel E, t = 0 on occluded rays (prim 0, no
    barycentrics).  Kernel C refines the word lists of both kinds of wave
    (on occlusion waves the JAX module's exact_refine=True,
    stream3.py:2536-2543; its default, a TPU trade, skips it there).
    blk_bound ([ceil(n / BLK)] f32, caller-order blocks): the temporal
    cull between refine and isect (stream3.py:2555-2561); the caller owns
    the residual (_tb_residual).  With it and count_pairs, diag also holds
    "block_pairs" and "block_pairs_bounded", the (word, block) pairs of
    the refined lists before and after the cull.

    The reference's ordering modes, each off by default: presort traces
    the wave's blocks in _block_sort's order (bounds mapped into sorted
    block space, the record restored to caller order; diag["pkt_flag"] is
    then in sorted packet space and diag["blk_perm"] maps a sorted block
    to its caller block); tqsort runs kernel C's tq-sort form (the
    reference's RADIANCE_TQSORT); lean runs kernel D's lean form and
    recomputes the winners' barycentrics from ktri_geo through kprim
    (_winner_barys; RADIANCE_ISECT_LEAN); cull runs D's tq occlusion cull
    (the reference's default, stream3.py:1935-1946).  lean and cull apply
    to closest-hit waves only.  tq_bits: the word format's tq width (5..9;
    kleaf's leaves must be within its reach, supports())."""
    n = rows_w[0].shape[0]
    lean = lean and not occl
    if lean and (kprim is None or ktri_geo is None):
        raise ValueError("_run(lean=True) needs kprim and ktri_geo")
    with profiling.span("stream3.prep"):
        rows_w, live = _pad_wave(rows_w, live)
        rows_keep = rows_w      # caller order, for the lean barycentrics
        nb = rows_w[0].shape[0] // BLK
        inv_blk = None
        if presort:
            rows_w, inv_blk, live = _block_sort(rows_w, live)
        rows, feats_t, scal, smeta, bscal, order = _stage_prep(
            rows_w, nodef, inv0, live=live, stable=stable,
            segments=segments, tables=tables)
        npad = rows[0].shape[0]
        npk = npad // PKT
    with profiling.span("stream3.emit"):
        words, emeta = stage_emit(scal, smeta, bscal, nodef, tmax,
                                  step_cap=STEP_CAP, pcap=PCAP,
                                  tq_bits=tq_bits)
    with profiling.span("stream3.refine"):
        slot_pkt = smeta[:, 0].contiguous()
        if aabb8 is None:
            aabb8 = leaf_aabb8(nodef, kleaf.shape[0])
        words_i, emeta_i = stage_refine(
            words, emeta, slot_pkt, feats_t, aabb8, tmax, pcap=PCAP,
            sort=tqsort, tq_bits=tq_bits)
        words_b = words_i
        if blk_bound is not None:
            bbv = pad_blk_bound(blk_bound, nb)
            if presort:
                # caller-order bounds -> sorted block space
                bbv_s = torch.empty_like(bbv)
                bbv_s[inv_blk.to(bbv.device)] = bbv
                bbv = bbv_s
            words_b = _apply_block_bound(words_i, slot_pkt, bbv, tq_bits)
    with profiling.span("stream3.isect"):
        feats = feats_rows_to_major(feats_t)
        out_s = stage_isect(words_b, emeta_i, slot_pkt, feats, kleaf, tmin,
                            tmax, stable=stable, pcap=PCAP, occl=occl,
                            lean=lean, cull=cull and not occl,
                            tq_bits=tq_bits)
    with profiling.span("stream3.glue"):
        # back to storage order (slot p == packet p for base slots)
        inv_order = torch.empty_like(order)
        inv_order[order] = torch.arange(order.shape[0], device=order.device)
        smeta_u = torch.empty_like(smeta)
        smeta_u[order] = smeta
        rec = _stage_glue(out_s[inv_order], smeta_u, npk, npad)
        if presort:             # back to caller ray order
            rec = HitRecord(*(getattr(rec, f).reshape(nb, BLK)[inv_blk]
                              .reshape(-1)[:n]
                              for f in ("t", "prim", "slot", "b1", "b2")))
        else:
            rec = HitRecord(t=rec.t[:n], prim=rec.prim[:n],
                            slot=rec.slot[:n], b1=rec.b1[:n], b2=rec.b2[:n])
        if lean:
            rec.b1, rec.b2 = _winner_barys(rows_keep, inv0, kprim, ktri_geo,
                                           rec.prim, rec.t, n)
        if not (with_diag or flags):
            return rec
        alive = smeta[:, 1] > 0
        trunc = alive & ((emeta[:, 1] > 0) | (emeta[:, 0] > PCAP))
        pkt_flag = torch.zeros(npk, dtype=torch.int32,
                               device=alive.device).scatter_reduce(
            0, smeta[:, 0].to(torch.int64), trunc.to(torch.int32), "amax")
        if presort:             # sorted block -> caller block
            blk_perm = compaction.invert_perm(inv_blk)
        else:
            blk_perm = torch.arange(nb, dtype=torch.int64,
                                    device=alive.device)
        diag = {"pkt_flag": pkt_flag, "blk_perm": blk_perm}
    if with_diag:
        a64 = alive.to(torch.int64)
        diag.update(
            words=(torch.clamp(emeta[:, 0], max=PCAP) * a64).sum(),
            kept_words=(torch.clamp(emeta_i[:, 0], max=PCAP) * a64).sum(),
            steps=emeta[:, 2].to(torch.int64).sum(),
            capped=((emeta[:, 1] > 0) & alive).sum())
    if blk_bound is not None and count_pairs:
        cnt = torch.clamp(emeta_i[:, 0], max=PCAP)
        diag["block_pairs"] = _kept_pairs(words_i, cnt, alive, tq_bits)
        diag["block_pairs_bounded"] = _kept_pairs(words_b, cnt, alive,
                                                  tq_bits)
    return rec, diag


def park_dead(rows_w, live, park_dir=(1.0, 1.0, 1.0)):
    """Six f32 rows with the dead lanes of `live` replaced by a ray far
    outside any scene (origin 1e30, direction park_dir), so that dead
    lanes holding NaN/Inf stay finite in every stage."""
    fill = (BIG, BIG, BIG) + tuple(park_dir)
    return tuple(torch.where(live, r.to(torch.float32), f)
                 for r, f in zip(rows_w, fill))


def retrace_flagged(rec, rows_w, pkt_flag, occl, trace, blk_perm=None):
    """The residual: re-trace exactly every ray (of the first N of the
    six world-space rows) of the packets flagged in pkt_flag ([npk]), by
    trace(origin [k, 3], direction [k, 3]) -> HitRecord, and patch them
    into rec in place.  With blk_perm (a presorted wave's: sorted block ->
    caller block), pkt_flag is in sorted packet space and each flagged
    packet's blocks are mapped back to the caller's (stream3.py:2786-
    2806).  On occlusion waves (occl, trace any-hit) t is normalised to
    0 / FLT_MAX, as stream3.py:2815-2821 does.  Returns (packets flagged,
    rays re-traced)."""
    n = rows_w[0].shape[0]
    flagged = torch.nonzero(pkt_flag > 0).squeeze(1)
    if flagged.numel() == 0:
        return 0, 0
    dev = flagged.device
    nsub = PKT // BLK
    blocks = (flagged[:, None] * nsub
              + torch.arange(nsub, device=dev)).reshape(-1)
    if blk_perm is not None:
        blocks = blk_perm.to(dev)[blocks]
    sel = (blocks[:, None] * BLK
           + torch.arange(BLK, device=dev)).reshape(-1)
    sel = sel[sel < n]
    patch_retraced(rec, sel,
                   trace(torch.stack([r[sel] for r in rows_w[:3]], dim=1),
                         torch.stack([r[sel] for r in rows_w[3:]], dim=1)),
                   occl)
    return int(flagged.numel()), int(sel.numel())


def patch_retraced(rec, sel, sub, occl):
    """Write `sub`, the exact re-trace of rays `sel`, into rec in place;
    on occlusion waves (sub traced any-hit) t normalised to 0 / FLT_MAX,
    as stream3.py:2815-2821 does."""
    if occl:
        sub.t = torch.where(sub.hit, 0.0, FLT_MAX)
    for f in ("t", "prim", "slot", "b1", "b2"):
        getattr(rec, f)[sel] = getattr(sub, f).to(getattr(rec, f).dtype)


def trace_rows_stream3(scene, rows_w, tmin, tmax, live=None,
                       occl: bool = False, with_diag: bool = False,
                       blk_bound=None, presort: bool = False,
                       tqsort: bool = False, lean: bool = False,
                       cull: bool = False, tq_bits: int = W_TQ_BITS):
    """Closest-hit trace of a wave given as six world-space [N] rows
    (ox, oy, oz, dx, dy, dz) against a single-instance scene (check
    supports(scene, tq_bits); tq_bits is the word format's tq width,
    5..9, and the scene's leaf cap its leaf width); with occl, an occlusion trace: t = 0 on occluded
    rays, FLT_MAX otherwise.

    Every packet flagged by the pipeline (walk cut at STEP_CAP, word list
    past PCAP) is re-traced exactly through the packet tracer (any-hit on
    occlusion waves, its t normalised to 0 / FLT_MAX as stream3.py:2815-
    2821 does).  `live` ([N] bool) masks dead lanes out of every frustum
    (they may hold NaN/Inf: they are parked first); dead lanes report a
    miss.

    blk_bound ([ceil(N / BLK)] f32 per-block upper bounds on t, e.g.
    block_bound_from_t of the previous progressive sample; FLT_MAX
    disables a block): leaves provably past a block's bound are culled
    before isect, and the temporal residual (_tb_residual: rays past
    their bound, or unoccluded under a finite bound) is re-traced exactly
    through the packet tracer after the flagged drain, up to
    max(TB_RES_RAYS, N // 128) rays; the rays past that cap come back
    marked slot == -2, t = FLT_MAX, which callers must re-trace or
    distrust (the engine re-traces them).

    presort, tqsort, lean and cull select the ordering modes and kernel
    forms of _run (each off by default, which keeps the default route's
    hits bit for bit); the flagged drain maps a presorted wave's packets
    back to caller blocks.

    With with_diag, returns (rec, diag) with the pipeline's counters plus
    "flagged" packets and "residual_rays" re-traced; with blk_bound also
    "block_pairs" and "block_pairs_bounded" (the (word, block) pairs
    before and after the cull), "tb_residual" (rays re-traced for the
    bound), "tb_cap" and "tb_marked" (rays marked -2).

    Its span, stream3.trace, notes "rays" (N) and "residual_rays" (the
    flagged packets' rays and the temporal residual's, re-traced
    exactly)."""
    n = rows_w[0].shape[0]
    with profiling.span("stream3.trace") as sp:
        if live is not None:
            live = live.bool()
            rows_w = park_dead(rows_w, live)
        rec, diag = _run(rows_w, tmin, tmax, scene.knode_f, scene.kleaf,
                         scene.inst_inv[0], live=live,
                         stable=bool(scene.stable_frames), occl=occl,
                         with_diag=with_diag, flags=True, blk_bound=blk_bound,
                         count_pairs=with_diag, presort=presort,
                         tqsort=tqsort, lean=lean, cull=cull,
                         kprim=scene.kprim, ktri_geo=scene.ktri_geo,
                         tq_bits=tq_bits)

        def exact(o, d):
            return packet_trace.trace_rays_packet(scene, o, d, tmin, tmax,
                                                  any_hit=occl)

        with profiling.span("stream3.residual"):
            diag["flagged"], diag["residual_rays"] = retrace_flagged(
                rec, rows_w, diag["pkt_flag"], occl, exact,
                diag["blk_perm"] if presort else None)
            if blk_bound is not None:
                diag.update(_tb_residual(rows_w, rec, blk_bound, exact,
                                         occl=occl, live=live, n=n))
        sp.note(rays=n, residual_rays=diag["residual_rays"]
                + diag.get("tb_residual", 0))
        if live is not None:
            rec = rec.masked_miss(~live[:n])
    return (rec, diag) if with_diag else rec


def trace_rays_stream3(scene, origin, direction, tmin, tmax,
                       any_hit: bool = False,
                       tq_bits: int = W_TQ_BITS) -> HitRecord:
    """trace_rows_stream3 on [N, 3] world-space rays (one transpose);
    any_hit runs the occlusion wave."""
    return trace_rows_stream3(scene, rows_from_aos_fast(origin, direction),
                              tmin, tmax, occl=any_hit, tq_bits=tq_bits)


def trace_rows_cascade(scene, rows_w, tmin, tmax, near, live=None,
                       occl: bool = False, with_diag: bool = False,
                       **modes):
    """The two-stage t-cascade (stream3.py::trace_rows_cascade, :2858-
    2885): stage A traces the wave with tmax = near (short shafts, few
    leaves emitted), stage B re-traces only A's misses over the full
    window through the live mask.  Exact: a hit inside (tmin, near) is
    the closest one, and a miss re-runs the whole window.  modes go to
    both trace_rows_stream3 calls (presort, tqsort, lean, cull, tq_bits).  With
    with_diag, returns (rec, {"a": diag of A, "b": diag of B})."""
    rec_a, diag_a = trace_rows_stream3(scene, rows_w, tmin, near, live=live,
                                       occl=occl, with_diag=True, **modes)
    miss_a = rec_a.t >= FLT_MAX
    live_b = miss_a if live is None else (miss_a & live.bool())
    rec_b, diag_b = trace_rows_stream3(scene, rows_w, tmin, tmax,
                                       live=live_b, occl=occl,
                                       with_diag=True, **modes)
    hit_a = ~miss_a
    rec = HitRecord(*(torch.where(hit_a, getattr(rec_a, f), getattr(rec_b, f))
                      for f in ("t", "prim", "slot", "b1", "b2")))
    return (rec, {"a": diag_a, "b": diag_b}) if with_diag else rec


# ------------------------------------------------------- build_tracer

def build_tracer(scene, presort: bool = False, tqsort: bool = False,
                 lean: bool = False, cull: bool = False,
                 tq_bits: int = W_TQ_BITS):
    """A host-loop closest-hit tracer for one single-instance scene
    (check supports(scene); stream3.py::build_tracer, :2940-2995):
    tracer(o, d, tmin, tmax) -> HitRecord, o and d [N, 3], or o the six
    world-space rows and d None.  It is trace_rows_stream3 with its modes
    fixed: every flagged packet is re-traced exactly through the packet
    kernel (the reference's _residual_retrace, :2911-2937, which walks
    them in fixed RES_CAP chunks, a jit shape), so the record is
    complete.  presort, tqsort, lean, cull and tq_bits are _run's.  The
    reference's probe self-checks (_spot_check, _probe_check: defences
    against the TPU compiler miscompiling a kernel) are left out; the
    parity tests take their place."""
    if not supports(scene, tq_bits):
        raise ValueError("stream3 requires a single-instance scene with "
                         "kernel tables (see kernel_pack.py) whose leaves a "
                         f"{tq_bits}-bit tq word can address")

    def tracer(o, d, tmin, tmax):
        rows_w = tuple(o) if isinstance(o, (tuple, list)) \
            else rows_from_aos_fast(o, d)
        return trace_rows_stream3(scene, rows_w, tmin, tmax, presort=presort,
                                  tqsort=tqsort, lean=lean, cull=cull,
                                  tq_bits=tq_bits)

    return tracer
