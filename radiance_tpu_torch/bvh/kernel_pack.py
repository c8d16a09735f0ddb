"""Kernel-side scene tables for the packet traversal.

A carried copy of radiance_tpu/bvh/kernel_pack.py (numpy only; the
tables must stay bit-identical to the JAX package's, which
tests/test_torch_tables.py checks).  Differences: the frame mode, the
leaf cap and the leaf collapse (greedy, or the SAH-driven cut with its
rho) are arguments instead of environment reads.

The TPU kernel walks a node table resident in VMEM, so the table must
be small, and intersects leaf triangles on the MXU, so each leaf must
be a dense matrix; the CUDA kernel (csrc/packet_trace.cu) reads the
same tables from device memory.  This module derives that
layout from the same decoded BVH the DeviceScene is assembled from
(reference counterpart: the flattener CreateDeviceBVH,
radiance/src/bvh.cpp:423-597 -- the reference never needed this step
because GPU threads chase pointers in global memory; the TPU walk wants
a compact VMEM tree plus matmul-shaped leaves):

  1. **Leaf collapse**: subtrees whose triangles form a contiguous range
     of <= KERNEL_MAX_TRIS faces become one kernel leaf (merging the SAH
     builder's 8-wide leaves).  Face ranges are contiguous for siblings
     because the builder emits faces in DFS leaf order.
  2. **Escape threading** on the collapsed tree (preorder emission), so
     the kernel walk is stackless: one scalar register per packet.
  3. **Pluecker leaf matrices**: each kernel leaf becomes a [16, 4T]
     f32 matrix W such that, for a ray feature vector
     X = [d, o x d, o, 1, 0...] (16 wide), the product X @ W yields per
     triangle the three edge side-products (s0, s1, s2) and the plane
     numerator (n.o + dp).  Identities used:
       side(ray, edge a->b) = d.(a x b) + (o x d).(b - a)
       s0 + s1 + s2 = d.n            (n = e1 x e2; the moment terms
                                      telescope to zero over a cycle)
       t = -(n.o + dp) / (d.n)       (dp = -n.v0)
       b1 = s2 / (s0+s1+s2), b2 = s0 / (s0+s1+s2)
     so one [R,16]x[16,4T] matmul intersects a whole ray packet against
     all T leaf triangles; no per-triangle scalar broadcasts.

Tables (numpy, converted to tensors by the DeviceScene assembly):
  knode_f [8*Nk, 16] f32: ONE merged row per node -- words 0-5 bounds
                          min.xyz/max.xyz, words 8-11 the meta
                          (a, esc, ntri, tri_start) stored as exact f32
                          integer values (< 2^24; Mosaic pads every
                          narrow VMEM row the kernel vector-reads to
                          128 lanes, so splitting bounds/meta into two
                          tables doubles the padded footprint).  8 node
                          tables concatenated, one preorder threading
                          per ray-direction octant (near child first).
                          ntri == 0 => inner node with a = left-child
                          row; ntri > 0 => leaf with a = kleaf row;
                          esc == -1 exits the walk; tri_start = row of
                          the leaf's first face (contiguous per leaf)
  knode_i [8*Nk, 4]  i32: the same meta as integers (kept for host-side
                          tooling/tests; not shipped to the kernel)
  kleaf   [Nl, 16, 4T] f32: the W matrices (lanes [0:T) s0-edges,
                          [T:2T) s1, [2T:3T) s2, [3T:4T) plane num);
                          invalid lanes are all-zero => s = 0, d.n = 0,
                          t = nan => rejected by the t-window test
  kprim   [Nf + T]   i32: face-order primID (what HitRecord.prim wants),
                          padded with -1 so tri_start+lane never reads
                          out of bounds
  ktri_geo [Nf + T, 9] f32: per-face (v0, e1, e2) in face order, used by
                          the wrapper to recompute barycentrics for the
                          winning triangle only (the kernel tracks just
                          t + face id, halving its per-leaf scratch
                          read-modify-writes)
"""

from __future__ import annotations

import math
import numbers
from typing import Optional

import numpy as np


# Triangles per kernel leaf (the collapse cap) and the leaf-matrix
# width; build_kernel_tables takes the cap as an argument (a multiple of
# 32 in [32, 512]) with this default.
KERNEL_MAX_TRIS = 128
KERNEL_LEAF_LANES = 4 * KERNEL_MAX_TRIS


def check_leaf_cap(cap) -> int:
    """The collapse cap as an int, or ValueError where the JAX package's
    RADIANCE_LEAF_CAP check (kernel_pack.py:82-87) refuses it: a
    multiple of 32 in [32, 512].  A smaller cap trades pair-kernel tile
    work for more leaves to emit (tests/test_leaf_cap.py's pricing)."""
    if (isinstance(cap, bool) or not isinstance(cap, (int, np.integer))
            or cap % 32 != 0 or not 32 <= cap <= 512):
        raise ValueError(
            f"RADIANCE_LEAF_CAP={cap} (leaf_cap): must be a multiple of 32 "
            f"in [32, 512]")
    return int(cap)

COLLAPSES = ("greedy", "sah")
DEFAULT_RHO = 0.15


def check_collapse(collapse, rho) -> tuple:
    """(collapse, rho) as (str, float), or ValueError where the JAX
    package would not build them: RADIANCE_COLLAPSE is "greedy" (the
    default) or "sah", and RADIANCE_COLLAPSE_RHO, the walk-step cost over
    the pair cost of the SAH model, a finite number >= 0."""
    if collapse not in COLLAPSES:
        raise ValueError(f"RADIANCE_COLLAPSE={collapse!r} (collapse): must "
                         f"be one of {COLLAPSES}")
    if (isinstance(rho, bool) or not isinstance(rho, numbers.Real)
            or not math.isfinite(rho) or rho < 0):
        raise ValueError(f"RADIANCE_COLLAPSE_RHO={rho!r} (rho): must be a "
                         f"finite number >= 0")
    return collapse, float(rho)


# Node-table cap per octant, kept from the TPU tables (whose node table
# had to fit in VMEM) so both packages agree on which scenes get kernel
# tables.  1M tris at KERNEL_MAX_TRIS=128 needs ~25k.
KERNEL_MAX_NODES = 60_000


def leaf_matrix(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                valid: np.ndarray) -> np.ndarray:
    """Build one [16, 4T] Pluecker leaf matrix from T triangles
    (T need not equal KERNEL_MAX_TRIS; tests use it standalone).

    v0/v1/v2: [T, 3] f32 vertex positions; valid: [T] bool.
    Column blocks (T wide each): s0 (edge v0->v1), s1 (v1->v2),
    s2 (v2->v0), num (n.o + dp).
    """
    T = v0.shape[0]
    w = np.zeros((16, 4 * T), np.float32)
    vm = valid[:, None]
    a = np.where(vm, v0, 0.0).astype(np.float32)
    b = np.where(vm, v1, 0.0).astype(np.float32)
    c = np.where(vm, v2, 0.0).astype(np.float32)

    def edge_cols(p, q):
        cols = np.zeros((16, T), np.float32)
        cols[0:3] = np.cross(p, q).T          # pairs with ray d
        cols[3:6] = (q - p).T                 # pairs with ray o x d
        return cols

    n = np.cross(b - a, c - a)                # e1 x e2
    num = np.zeros((16, T), np.float32)
    num[6:9] = n.T                            # pairs with ray o
    num[9] = -np.sum(n * a, axis=-1)          # dp (pairs with the 1)

    w[:, 0 * T:1 * T] = edge_cols(a, b)
    w[:, 1 * T:2 * T] = edge_cols(b, c)
    w[:, 2 * T:3 * T] = edge_cols(c, a)
    w[:, 3 * T:4 * T] = num
    return w


def build_kernel_tables(kind, a, b, bot, top, faces, verts3, *,
                        stable: bool = True,
                        leaf_cap: int = KERNEL_MAX_TRIS,
                        collapse: str = "greedy",
                        rho: float = DEFAULT_RHO) -> Optional[dict]:
    """Collapse + thread + matrix-pack one BLAS tree for the packet kernel.

    kind/a/b: decoded node arrays (a=start, b=count for tri leaves;
    a=left, b=right local child rows for inner nodes), children always
    emitted after their parent (builder preorder).
    faces: structured DEVICE_TRIANGLE rows in leaf-emit order.
    verts3: [V, 3] f32.
    stable: translation-stabilized leaf frames (the JAX package's
      RADIANCE_STABLE_FRAMES=1 default); False builds the legacy
      origin-centred moments.
    leaf_cap: triangles per kernel leaf (RADIANCE_LEAF_CAP there).
    collapse: "greedy" merges sibling leaves while they fit in leaf_cap;
      "sah" cuts the tree where the SAH model says a leaf pays
      (RADIANCE_COLLAPSE=sah there), rho the walk-step cost over the
      pair cost (RADIANCE_COLLAPSE_RHO).  Both give leaves of <= leaf_cap
      triangles in the same table format.
    Returns the table dict, or None when the scene exceeds kernel limits.
    """
    leaf_cap = check_leaf_cap(leaf_cap)
    collapse, rho = check_collapse(collapse, rho)
    kind = np.asarray(kind, np.int32)
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    bot = np.asarray(bot, np.float32).reshape(-1, 3)
    top = np.asarray(top, np.float32).reshape(-1, 3)
    n = len(kind)
    from radiance_tpu_torch.bvh.device import KIND_INNER, KIND_TRI_LEAF

    if n == 0 or (kind == 2).any():  # instance leaves: not a BLAS tree
        return None

    is_kleaf = kind == KIND_TRI_LEAF
    start = np.where(is_kleaf, a, 0)
    ntri = np.where(is_kleaf, b, 0)
    inner_mask = kind == KIND_INNER

    if collapse == "sah":
        # --- 1. SAH-driven leaf collapse (RADIANCE_COLLAPSE=sah).
        # Kernel leaves are PADDED to leaf_cap, so every ray entering a
        # leaf pays the full pair product no matter how few triangles it
        # holds; the greedy policy below therefore merges siblings
        # whenever they fit, maximizing fill.  But merging two spatially
        # tight children into their (larger) parent box makes MORE rays
        # enter the leaf.  Under the standard SAH model (expected visits
        # proportional to surface area) the expected wave cost of a cut
        # set is sum(SA(leaf)) + rho * sum(SA(inner)) with rho =
        # walk-step cost / pair cost; minimize it exactly with a
        # bottom-up DP over subtrees (children follow parents in builder
        # preorder, so one backward pass).  Collapse remains restricted
        # to whole subtrees with contiguous face ranges (the kernel leaf
        # is one dense face slab).
        sa_wh = np.maximum(top - bot, 0.0).astype(np.float64)
        sa = (sa_wh[:, 0] * sa_wh[:, 1] + sa_wh[:, 1] * sa_wh[:, 2]
              + sa_wh[:, 2] * sa_wh[:, 0])
        cnt = np.zeros(n, np.int64)
        st = np.zeros(n, np.int64)
        cost = np.zeros(n, np.float64)
        cut = np.zeros(n, bool)
        contig = np.zeros(n, bool)
        for i in range(n - 1, -1, -1):
            if kind[i] == KIND_TRI_LEAF:
                cnt[i] = b[i]
                st[i] = a[i]
                cost[i] = sa[i]
                cut[i] = True
                contig[i] = True
            elif kind[i] == KIND_INNER:
                l, r = a[i], b[i]
                cnt[i] = cnt[l] + cnt[r]
                st[i] = min(st[l], st[r])
                contig[i] = bool(contig[l] and contig[r]
                                 and st[l] + cnt[l] == st[r])
                c_split = rho * sa[i] + cost[l] + cost[r]
                if (cnt[i] <= leaf_cap and contig[i]
                        and sa[i] <= c_split):
                    cost[i] = sa[i]
                    cut[i] = True
                else:
                    cost[i] = c_split
        # mark the HIGHEST cut node on each root-to-leaf path
        is_kleaf = np.zeros(n, bool)
        stack = [0]
        while stack:
            i = stack.pop()
            if cut[i]:
                is_kleaf[i] = True
                start[i] = st[i]
                ntri[i] = cnt[i]
            else:
                stack.append(int(a[i]))
                stack.append(int(b[i]))
    else:
        # --- 1. greedy leaf collapse (vectorized passes; each pass
        # merges sibling pairs, so <= log2(leaf_cap) +
        # stragglers iterations) ---
        while True:
            m = inner_mask & ~is_kleaf
            l = np.where(m, a, 0)
            r = np.where(m, b, 0)
            can = (m & is_kleaf[l] & is_kleaf[r]
                   & (ntri[l] + ntri[r] <= leaf_cap)
                   & (start[l] + ntri[l] == start[r]))
            if not can.any():
                break
            ci = np.nonzero(can)[0]
            start[ci] = start[l[ci]]
            ntri[ci] = ntri[l[ci]] + ntri[r[ci]]
            is_kleaf[ci] = True

    # --- subtree sizes in the collapsed tree (children after parents) ---
    size = np.ones(n, np.int64)
    eff_inner = inner_mask & ~is_kleaf
    for i in range(n - 1, -1, -1):
        if eff_inner[i]:
            size[i] = 1 + size[a[i]] + size[b[i]]
    nk = int(size[0])
    if nk > KERNEL_MAX_NODES:
        return None

    # --- 2. preorder emission with escape threading, once per ray
    # direction octant.  A fixed child order makes the packet's t-clip
    # almost useless (far subtrees are often visited first); emitting 8
    # threadings -- each descending into the child nearer along the
    # octant's signs first -- restores near-to-far ordering for the
    # price of 8 small node tables (the leaf matrices are SHARED: leaf
    # ids and tri_start are octant-invariant).  Classical technique for
    # stackless/threaded BVHs; the reference's stack walk gets ordering
    # for free by pushing the far child (radiance.cl:66-67).
    centroid = (bot + top) * 0.5
    leaf_id_of_node = np.full(n, -1, np.int64)
    leaf_rows = []
    leaf_start = []
    leaf_ntri = []

    kb = np.zeros((8, nk, 16), np.float32)
    km = np.zeros((8, nk, 4), np.int32)
    for octant in range(8):
        sgn = np.array([1 if octant & (1 << k) == 0 else -1
                        for k in range(3)], np.float32)
        stack = [(0, -1)]
        pos = 0
        while stack:
            node, esc = stack.pop()
            my = pos
            pos += 1
            kb[octant, my, 0:3] = bot[node]
            kb[octant, my, 3:6] = top[node]
            if is_kleaf[node] or not eff_inner[node]:
                if leaf_id_of_node[node] < 0:
                    leaf_id_of_node[node] = len(leaf_rows)
                    leaf_rows.append(node)
                    leaf_start.append(int(start[node]))
                    leaf_ntri.append(int(ntri[node]))
                meta = (int(leaf_id_of_node[node]), esc,
                        max(int(ntri[node]), 1), int(start[node]))
                km[octant, my] = meta
                kb[octant, my, 8:12] = meta
            else:
                left, right = int(a[node]), int(b[node])
                # near child first: larger signed centroid separation
                delta = (centroid[right] - centroid[left]) * sgn
                axis = int(np.argmax(np.abs(delta)))
                near, far = ((left, right) if delta[axis] >= 0
                             else (right, left))
                km[octant, my] = (my + 1, esc, 0, 0)
                kb[octant, my, 8:12] = (my + 1, esc, 0, 0)
                stack.append((far, esc))
                stack.append((near, my + 1 + int(size[near])))
        assert pos == nk, "kernel tree emission size mismatch"
    kb = kb.reshape(8 * nk, 16)
    km = km.reshape(8 * nk, 4)

    # --- 3. Pluecker leaf matrices ---
    T = leaf_cap
    nl = len(leaf_rows)
    leaf_start = np.asarray(leaf_start, np.int64)
    leaf_ntri = np.asarray(leaf_ntri, np.int64)

    lane = np.arange(T, dtype=np.int64)[None, :]            # [1, T]
    valid = lane < leaf_ntri[:, None]                       # [nl, T]
    face_idx = np.clip(leaf_start[:, None] + lane, 0,
                       max(len(faces) - 1, 0))              # [nl, T]
    f = faces[face_idx]
    p0 = verts3[f["idx0"].astype(np.int64)]                 # [nl, T, 3]
    p1 = verts3[f["idx1"].astype(np.int64)]
    p2 = verts3[f["idx2"].astype(np.int64)]

    # batched leaf_matrix over all leaves at once
    vm = valid[:, :, None]
    pa = np.where(vm, p0, 0.0).astype(np.float32)
    pb = np.where(vm, p1, 0.0).astype(np.float32)
    pc = np.where(vm, p2, 0.0).astype(np.float32)
    nrm = np.cross(pb - pa, pc - pa)                        # [nl, T, 3]
    kleaf = np.zeros((nl, 16, 4 * T), np.float32)
    if stable:
        # Translation-stabilized leaf frames (round-4 root cause: the
        # origin-centered moment p x q stores at ~|p||q| magnitude, so
        # its one-time f32 rounding flips grazing side products --
        # docs/raystream-design.md; offline proof recovers 196/196
        # kernel-missed real hits).  Rows 0:3 hold the LEAF-LOCAL
        # moment (p-c) x (q-c) computed in f64, with the centroid c in
        # the structurally-zero rows 12:14 (column 0 of each edge
        # block is fine: ray-feature columns 12-14 are zero in every
        # kernel variant).  Kernels then subtract the (c x d).e
        # correction -- see packet_trace.process_leaf /
        # stream3._isect3_kernel.
        cen = np.where(vm, (p0 + p1 + p2) / 3.0, 0.0).sum(axis=1) \
            / np.maximum(valid.sum(axis=1, keepdims=True), 1)  # [nl,3]
        c64 = cen.astype(np.float64)[:, None, :]
        for k, (p, q) in enumerate(((p0, p1), (p1, p2), (p2, p0))):
            lp = np.where(vm, p.astype(np.float64) - c64, 0.0)
            lq = np.where(vm, q.astype(np.float64) - c64, 0.0)
            kleaf[:, 0:3, k * T:(k + 1) * T] = np.cross(
                lp, lq).transpose(0, 2, 1).astype(np.float32)
            kleaf[:, 3:6, k * T:(k + 1) * T] = np.where(
                vm, q - p, 0.0).astype(np.float32).transpose(0, 2, 1)
        kleaf[:, 12, 0] = cen[:, 0].astype(np.float32)
        kleaf[:, 13, 0] = cen[:, 1].astype(np.float32)
        kleaf[:, 14, 0] = cen[:, 2].astype(np.float32)
    else:
        for k, (p, q) in enumerate(((pa, pb), (pb, pc), (pc, pa))):
            kleaf[:, 0:3, k * T:(k + 1) * T] = np.cross(
                p, q).transpose(0, 2, 1)
            kleaf[:, 3:6, k * T:(k + 1) * T] = (q - p).transpose(0, 2, 1)
    kleaf[:, 6:9, 3 * T:4 * T] = nrm.transpose(0, 2, 1)
    kleaf[:, 9, 3 * T:4 * T] = -np.sum(nrm * pa, axis=-1)
    # row 10, quarter 0: the lane's face-order primID as f32 (exact:
    # < 2^24).  Rows 10-15 are zero in every quarter otherwise; the
    # stream tracer's pair kernel reads this row to carry the winner's
    # primID through its scratch, which deletes the wave-sized
    # kprim gather from its epilogue.  Invalid lanes carry -1.
    prim_lane = np.where(valid, faces["primID"][face_idx], -1)
    kleaf[:, 10, 0 * T:1 * T] = prim_lane.astype(np.float32)

    kprim = np.full(len(faces) + T, -1, np.int32)
    kprim[:len(faces)] = faces["primID"].astype(np.int32)

    ktri_geo = np.zeros((len(faces) + T, 9), np.float32)
    fv0 = verts3[faces["idx0"].astype(np.int64)]
    ktri_geo[:len(faces), 0:3] = fv0
    ktri_geo[:len(faces), 3:6] = (
        verts3[faces["idx1"].astype(np.int64)] - fv0)
    ktri_geo[:len(faces), 6:9] = (
        verts3[faces["idx2"].astype(np.int64)] - fv0)

    # the frame mode is a property of the BUILT tables (stable mode
    # stores leaf-local moments + centroids; legacy stores the origin
    # moment): record it so trace-time kernels derive their 'stable'
    # flag from the tables instead of re-reading the env -- an env
    # change between scene build and trace must not mis-pair tables
    # with kernel variants
    return dict(knode_f=kb, knode_i=km, kleaf=kleaf, kprim=kprim,
                ktri_geo=ktri_geo, stable=stable)
