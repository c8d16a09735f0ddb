"""On-device LBVH builder: Morton sort + Karras hierarchy on torch tensors.

Port of radiance_tpu/bvh/lbvh.py (the reference builds BVHs on the host
only, radiance/src/bvh.cpp:46-285).  The build runs where the vertices
are, in whole-array ops:

  1. triangle centroids quantized to a 10-bit grid and interleaved into
     30-bit Morton codes;
  2. a stable sort of the codes (jnp.argsort is stable, so the leaf
     bundles equal the JAX package's lane for lane);
  3. 8 consecutive sorted triangles make one leaf bundle;
  4. Karras 2012 internal nodes over the groups, each node's range,
     split and children found independently, the group keys made unique
     by their index;
  5. leaf-up AABB propagation and root-down escape threading, each a
     loop of whole-array passes to a fixed point (one host read a pass;
     the tree is at most 64 deep).

The codes are uint32 arithmetic in the JAX package; here they are int64
with explicit 32-bit masks (torch has few uint32 ops).  The packed rows
are built in int32 and viewed as float32 once at the end, as the JAX
package does, so no float op ever touches a word that holds integer bits.

The result is a DeviceScene with one identity instance and no kernel
tables, so the engine's dispatch sends it to the walk (ops/traversal.py).
"""

from __future__ import annotations

import torch

from radiance_tpu_torch import config
from radiance_tpu_torch.bvh.device import (KIND_INNER, KIND_INST_LEAF,
                                           KIND_TRI_LEAF, META_A_MASK,
                                           META_COUNT_SHIFT, META_KIND_SHIFT,
                                           DeviceScene)

LEAF_W = config.LEAF_WIDTH
_U32 = 0xFFFFFFFF


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bits."""
    x = x & _U32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (uint32 values in int64)."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(p: torch.Tensor) -> torch.Tensor:
    """[N, 3] float in [0, 1] -> 30-bit Morton codes (int64)."""
    q = torch.clamp(p * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q[:, 0]) << 2)
            | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Position of the highest set bit (0 for x == 0) of uint32 values."""
    x = x & _U32
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        n = n + torch.where(big, shift, 0)
        x = torch.where(big, x >> shift, x)
    return n + (x > 0).to(x.dtype)


def _delta(keys, i, j, g: int):
    """Common-prefix length of the 64-bit keys (code, index) of i and j;
    -1 when j is out of range.  The index half keeps keys distinct, as
    the Karras construction needs."""
    codes, idxs = keys
    j_ok = (j >= 0) & (j < g)
    jc = torch.clamp(j, 0, g - 1)
    xc = codes[i] ^ codes[jc]
    xi = idxs[i] ^ idxs[jc]
    nlz = torch.where(xc != 0, 32 - _bit_length(xc), 64 - _bit_length(xi))
    return torch.where(j_ok, nlz, -1)


def _karras_children(keys, g: int):
    """For internal nodes i in [0, g-2]: (gamma, left_is_leaf,
    right_is_leaf, i, j) of the Karras 2012 construction over g leaves."""
    dev = keys[0].device
    i = torch.arange(g - 1, dtype=torch.int64, device=dev)
    rounds = max(int(g).bit_length() + 1, 2)

    d = torch.sign(_delta(keys, i, i + 1, g) - _delta(keys, i, i - 1, g))
    d = torch.where(d == 0, 1, d)
    delta_min = _delta(keys, i, i - d, g)

    # an upper bound on the range length, by galloping
    lmax = torch.full_like(i, 2)
    for _ in range(rounds):
        grow = _delta(keys, i, i + lmax * d, g) > delta_min
        lmax = torch.where(grow, lmax * 2, lmax)

    # binary search for the range's other end
    l = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(rounds):
        probe = _delta(keys, i, i + (l + t) * d, g)
        l = torch.where((t > 0) & (probe > delta_min), l + t, l)
        t = t // 2
    j = i + l * d

    # the split: the highest differing bit within the range
    delta_node = _delta(keys, i, j, g)
    s = torch.zeros_like(i)
    t = (l + 1) // 2
    for _ in range(rounds):
        probe = _delta(keys, i, i + (s + t) * d, g)
        s = torch.where((t > 0) & (probe > delta_node), s + t, s)
        t = torch.where(t > 1, (t + 1) // 2, 0)
    gamma = i + s * d + torch.clamp(d, max=0)

    left_is_leaf = torch.minimum(i, j) == gamma
    right_is_leaf = torch.maximum(i, j) == gamma + 1
    return gamma, left_is_leaf, right_is_leaf, i, j


def build_lbvh(tri_v0: torch.Tensor, tri_v1: torch.Tensor,
               tri_v2: torch.Tensor, prim_id: torch.Tensor) -> dict:
    """LBVH over triangles, on their device.

    tri_v0/v1/v2: [T, 3] f32 vertex positions; prim_id: [T] i32.
    Returns node_packed_i [2G-1, 8] and bundle_packed_i [G, 8, 12], int32
    bit patterns of DeviceScene's BLAS rows (G = ceil(T/8) leaf groups, at
    least 2; node 0 is the root, internal nodes first), n_internal and
    the groups' triangle counts.
    """
    dev = tri_v0.device
    i64, i32, f32 = torch.int64, torch.int32, torch.float32
    t = tri_v0.shape[0]
    g = max(-(-t // LEAF_W), 2)         # at least 2 groups: one internal

    lo = torch.minimum(torch.minimum(tri_v0, tri_v1), tri_v2)
    hi = torch.maximum(torch.maximum(tri_v0, tri_v1), tri_v2)
    centers = (lo + hi) * 0.5
    smin = lo.amin(dim=0)
    smax = hi.amax(dim=0)
    extent = torch.clamp(smax - smin, min=1e-12)
    codes = morton3d((centers - smin) / extent)

    order = torch.sort(codes, stable=True).indices
    garange = torch.arange(g, dtype=i64, device=dev)
    first = order[torch.clamp(garange * LEAF_W, max=t - 1)]
    gkeys = (codes[first], garange)

    gamma, left_leaf, right_leaf, _, _ = _karras_children(gkeys, g)
    n_internal = g - 1
    n_nodes = n_internal + g
    # node layout: internal nodes [0, g-1), leaves [g-1, 2g-1)
    left = torch.where(left_leaf, gamma + n_internal, gamma)
    right = torch.where(right_leaf, gamma + 1 + n_internal, gamma + 1)

    # leaf bundles
    lane = torch.arange(LEAF_W, dtype=i64, device=dev)
    slots = garange[:, None] * LEAF_W + lane[None, :]
    valid = slots < t
    src = order[torch.clamp(slots, max=t - 1)]
    vm = valid[..., None]
    v0g = torch.where(vm, tri_v0[src], 0.0)
    v1g = torch.where(vm, tri_v1[src], 0.0)
    v2g = torch.where(vm, tri_v2[src], 0.0)
    pidg = torch.where(valid, prim_id[src].to(i32), -1)

    bundle_i = torch.zeros((g, LEAF_W, 12), dtype=i32, device=dev)
    bundle_i[:, :, 0:3] = v0g.view(i32)
    bundle_i[:, :, 3:6] = (v1g - v0g).view(i32)
    bundle_i[:, :, 6:9] = (v2g - v0g).view(i32)
    bundle_i[:, :, 9] = pidg

    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    leaf_lo = torch.where(vm, lo[src], inf).amin(dim=1)
    leaf_hi = torch.where(vm, hi[src], -inf).amax(dim=1)

    # bottom-up AABB propagation to the fixed point (union propagation is
    # monotone, so it ends within the tree's depth in passes)
    node_lo = torch.zeros((n_nodes, 3), dtype=f32, device=dev)
    node_hi = torch.zeros((n_nodes, 3), dtype=f32, device=dev)
    node_lo[n_internal:] = leaf_lo
    node_hi[n_internal:] = leaf_hi
    while True:
        new_lo = node_lo.clone()
        new_hi = node_hi.clone()
        new_lo[:n_internal] = torch.minimum(node_lo[left], node_lo[right])
        new_hi[:n_internal] = torch.maximum(node_hi[left], node_hi[right])
        changed = bool(((new_lo != node_lo).any()
                        | (new_hi != node_hi).any()).item())
        node_lo, node_hi = new_lo, new_hi
        if not changed:
            break

    # parent pointers, then top-down escape threading
    internal = torch.arange(n_internal, dtype=i32, device=dev)
    parent = torch.zeros(n_nodes, dtype=i32, device=dev)
    parent[left] = internal
    parent[right] = internal
    is_left = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
    is_left[left] = True
    sibling = torch.zeros(n_nodes, dtype=i32, device=dev)
    sibling[left] = right.to(i32)
    esc = torch.where(is_left, sibling, -2)
    esc[0] = -1
    not_root = torch.arange(n_nodes, device=dev) != 0
    # right children inherit their parent's escape once it resolves
    while bool((esc == -2).any().item()):
        esc = torch.where(~is_left & not_root, esc[parent.to(i64)], esc)

    # pack, in int32 space
    nodes = torch.arange(n_nodes, dtype=i64, device=dev)
    is_leaf_node = nodes >= n_internal
    left_full = torch.zeros(n_nodes, dtype=i64, device=dev)
    left_full[:n_internal] = left
    a = torch.where(is_leaf_node, nodes - n_internal, left_full)
    counts = valid.sum(dim=1).to(i32)
    count_f = torch.where(is_leaf_node,
                          counts[torch.clamp(nodes - n_internal, min=0)],
                          0).to(i64)
    kind = torch.where(is_leaf_node, KIND_TRI_LEAF, KIND_INNER)
    meta = ((a & META_A_MASK) | (count_f << META_COUNT_SHIFT)
            | (kind.to(i64) << META_KIND_SHIFT))

    packed_i = torch.zeros((n_nodes, 8), dtype=i32, device=dev)
    packed_i[:, 0:3] = node_lo.view(i32)
    packed_i[:, 3:6] = node_hi.view(i32)
    packed_i[:, 6] = _to_i32(meta)
    packed_i[:, 7] = esc
    return dict(node_packed_i=packed_i, bundle_packed_i=bundle_i,
                n_internal=n_internal, counts=counts)


def lbvh_scene(vertices: torch.Tensor, triangles: torch.Tensor
               ) -> DeviceScene:
    """A single-instance DeviceScene built where `vertices` lie.

    vertices: [V, 3] f32; triangles: [T, 3] integer.  The TLAS is one
    instance leaf (identity transform) in front of the BLAS; fit for a
    rebuild every frame of deforming geometry.
    """
    dev = vertices.device
    i32 = torch.int32
    tri = triangles.to(device=dev, dtype=torch.int64)
    v0 = vertices[tri[:, 0]]
    v1 = vertices[tri[:, 1]]
    v2 = vertices[tri[:, 2]]
    prim = torch.arange(tri.shape[0], dtype=i32, device=dev)
    blas = build_lbvh(v0, v1, v2, prim)

    # TLAS: one instance-leaf root at node 0, the BLAS rows from 1.
    # Rebase the BLAS's inner children and escapes by one, in int32 space.
    bp_i = blas["node_packed_i"].clone()
    meta = bp_i[:, 6]
    kind = (meta >> META_KIND_SHIFT) & 0x3
    a = meta & META_A_MASK
    a = torch.where(kind == KIND_INNER, a + 1, a)
    bp_i[:, 6] = (a & META_A_MASK) | (meta & ~META_A_MASK)
    esc = bp_i[:, 7]
    bp_i[:, 7] = torch.where(esc >= 0, esc + 1, esc)

    tlas_meta = _to_i32(torch.tensor(
        (1 << META_COUNT_SHIFT) | (KIND_INST_LEAF << META_KIND_SHIFT)))
    tlas_row = torch.cat([bp_i[0, 0:6], tlas_meta.reshape(1).to(dev),
                          torch.full((1,), -1, dtype=i32, device=dev)])
    node_packed_i = torch.cat([tlas_row[None], bp_i])
    # the one int -> f32 view; later code only gathers and slices these
    node_packed = node_packed_i.view(torch.float32)
    bundle_packed = blas["bundle_packed_i"].view(torch.float32)

    eye = torch.eye(4, dtype=torch.float32, device=dev)[None]
    zero = torch.zeros(1, dtype=i32, device=dev)
    return DeviceScene(
        node_packed=node_packed, bundle_packed=bundle_packed,
        inst_transform=eye, inst_inv=eye.clone(), inst_id=zero,
        inst_custom=zero.clone(), inst_sbt=zero.clone(),
        inst_blas_root=torch.ones(1, dtype=i32, device=dev))
