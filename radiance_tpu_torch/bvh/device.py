"""DeviceScene: the scene tables the tracers consume, as torch tensors.

Port of radiance_tpu/bvh/device.py (build_device_scene, :318-485, its
two entry points, :488-504, and the animated refit update_tlas,
:272-318).
Assembly stays vectorized NumPy and is a carried copy of the JAX
package's; only the last step differs: the arrays become tensors on an
explicit device.  The tables are bit-identical to the JAX package's
(tests/test_torch_tables.py).

Fields kept: the hot-path node/bundle mirrors (node_packed,
bundle_packed; the walk, ops/traversal.py, reads them), the
instance arrays, and the packet-kernel tables (knode_f, kleaf, kprim,
ktri_geo and the per-BLAS kblas sweep tables).  The SoA split fields of
the JAX DeviceScene (node_min .. bundle_prim) are views of the packed
mirrors and are not carried.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from radiance_tpu_torch import config
from radiance_tpu_torch.bvh import builder, serialize
from radiance_tpu_torch.core import device as rdevice

# node_kind values
KIND_INNER = 0
KIND_TRI_LEAF = 1
KIND_INST_LEAF = 2

# Scenes with at most this many instances get per-BLAS packet-kernel
# tables for instance-sequential sweeps (each sweep retraces the whole
# wavefront against one BLAS, so the cost is linear in instance count).
MAX_KERNEL_INSTANCES = 64

META_A_MASK = (1 << 26) - 1
META_COUNT_SHIFT = 26
META_KIND_SHIFT = 30

KBlas = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class DeviceScene:
    """Scene tables as tensors on one device."""
    # node_packed[i] = [min.xyz, max.xyz, bitcast(meta), bitcast(esc)] where
    # meta = a | count << 26 | kind << 30
    node_packed: torch.Tensor      # [Nn, 8] f32
    # bundle_packed[b, j] = [v0.xyz, e1.xyz, e2.xyz, bitcast(prim), 0, 0]
    bundle_packed: torch.Tensor    # [Nb, W, 12] f32

    inst_transform: torch.Tensor   # [Ni, 4, 4] f32 (object -> world)
    inst_inv: torch.Tensor         # [Ni, 4, 4] f32 (world -> object)
    inst_id: torch.Tensor          # [Ni] i32 (creation order)
    inst_custom: torch.Tensor      # [Ni] i32
    inst_sbt: torch.Tensor         # [Ni] i32
    inst_blas_root: torch.Tensor   # [Ni] i32 absolute node index

    # packet-kernel tables (bvh/kernel_pack.py): singleton fields for the
    # single-instance path, kblas for instance-sequential sweeps
    knode_f: Optional[torch.Tensor] = None   # [8*Nk, 16] f32
    kleaf: Optional[torch.Tensor] = None     # [Nl, 16, 4T] f32
    kprim: Optional[torch.Tensor] = None     # [Nf + T] i32
    ktri_geo: Optional[torch.Tensor] = None  # [Nf + T, 9] f32
    # per unique BLAS: (knode_f, kleaf, kprim, ktri_geo); inst_kblas maps
    # each instance slot to its kblas entry
    kblas: Optional[Tuple[KBlas, ...]] = None
    inst_kblas: Optional[Tuple[int, ...]] = None
    # frame mode of the BUILT kernel tables: True = leaf-local moments +
    # centroid rows.  Tracers take the kernel variant from here.
    stable_frames: bool = False
    # triangles per kernel leaf of every BLAS's tables (the collapse cap;
    # kleaf is [Nl, 16, 4 * leaf_cap])
    leaf_cap: int = 128
    # the leaf collapse the tables were built with ("greedy" or "sah")
    # and the SAH cut's rho (kernel_pack.build_kernel_tables); unlike the
    # cap, the tables do not tell them
    collapse: str = "greedy"
    rho: float = 0.15
    # the instance scan's tables (ops/stream3_multi.MultiTables), built at
    # the scene's first many-instance trace by stream3_multi.multi_tables
    multi: Optional[object] = dataclasses.field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.inst_inv.device


@dataclasses.dataclass
class _Tree:
    """Mutable decoded tree: parallel arrays (python lists for appends)."""
    bot: list
    top: list
    a: list
    b: list
    kind: list


def _decode_nodes(nodes: np.ndarray, leaf_kind: int) -> _Tree:
    """Structured DEVICE_BVH_NODE rows -> parallel arrays (vectorized)."""
    count_word = nodes["a"].astype(np.int64)
    is_leaf = (count_word & config.LEAF_FLAG) != 0
    a = np.where(is_leaf, nodes["b"].astype(np.int64), count_word)
    b = np.where(is_leaf, count_word & config.COUNT_MASK,
                 nodes["b"].astype(np.int64))
    kind = np.where(is_leaf, leaf_kind, KIND_INNER)
    return _Tree(
        bot=list(np.ascontiguousarray(nodes["bottom"], np.float32)),
        top=list(np.ascontiguousarray(nodes["top"], np.float32)),
        a=a.tolist(), b=b.tolist(), kind=kind.tolist())


def _split_oversized_leaves(t: _Tree, leaf_width: int) -> None:
    """Split leaves with count > leaf_width into balanced inner subtrees."""
    i = 0
    while i < len(t.kind):
        if t.kind[i] != KIND_INNER and t.b[i] > leaf_width:
            start, count, kind = t.a[i], t.b[i], t.kind[i]
            half = count // 2
            li = len(t.kind)
            for s, c in ((start, half), (start + half, count - half)):
                t.bot.append(t.bot[i])
                t.top.append(t.top[i])
                t.a.append(s)
                t.b.append(c)
                t.kind.append(kind)
            t.a[i], t.b[i], t.kind[i] = li, li + 1, KIND_INNER
        i += 1


def _compute_escape_arrays(a: np.ndarray, b: np.ndarray, kind: np.ndarray,
                           esc: np.ndarray, root: int) -> None:
    """Thread one tree: esc[left] = right sibling, esc[right] = esc[parent]."""
    from radiance_tpu_torch.bvh import native
    if native.compute_escape(a, b, kind, root, esc):
        return
    stack = [(root, -1)]
    while stack:
        i, e = stack.pop()
        esc[i] = e
        if kind[i] == KIND_INNER:
            stack.append((b[i], e))
            stack.append((a[i], b[i]))


def _bundle_triangles(t: _Tree, faces: np.ndarray, verts3: np.ndarray,
                      leaf_width: int, bundle_base: int):
    """Tri-leaf (start, count) -> 8-wide pre-dereferenced bundles.

    Rewrites each tri leaf's `a` to its bundle index (bundle_base-relative).
    Returns (v0 [L,W,3], e1, e2, prim [L,W]).
    """
    kind = np.asarray(t.kind)
    leaf_ids = np.nonzero(kind == KIND_TRI_LEAF)[0]
    w = leaf_width
    if len(leaf_ids) == 0:
        z = np.zeros((0, w, 3), np.float32)
        return z, z.copy(), z.copy(), np.zeros((0, w), np.int32)
    a = np.asarray(t.a)
    b = np.asarray(t.b)
    lane = np.arange(w)
    slot = a[leaf_ids][:, None] + lane[None, :]
    valid = lane[None, :] < b[leaf_ids][:, None]
    slot = np.clip(slot, 0, max(len(faces) - 1, 0))
    f = faces[slot]
    va = verts3[f["idx0"].astype(np.int64)]
    vb = verts3[f["idx1"].astype(np.int64)]
    vc = verts3[f["idx2"].astype(np.int64)]
    v0 = np.where(valid[..., None], va, 0.0).astype(np.float32)
    e1 = np.where(valid[..., None], vb - va, 0.0).astype(np.float32)
    e2 = np.where(valid[..., None], vc - va, 0.0).astype(np.float32)
    prim = np.where(valid, f["primID"].astype(np.int64), -1).astype(np.int32)
    for j, ni in enumerate(leaf_ids):
        t.a[ni] = bundle_base + j
    return v0, e1, e2, prim


def tlas_capacity_for(n_instances: int) -> int:
    """Worst-case padded TLAS rows: raw nodes (<= 2I-1) + oversized-leaf
    splits (< 2I) + root slack."""
    return 4 * max(n_instances, 1) + 8


def _tlas_tree(tlas_nodes: np.ndarray, leaf_width: int,
               capacity: int) -> _Tree:
    """The TLAS decoded, its oversized leaves split, and padded to
    `capacity` rows (0: exact size) with unreachable inert inner nodes
    with empty boxes."""
    t = _decode_nodes(tlas_nodes, KIND_INST_LEAF)
    _split_oversized_leaves(t, leaf_width)
    if capacity:
        if len(t.kind) > capacity:
            raise ValueError(f"TLAS block needs {len(t.kind)} rows > "
                             f"capacity {capacity}")
        big = np.float32(np.finfo(np.float32).max)
        while len(t.kind) < capacity:
            t.bot.append(np.full(3, big, np.float32))
            t.top.append(np.full(3, -big, np.float32))
            t.a.append(0)
            t.b.append(0)
            t.kind.append(KIND_INNER)
    return t


def _pack_rows(node_min: np.ndarray, node_max: np.ndarray,
               node_a: np.ndarray, node_b: np.ndarray,
               node_kind: np.ndarray, node_esc: np.ndarray) -> np.ndarray:
    """node_packed rows: [min.xyz, max.xyz, bitcast(meta), bitcast(esc)]."""
    if int(node_a.max(initial=0)) >= (1 << 26):
        raise ValueError("node/bundle index overflow")
    meta = (node_a.astype(np.uint32) & META_A_MASK) \
        | (np.where(node_kind != KIND_INNER, node_b, 0).astype(np.uint32)
           << META_COUNT_SHIFT) \
        | (node_kind.astype(np.uint32) << META_KIND_SHIFT)
    packed = np.zeros((len(node_kind), 8), np.float32)
    packed[:, 0:3] = node_min
    packed[:, 3:6] = node_max
    packed[:, 6] = meta.view(np.float32)
    packed[:, 7] = node_esc.astype(np.int32).view(np.float32)
    return packed


def _prepare_tlas_block(tlas_nodes: np.ndarray, leaf_width: int,
                        capacity: int) -> np.ndarray:
    """The TLAS as a packed block of `capacity` rows: the first rows of a
    padded build's node_packed.  The block is self-contained (instance
    leaves name instance slots, never BLAS rows), so a refit rewrites
    node_packed[:capacity] alone."""
    t = _tlas_tree(tlas_nodes, leaf_width, capacity)
    a = np.asarray(t.a, np.int64).astype(np.int32)
    b = np.asarray(t.b, np.int64).astype(np.int32)
    kind = np.asarray(t.kind, np.int32)
    esc = np.full(len(kind), -1, np.int32)
    _compute_escape_arrays(a, b, kind, esc, 0)
    return _pack_rows(np.asarray(t.bot, np.float32).reshape(-1, 3),
                      np.asarray(t.top, np.float32).reshape(-1, 3),
                      a, b, kind, esc)


def _instance_arrays(device_instances: np.ndarray,
                     blas_root_by_offset: dict):
    """(transform, inverse, BLAS root row) of each instance slot."""
    tf = np.ascontiguousarray(device_instances["transform"], np.float32)
    if len(device_instances):
        inv = np.linalg.inv(tf.astype(np.float64)).astype(np.float32)
        blas_root = np.array(
            [blas_root_by_offset[int(r["bottomAccelStructOffset"])]
             for r in device_instances], np.int32)
    else:
        inv = np.zeros((0, 4, 4), np.float32)
        blas_root = np.zeros(0, np.int32)
    return tf, inv, blas_root


def build_scene_arrays(tlas_nodes: np.ndarray,
                       device_instances: np.ndarray,
                       blas_by_offset: dict,
                       leaf_width: int = config.LEAF_WIDTH,
                       tlas_capacity: int = 0,
                       stable_frames: bool = True,
                       leaf_cap: int = 128, collapse: str = "greedy",
                       rho: float = 0.15) -> Dict:
    """The numpy half of build_device_scene: every table as an array.

    Returns a dict with the DeviceScene's array fields plus kblas (a
    tuple of per-BLAS table dicts or None), inst_kblas, stable_frames,
    leaf_cap (the collapse cap every BLAS's tables share, as the JAX
    package's import-time RADIANCE_LEAF_CAP does), collapse and rho (the
    leaf collapse of every BLAS's tables, its RADIANCE_COLLAPSE and
    RADIANCE_COLLAPSE_RHO).
    """
    from radiance_tpu_torch.bvh import kernel_pack

    leaf_cap = kernel_pack.check_leaf_cap(leaf_cap)
    collapse, rho = kernel_pack.check_collapse(collapse, rho)
    tlas = _tlas_tree(tlas_nodes, leaf_width, tlas_capacity)

    all_v0, all_e1, all_e2, all_prim = [], [], [], []
    trees = [tlas]
    blas_root_by_offset = {}
    node_base = len(tlas.kind)
    bundle_base = 0
    ktables = None
    kblas_by_offset = {}
    want_ktables = (len(device_instances) == 1
                    or len(device_instances) <= MAX_KERNEL_INSTANCES)
    for off in sorted(blas_by_offset.keys()):
        nodes, faces, verts = blas_by_offset[off]
        verts3 = np.ascontiguousarray(np.asarray(verts, np.float32)[:, :3])
        t = _decode_nodes(nodes, KIND_TRI_LEAF)
        _split_oversized_leaves(t, leaf_width)
        if want_ktables:
            # kernel tables come before _bundle_triangles rewrites leaf
            # start indices
            kt = kernel_pack.build_kernel_tables(
                t.kind, t.a, t.b, t.bot, t.top, faces, verts3,
                stable=stable_frames, leaf_cap=leaf_cap, collapse=collapse,
                rho=rho)
            kblas_by_offset[off] = kt
            if kt is None:
                want_ktables = False  # one oversized BLAS disables all
            elif len(blas_by_offset) == 1 and len(device_instances) == 1:
                ktables = kt
        v0, e1, e2, prim = _bundle_triangles(t, faces, verts3, leaf_width,
                                             bundle_base)
        bundle_base += len(v0)
        kind_arr = np.asarray(t.kind)
        inner = kind_arr == KIND_INNER
        t.a = np.where(inner, np.asarray(t.a) + node_base,
                       np.asarray(t.a)).tolist()
        t.b = np.where(inner, np.asarray(t.b) + node_base,
                       np.asarray(t.b)).tolist()
        all_v0.append(v0)
        all_e1.append(e1)
        all_e2.append(e2)
        all_prim.append(prim)
        trees.append(t)
        blas_root_by_offset[off] = node_base
        node_base += len(t.kind)

    node_min = np.concatenate([np.asarray(t.bot, np.float32).reshape(-1, 3)
                               for t in trees])
    node_max = np.concatenate([np.asarray(t.top, np.float32).reshape(-1, 3)
                               for t in trees])
    node_a = np.concatenate([np.asarray(t.a, np.int64)
                             for t in trees]).astype(np.int32)
    node_b = np.concatenate([np.asarray(t.b, np.int64)
                             for t in trees]).astype(np.int32)
    node_kind = np.concatenate([np.asarray(t.kind, np.int32) for t in trees])
    node_esc = np.full(len(node_kind), -1, np.int32)
    _compute_escape_arrays(node_a, node_b, node_kind, node_esc, 0)
    for off in sorted(blas_by_offset.keys()):
        _compute_escape_arrays(node_a, node_b, node_kind, node_esc,
                               blas_root_by_offset[off])

    tf, inv, blas_root = _instance_arrays(device_instances,
                                          blas_root_by_offset)

    w = leaf_width

    def cat_or_empty(lst, shape, dtype=np.float32, fill=0):
        out = ([x for x in lst if len(x)]
               or [np.full((1,) + shape, fill, dtype)])
        return np.concatenate(out).astype(dtype)

    prim_np = cat_or_empty(all_prim, (w,), np.int32, -1)
    node_packed = _pack_rows(node_min, node_max, node_a, node_b, node_kind,
                             node_esc)

    bundle_packed = np.zeros((len(prim_np), w, 12), np.float32)
    bundle_packed[:, :, 0:3] = cat_or_empty(all_v0, (w, 3))
    bundle_packed[:, :, 3:6] = cat_or_empty(all_e1, (w, 3))
    bundle_packed[:, :, 6:9] = cat_or_empty(all_e2, (w, 3))
    bundle_packed[:, :, 9] = prim_np.view(np.float32)

    offsets = sorted(blas_by_offset.keys())
    out = dict(
        node_packed=node_packed,
        bundle_packed=bundle_packed,
        inst_transform=tf,
        inst_inv=inv,
        inst_id=device_instances["instanceID"].astype(np.int32),
        inst_custom=device_instances["customInstanceID"].astype(np.int32),
        inst_sbt=device_instances["SBTOffset"].astype(np.int32),
        inst_blas_root=blas_root,
        kblas=(None if not want_ktables
               else tuple(kblas_by_offset[off] for off in offsets)),
        inst_kblas=(None if not want_ktables else tuple(
            offsets.index(int(r["bottomAccelStructOffset"]))
            for r in device_instances)),
        stable_frames=(
            bool(ktables["stable"]) if ktables is not None
            else (bool(next(iter(kblas_by_offset.values()))["stable"])
                  if want_ktables and kblas_by_offset else False)),
        leaf_cap=leaf_cap,
        collapse=collapse,
        rho=rho,
    )
    for k in ("knode_f", "kleaf", "kprim", "ktri_geo"):
        out[k] = None if ktables is None else ktables[k]
    return out


_ARRAY_FIELDS = ("node_packed", "bundle_packed", "inst_transform",
                 "inst_inv", "inst_id", "inst_custom", "inst_sbt",
                 "inst_blas_root", "knode_f", "kleaf", "kprim", "ktri_geo")
_KBLAS_FIELDS = ("knode_f", "kleaf", "kprim", "ktri_geo")


def _tensor(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:
        x = x.copy()
    return torch.from_numpy(x).to(device)


def scene_from_numpy(arrays: Mapping, stable_frames: bool,
                     device) -> DeviceScene:
    """DeviceScene from numpy arrays of the same state.

    arrays: the DeviceScene fields as numpy arrays -- either a JAX
    DeviceScene's fields (np.asarray of each; extra fields such as
    node_min are ignored) or build_scene_arrays' output.  kblas may be
    a tuple of 4-tuples (the JAX layout) or of table dicts; inst_kblas a
    tuple of ints or None.  The leaf cap is the tables' own (kleaf's
    width over 4, the single-instance or the first BLAS's), 128 where
    there are none; collapse and rho are the arrays' own where they hold
    them (build_scene_arrays' output), else the greedy default.  This is
    how the two packages are made to hold the same scene state.
    """
    from radiance_tpu_torch.bvh import kernel_pack

    fields = {k: _tensor(arrays.get(k), device) for k in _ARRAY_FIELDS}
    kblas = arrays.get("kblas")
    if kblas is not None:
        kblas = tuple(
            tuple(_tensor(e[k] if isinstance(e, Mapping) else e[i], device)
                  for i, k in enumerate(_KBLAS_FIELDS))
            for e in kblas)
    widths = {int(kl.shape[2]) // 4 for kl in
              ([fields["kleaf"]] if fields["kleaf"] is not None else [])
              + [e[1] for e in kblas or ()]}
    if len(widths) > 1:
        raise ValueError(f"kernel tables of leaf widths {sorted(widths)}: "
                         f"every BLAS of a scene shares one leaf cap")
    inst_kblas = arrays.get("inst_kblas")
    collapse, rho = kernel_pack.check_collapse(
        arrays.get("collapse", "greedy"),
        arrays.get("rho", kernel_pack.DEFAULT_RHO))
    return DeviceScene(
        **fields, kblas=kblas,
        inst_kblas=None if inst_kblas is None else tuple(
            int(i) for i in inst_kblas),
        stable_frames=bool(stable_frames),
        leaf_cap=kernel_pack.check_leaf_cap(
            widths.pop() if widths else kernel_pack.KERNEL_MAX_TRIS),
        collapse=collapse, rho=rho)


def update_tlas(scene: DeviceScene, tlas_nodes: np.ndarray,
                device_instances: np.ndarray, blas_root_by_offset: dict,
                capacity: int,
                leaf_width: int = config.LEAF_WIDTH) -> DeviceScene:
    """Animated-transform refit: rewrite the TLAS block and the instance
    arrays of `scene` in place (copy_, the JAX package's donation), and
    return it.  BLAS rows, bundles and kernel tables stay; what crosses to
    the device is capacity * 32 B and the instance arrays.

    A new TLAS may put the instances in another leaf order, so each
    slot's kernel-table entry (inst_kblas) is derived anew from its BLAS
    root, and the instance scan's cached tables (scene.multi) follow the
    new slots and transforms.  (The JAX update_tlas keeps inst_kblas as it
    was: see ROADMAP.md queue 3.)
    """
    packed = _prepare_tlas_block(tlas_nodes, leaf_width, capacity)
    tf, inv, blas_root = _instance_arrays(device_instances,
                                          blas_root_by_offset)
    if len(blas_root) != scene.inst_inv.shape[0]:
        raise ValueError("a refit keeps the scene's instance count")
    scene.node_packed[:capacity].copy_(torch.from_numpy(packed))
    for name, arr in (
            ("inst_transform", tf), ("inst_inv", inv),
            ("inst_id", device_instances["instanceID"].astype(np.int32)),
            ("inst_custom",
             device_instances["customInstanceID"].astype(np.int32)),
            ("inst_sbt", device_instances["SBTOffset"].astype(np.int32)),
            ("inst_blas_root", blas_root)):
        getattr(scene, name).copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    if scene.inst_kblas is not None:
        # kblas is in BLAS layout order, the order of the BLAS root rows
        roots = sorted(set(blas_root_by_offset.values()))
        scene.inst_kblas = tuple(roots.index(int(r)) for r in blas_root)
    if scene.multi is not None:
        scene.multi.refit_aabbs(scene)
    return scene


def build_device_scene(tlas_nodes: np.ndarray,
                       device_instances: np.ndarray,
                       blas_by_offset: dict,
                       leaf_width: int = config.LEAF_WIDTH,
                       tlas_capacity: int = 0,
                       *, stable_frames: bool = True,
                       leaf_cap: int = 128, collapse: str = "greedy",
                       rho: float = 0.15,
                       device=rdevice.DEFAULT) -> DeviceScene:
    """Assemble the DeviceScene from parsed/built host arrays.

    tlas_nodes: DEVICE_BVH_NODE_DTYPE array
    device_instances: DEVICE_INSTANCE_DTYPE array (leaf order)
    blas_by_offset: {byteOffset: (nodes, faces, verts[V,>=3])}
    tlas_capacity: pad the TLAS block to this many rows; 0 = exact size.
    stable_frames: kernel-table frame mode (the JAX default is stable).
    leaf_cap: triangles per kernel leaf, a multiple of 32 in [32, 512]
    (the JAX package's RADIANCE_LEAF_CAP; 64 with tq_bits 7 is its
    LEAF64 configuration for 1M-triangle scenes).
    collapse, rho: the leaf collapse, "greedy" or "sah" with its rho (the
    JAX package's RADIANCE_COLLAPSE and RADIANCE_COLLAPSE_RHO;
    kernel_pack.build_kernel_tables), recorded on the DeviceScene.
    device: where the tensors are made (the card unless the caller
    asks for the CPU).
    """
    device = rdevice.resolve(device)
    arrays = build_scene_arrays(tlas_nodes, device_instances,
                                blas_by_offset, leaf_width, tlas_capacity,
                                stable_frames, leaf_cap, collapse, rho)
    return scene_from_numpy(arrays, arrays["stable_frames"], device)


def device_scene_from_instances(instances, *, leaf_cap: int = 128,
                                collapse: str = "greedy", rho: float = 0.15,
                                device=rdevice.DEFAULT) -> DeviceScene:
    """Host-build path: RD-style instances -> DeviceScene on `device` (no
    blob round trip)."""
    tlas_nodes, dev_inst, blas_offsets, _ = builder.build_tlas_arrays(
        list(instances))
    blas_by_offset = {off: (b.nodes, b.faces, b.vertices)
                      for off, b in blas_offsets}
    return build_device_scene(tlas_nodes, dev_inst, blas_by_offset,
                              leaf_cap=leaf_cap, collapse=collapse, rho=rho,
                              device=device)


def device_scene_from_tlas_blob(blob: bytes, *, leaf_cap: int = 128,
                                collapse: str = "greedy", rho: float = 0.15,
                                device=rdevice.DEFAULT) -> DeviceScene:
    """Cache-load path: serialized TLAS blob -> DeviceScene on `device`."""
    parsed = serialize.parse_tlas(blob)
    return build_device_scene(parsed.nodes, parsed.instances, parsed.blas,
                              leaf_cap=leaf_cap, collapse=collapse, rho=rho,
                              device=device)
