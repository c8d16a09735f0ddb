"""The stream3 pipeline's kernel stages: six CUDA kernels, their plain
PyTorch versions, and the word-format constants they share.

Port of the Pallas kernels of radiance_tpu/ops/stream3.py (ops/stream3.py
drives them):

  A  rows_from_aos_fast,
     transpose_rows   csrc/s3_transpose.cu   <- _aos2rows_kernel (:1595),
                                                _transpose_kernel (:1575)
  B  stage_emit       csrc/s3_emit.cu        <- _emit3_kernel (:595),
                                                _emit3t_kernel (:753),
                                                _emit3ws_kernel (:1031),
                                                _emit3wst_kernel (:1257)
  C  stage_refine     csrc/s3_refine.cu      <- _refine3_kernel (:1635)
  D  stage_isect      csrc/s3_isect.cu       <- _isect3_kernel (:1853)
  E  stage_isect(occl=True)
                      csrc/s3_isect_occl.cu  <- _isect3_occl_kernel (:2100)
  F  octant_scalars   csrc/s3_oscal.cu       <- _oscal_kernel (:294)

Each stage takes its kernel for CUDA tensors (no fallback: a failed
launch raises) and its plain version for CPU tensors.  The plain
versions are vectorised over slots or packets: emit finds each slot's
walk by pointer doubling over its table's successors, refine and both
pair intersections loop over word positions.
Each kernel wrapper launches with its tensors' device made current
(cuda_build.on_device) and counts its launches in `<wrapper>.launches`.

Word format: one i32 per emitted (leaf, slot) pair, (leaf + 1) <<
leaf_shift | keepmask << keep_shift | tq (WordFormat; by default the
compiled-TPU format, 9 tq bits: (leaf + 1) << 17 | keepmask << 9 | tq).
keepmask has one bit per 128-ray block of the slot's packet; tq is a
quantised lower bound on the leaf's entry distance: C's sort form orders
a list by it, D's cull and the temporal cull (stream3._apply_block_bound)
compare it with a bound.  A narrower tq (tq_bits 5..9, the JAX package's
RADIANCE_TQ_BITS) addresses more leaves: 7 bits reach 65,534, enough for
a 1M-triangle scene built with a leaf cap of 64 (22,605 leaves on the
city).  Every stage takes tq_bits (default 9); B, C, D and E are built
once for each width a process uses, D and E also for each leaf width T
of the scene's tables (kleaf [Nl, 16, 4T], T its leaf cap), as
separate libraries (_spec): the default (T 128, 9 bits) compiles the
sources as they read.

Forms of C and D beside the default ones, as in the JAX module (each off
by default): C's tq sort (sort=True, _refine3_kernel(sort=True)); D's
lean form (lean=True: no barycentrics, stream3._winner_barys recomputes
the winner's) and its tq occlusion cull (cull=True).  Their launches also
count in refine_cuda.sort_launches, isect_cuda.lean_launches and
isect_cuda.cull_launches.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from radiance_tpu_torch.bvh.kernel_pack import KERNEL_MAX_TRIS, check_leaf_cap
from radiance_tpu_torch.ops import cuda_build

T = KERNEL_MAX_TRIS         # triangles per kernel leaf at the default cap
G = 8                       # slot pad granularity (the TPU walk's group)
PKT = 1024                  # rays per packet (= walk slot granularity)
BLK = 128                   # rays per phase-2 block (8 per packet)
PCAP = 1024                 # emitted words per slot
EXTRA = 256                 # sub-walk slot pool for mixed-octant packets
STEP_CAP = 2048             # step windows per slot before its packet flags
STEP_ROWS = 8               # node rows of a step window (check_step_rows)
EMIT_WINDOW = 32            # node rows kernel B loads per dependent load
REFINE_SUB = 32             # rays per emit-refine sub-frustum
NLANES = 8 * (BLK // REFINE_SUB)    # sub-frusta per packet (32)


def check_step_rows(rows) -> int:
    """The rows of kernel B's step window as an int, or ValueError: 1..8.
    The reference's compiled walks (_emit3t_kernel, _emit3wst_kernel)
    count STEP_CAP in aligned 8-row node windows, its node walk
    (_emit3_kernel, _emit3ws_kernel) in nodes, that is windows of 1."""
    if (isinstance(rows, bool) or not isinstance(rows, int)
            or not 1 <= rows <= 8):
        raise ValueError(f"step_rows must be in [1, 8], got {rows}")
    return rows


def check_tq_bits(bits) -> int:
    """The tq width as an int, or ValueError where the JAX package's
    _apply_tq_bits (stream3.py:122-152) refuses it: 5..9."""
    if (isinstance(bits, bool) or not isinstance(bits, int)
            or not 5 <= bits <= 9):
        raise ValueError(f"RADIANCE_TQ_BITS must be in [5, 9], got {bits} "
                         f"(tq_bits)")
    return bits


@dataclasses.dataclass(frozen=True)
class WordFormat:
    """The word format of a tq width (stream3.py::_apply_tq_bits):
    tq = clamp((f32 bits of max(tn, 0) >> tq_shift) - tq_bias3, 0,
    tq_mask), 4 exponent bits and tq_bits - 4 mantissa bits covering tn in
    [0.25, 16384), a lower bound on tn; the keep mask above it, the leaf
    id + 1 above that, below leaf_max; C's sort buckets are tq >>
    bucket_shift (32 of them).  Build through word_format()."""
    tq_bits: int
    keep_shift: int = dataclasses.field(init=False)
    leaf_shift: int = dataclasses.field(init=False)
    tq_mask: int = dataclasses.field(init=False)
    tq_shift: int = dataclasses.field(init=False)
    tq_bias3: int = dataclasses.field(init=False)
    bucket_shift: int = dataclasses.field(init=False)
    leaf_max: int = dataclasses.field(init=False)

    def __post_init__(self):
        b = check_tq_bits(self.tq_bits)
        for k, v in dict(keep_shift=b, leaf_shift=b + 8,
                         tq_mask=(1 << b) - 1, tq_shift=27 - b,
                         tq_bias3=125 << (b - 4), bucket_shift=b - 5,
                         leaf_max=1 << (31 - (b + 8))).items():
            object.__setattr__(self, k, v)

    def leaf(self, words):
        """The leaf id of each word (0 for an empty word)."""
        return torch.clamp((words >> self.leaf_shift) - 1, min=0)

    def keep(self, words):
        """The keep mask of each word (one bit per 128-ray block)."""
        return (words >> self.keep_shift) & 255


@functools.lru_cache(maxsize=None, typed=True)
def word_format(tq_bits: int = 9) -> WordFormat:
    return WordFormat(check_tq_bits(tq_bits))


# the default (9-bit) format's values, under the JAX module's names
_W9 = word_format(9)
W_TQ_BITS = _W9.tq_bits
W_KEEP_SHIFT = _W9.keep_shift
W_LEAF_SHIFT = _W9.leaf_shift
W_TQ_MASK = _W9.tq_mask
TQ_SHIFT = _W9.tq_shift
TQ_BIAS3 = _W9.tq_bias3
TQ_BUCKET_SHIFT = _W9.bucket_shift   # 32 tq counting-sort buckets
W_LEAF_MAX = _W9.leaf_max            # leaf + 1 must stay below this

FMAX = 3.4028234663852886e38    # float32 max, exactly representable
BIG = 1e30

_P, _I32, _I64, _F32 = cuda_build.P, cuda_build.I32, cuda_build.I64, \
    cuda_build.F32
LIBS = {
    "transpose": cuda_build.KernelLib("s3_transpose", (
        ("rt_s3_aos_rows", (_P, _P, _I64, _P, _I32, _P)),
        ("rt_s3_rows16_major", (_P, _I64, _P, _I32, _P)))),
    # emit and refine: only products, differences and comparisons; without
    # FMA contraction their word lists are bit-identical to the plain
    # versions'
    "emit": cuda_build.KernelLib("s3_emit", (
        ("rt_s3_emit", (_P, _P, _P, _P, _I32, _I32, _F32, _I32, _I32, _I32,
                        _P, _P, _P)),
        ("rt_s3_emit_window", ())), ("-fmad=false",)),
    "refine": cuda_build.KernelLib("s3_refine", (
        ("rt_s3_refine", (_P, _P, _P, _P, _I64, _P, _I32, _I32, _F32, _I32,
                          _I32, _P, _P, _P, _P, _P, _P)),
        ("rt_s3_refine_grid", ())), ("-fmad=false",)),
    "isect": cuda_build.KernelLib("s3_isect", (
        ("rt_s3_isect", (_P, _P, _P, _P, _P, _I32, _I32, _F32, _F32, _I32,
                         _I32, _I32, _P, _P, _P, _P)),)),
    "isect_occl": cuda_build.KernelLib("s3_isect_occl", (
        ("rt_s3_isect_occl", (_P, _P, _P, _P, _P, _I32, _I32, _F32, _F32,
                              _I32, _P, _P)),)),
    # oscal: minima, maxima, |d| and an IEEE division, built as emit and
    # refine are so that no contraction creeps in: its scalars must equal
    # the plain version's
    "oscal": cuda_build.KernelLib("s3_oscal", (
        ("rt_s3_oscal", (_P, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _P,
                         _P, _P)),), ("-fmad=false",)),
}


# the kernels whose source reads the tq width / the leaf width T
_TQ_KEYS = ("emit", "refine", "isect", "isect_occl")
_T_KEYS = ("isect", "isect_occl")


@functools.lru_cache(maxsize=None)
def _spec(key: str, leaf_cap: int = KERNEL_MAX_TRIS,
          tq_bits: int = W_TQ_BITS) -> cuda_build.KernelLib:
    """LIBS[key] built for leaf width leaf_cap and tq width tq_bits: the
    library itself at the defaults (or where the kernel reads neither),
    else a variant lib<name>_t<cap>_q<bits>.so with the source's
    RT_LEAF_T / RT_TQ_BITS defines."""
    check_leaf_cap(leaf_cap)
    check_tq_bits(tq_bits)
    defines, suffix = {}, ""
    if key in _T_KEYS and leaf_cap != KERNEL_MAX_TRIS:
        defines["RT_LEAF_T"] = leaf_cap
        suffix += f"_t{leaf_cap}"
    if key in _TQ_KEYS and tq_bits != W_TQ_BITS:
        defines["RT_TQ_BITS"] = tq_bits
        suffix += f"_q{tq_bits}"
    return LIBS[key].variant(suffix, defines)


def variant_libs(leaf_cap: int = KERNEL_MAX_TRIS,
                 tq_bits: int = W_TQ_BITS):
    """The libraries the pipeline launches on tables of leaf cap
    `leaf_cap` at tq width `tq_bits` (for load_all)."""
    return list(dict.fromkeys(_spec(k, leaf_cap, tq_bits) for k in LIBS))


def load_kernels(leaf_cap: int = KERNEL_MAX_TRIS, tq_bits: int = W_TQ_BITS):
    """Build (in parallel, where stale) and load the six libraries, for a
    leaf cap and tq width (the defaults: the sources as they read)."""
    return cuda_build.load_all(variant_libs(leaf_cap, tq_bits))


def _lib(key: str, leaf_cap: int = KERNEL_MAX_TRIS,
         tq_bits: int = W_TQ_BITS):
    return cuda_build.load(_spec(key, leaf_cap, tq_bits))


def leaf_width(kleaf: torch.Tensor) -> int:
    """T of [Nl, 16, 4T] leaf tables, checked as a leaf cap."""
    if kleaf.dim() != 3 or kleaf.shape[1] != 16 or kleaf.shape[2] % 4:
        raise ValueError(f"kleaf must be [Nl, 16, 4T], got "
                         f"{tuple(kleaf.shape)}")
    return check_leaf_cap(kleaf.shape[2] // 4)


def _cuda_only(fn: str, x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors")
    return x.device


def _route(x: torch.Tensor) -> str:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"stream3: no route for device {x.device}")


# ---------------------------------------------------------------------------
# A. transpose
# ---------------------------------------------------------------------------

def _aligned(*xs) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in xs)


def aos_rows_cuda(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Kernel A, AoS -> rows: [N, 3] f32 o and d -> one [6, N] f32 buffer
    (ox, oy, oz, dx, dy, dz) in one launch, bit-exact with
    torch.cat([o.t(), d.t()])."""
    dev = _cuda_only("aos_rows_cuda", o)
    chk = functools.partial(cuda_build.check_tensor, "aos_rows_cuda",
                            dev=dev)
    chk("o", o, torch.float32, (None, 3))
    n = o.shape[0]
    chk("d", d, torch.float32, (n, 3))
    out = torch.empty(6, n, dtype=torch.float32, device=dev)
    if n:
        with cuda_build.on_device(dev) as stream:
            err = _lib("transpose").rt_s3_aos_rows(
                o.data_ptr(), d.data_ptr(), n, out.data_ptr(),
                int(_aligned(o, d, out)), stream)
        cuda_build.check_launch("s3_aos_rows", err)
        cuda_build.count_launch(aos_rows_cuda)
    return out


aos_rows_cuda.launches = 0


def transpose_cuda(src: torch.Tensor, out: torch.Tensor = None
                   ) -> torch.Tensor:
    """Kernel A, rows -> ray-major: [16, C] f32 -> [C, 16] f32 (bit-exact
    .t().contiguous()).  out, if given, is a contiguous [C, 16] f32
    tensor to write into."""
    dev = _cuda_only("transpose_cuda", src)
    chk = functools.partial(cuda_build.check_tensor, "transpose_cuda",
                            dev=dev)
    chk("src", src, torch.float32, (16, None))
    c = src.shape[1]
    if out is None:
        out = torch.empty(c, 16, dtype=torch.float32, device=dev)
    chk("out", out, torch.float32, (c, 16))
    if c:
        with cuda_build.on_device(dev) as stream:
            err = _lib("transpose").rt_s3_rows16_major(
                src.data_ptr(), c, out.data_ptr(),
                int(c % 4 == 0 and _aligned(src, out)), stream)
        cuda_build.check_launch("s3_rows16_major", err)
        cuda_build.count_launch(transpose_cuda)
    return out


transpose_cuda.launches = 0


def transpose_rows(src: torch.Tensor, out: torch.Tensor = None
                   ) -> torch.Tensor:
    """[R, C] -> [C, R]: kernel A on CUDA tensors (R = 16, the phase-2
    features), .t().contiguous() (its plain version) on CPU tensors."""
    if _route(src) == "cuda":
        return transpose_cuda(src, out)
    res = src.t().contiguous()
    if out is not None:
        out.copy_(res)
        return out
    return res


def rows_from_aos_fast(origin: torch.Tensor, direction: torch.Tensor):
    """[N, 3] o/d -> six contiguous [N] f32 rows (ox, oy, oz, dx, dy, dz)
    of one [6, N] buffer: kernel A's one launch on CUDA tensors, two
    transposes on CPU tensors."""
    o = origin.to(torch.float32).contiguous()
    d = direction.to(torch.float32).contiguous()
    if _route(o) == "cuda":
        return tuple(aos_rows_cuda(o, d))
    n = o.shape[0]
    out = torch.empty(6, n, dtype=torch.float32, device=o.device)
    transpose_rows(o, out[0:3])
    transpose_rows(d, out[3:6])
    return tuple(out[k] for k in range(6))


def feats_rows_to_major(feats_t: torch.Tensor) -> torch.Tensor:
    """[16, Npad] phase-2 features -> ray-major [Npad, 16]."""
    return transpose_rows(feats_t.contiguous())


# ---------------------------------------------------------------------------
# F. prep octant scalars
# ---------------------------------------------------------------------------

def _interval_scalars(oc, dc, mask=None):
    """Interval-frustum scalars for one axis over a ray-group axis:
    oc, dc [ngrp, g] -> (sgn, olo, ohi, ilo, ihi) [ngrp].  With `mask`,
    rays outside the subset are ignored."""
    def lo_hi(v, lo_fill, hi_fill):
        if mask is None:
            return v.amin(dim=1), v.amax(dim=1)
        return (torch.where(mask, v, lo_fill).amin(dim=1),
                torch.where(mask, v, hi_fill).amax(dim=1))

    dmin, dmax = lo_hi(dc, BIG, -BIG)
    neg = dmax < 0.0
    sgn = torch.where(dmin > 0.0, 1.0, torch.where(neg, -1.0, 0.0))
    osn = oc * torch.where(neg, -1.0, 1.0)[:, None]
    olo, ohi = lo_hi(osn, BIG, -BIG)
    inv = torch.clamp(1.0 / torch.clamp(dc.abs(), min=1e-30), max=BIG)
    ilo, ihi = lo_hi(inv, BIG, 0.0)
    return sgn, olo, ohi, ilo, ihi


def group_scalars(rows, group, mask=None):
    """[ngrp, 16] scalar rows (sgn3, olo3, ohi3, ilo3, ihi3, pad) for
    every `group`-ray window of the six component rows."""
    ox, oy, oz, dx, dy, dz = rows
    ngrp = ox.shape[0] // group
    cols = [[], [], [], [], []]
    for oc, dc in ((ox, dx), (oy, dy), (oz, dz)):
        vals = _interval_scalars(oc.reshape(ngrp, group),
                                 dc.reshape(ngrp, group), mask)
        for lst, v in zip(cols, vals):
            lst.append(v)
    flat = [v for lst in cols for v in lst]
    flat.append(torch.zeros(ngrp, dtype=torch.float32, device=ox.device))
    return torch.stack(flat, dim=1)


def _oscal_plain(rows, live, npk):
    """Plain version of kernel F: the XLA formulation of the octant
    scalars (stream3.py::_octant_scalars, :411-446), [npk, 8, PKT]
    broadcasts reduced over the packet axis, and the reference prep's
    32-ray sub-frustum rows (stream3.py::_stage_prep, :509-515)."""
    ox, oy, oz, dx, dy, dz = rows
    dev = ox.device
    oct_of = ((dx < 0).to(torch.int64) + 2 * (dy < 0).to(torch.int64)
              + 4 * (dz < 0).to(torch.int64)).reshape(npk, 1, PKT)
    omask = oct_of == torch.arange(8, device=dev)[None, :, None]
    if live is not None:
        omask = omask & live.reshape(npk, 1, PKT)
    present = omask.any(dim=2)
    cols = []
    for oc, dc in ((ox, dx), (oy, dy), (oz, dz)):
        ocp = oc.reshape(npk, 1, PKT)
        dcp = dc.reshape(npk, 1, PKT)
        dmin = torch.where(omask, dcp, BIG).amin(dim=2)
        dmax = torch.where(omask, dcp, -BIG).amax(dim=2)
        sgn = torch.where(dmin > 0.0, 1.0,
                          torch.where(dmax < 0.0, -1.0, 0.0))
        osn = ocp * torch.where(dmax < 0.0, -1.0, 1.0)[:, :, None]
        olo = torch.where(omask, osn, BIG).amin(dim=2)
        ohi = torch.where(omask, osn, -BIG).amax(dim=2)
        inv = torch.clamp(1.0 / torch.clamp(dcp.abs(), min=1e-30), max=BIG)
        ilo = torch.where(omask, inv, BIG).amin(dim=2)
        ihi = torch.where(omask, inv, 0.0).amax(dim=2)
        cols.append((sgn, olo, ohi, ilo, ihi))
    cand = torch.stack(
        [cols[k][f] for f in range(5) for k in range(3)]
        + [torch.zeros(npk, 8, dtype=torch.float32, device=dev)], dim=2)
    full_pkt = group_scalars(
        rows, PKT, mask=None if live is None else live.reshape(npk, PKT))
    # sub-major within each packet: sub s of 128-ray block j at row s*8 + j
    bscal = group_scalars(
        rows, REFINE_SUB,
        mask=None if live is None else live.reshape(-1, REFINE_SUB)) \
        .reshape(npk, 8, BLK // REFINE_SUB, 16).transpose(1, 2) \
        .reshape(npk * NLANES, 16)
    return cand, present, full_pkt, bscal


def oscal_cuda(rows, live, npk):
    """Kernel F: (cand [npk, 8, 16] f32, present [npk, 8] bool, full_pkt
    [npk, 16] f32, bscal [npk * NLANES, 16] f32) from six contiguous
    [npk * PKT] f32 rows and an optional [npk * PKT] bool live mask."""
    dev = _cuda_only("oscal_cuda", rows[0])
    chk = functools.partial(cuda_build.check_tensor, "oscal_cuda", dev=dev)
    for k, r in enumerate(rows):
        chk(f"rows[{k}]", r, torch.float32, (npk * PKT,))
    if live is not None:
        chk("live", live, torch.bool, (npk * PKT,))
    cand = torch.empty(npk, 8, 16, dtype=torch.float32, device=dev)
    present = torch.empty(npk, 8, dtype=torch.bool, device=dev)
    full = torch.empty(npk, 16, dtype=torch.float32, device=dev)
    bscal = torch.empty(npk * NLANES, 16, dtype=torch.float32, device=dev)
    if npk:
        with cuda_build.on_device(dev) as stream:
            err = _lib("oscal").rt_s3_oscal(
                *(r.data_ptr() for r in rows),
                None if live is None else live.data_ptr(), int(npk),
                cand.data_ptr(), present.data_ptr(), full.data_ptr(),
                bscal.data_ptr(), stream)
        cuda_build.check_launch("s3_oscal", err)
        cuda_build.count_launch(oscal_cuda)
    return cand, present, full, bscal


oscal_cuda.launches = 0


def octant_scalars(rows, live, npk):
    """(cand [npk, 8, 16], present [npk, 8] bool, full_pkt [npk, 16],
    bscal [npk * NLANES, 16]): per (packet, direction octant) interval
    scalars with lane 15 zero, octant presence, the whole-packet scalars
    and the 32-ray sub-frustum rows (sub s of 128-ray block j at row
    s * 8 + j of its packet), over the member rays of `live` (all rays
    if None).  Kernel F on CUDA tensors
    -- the JAX package's opt-in single-pass form, bit-identical to its
    XLA form by the reference's own statement (stream3.py:303-305),
    with the prep's sub-frustum rows taken in the same pass -- and the
    XLA form on CPU tensors."""
    fn = oscal_cuda if _route(rows[0]) == "cuda" else _oscal_plain
    return fn(rows, live, npk)


# ---------------------------------------------------------------------------
# B. emit walk
# ---------------------------------------------------------------------------

def _interval_test(bmn, bmx, s, tf0):
    """Interval-frustum box test of node bounds bmn/bmx [..., 3] against
    frustum scalars s [..., 16] (sgn3, olo3, ohi3, ilo3, ihi3): (tn, tf).
    Sign-mixed axes pass (tn 0, tf FMAX), as in _emit3_kernel :653-689."""
    tn = torch.zeros_like(bmn[..., 0])
    tf = torch.full_like(tn, tf0)
    fmax = torch.full_like(tn, FMAX)
    zero = torch.zeros_like(tn)
    for k in range(3):
        sk = s[..., k]
        m0 = sk * bmn[..., k]
        m1 = sk * bmx[..., k]
        lo = torch.minimum(m0, m1) - s[..., 6 + k]
        hi = torch.maximum(m0, m1) - s[..., 3 + k]
        tnk = lo * torch.where(lo >= 0.0, s[..., 9 + k], s[..., 12 + k])
        tfk = hi * torch.where(hi >= 0.0, s[..., 12 + k], s[..., 9 + k])
        mixed = sk == 0.0
        tn = torch.maximum(tn, torch.where(mixed, zero, tnk))
        tf = torch.minimum(tf, torch.where(mixed, fmax, tfk))
    return tn, tf


# slots a pass of _walk_paths holds: its [slots, table rows] tensors stay
# near 2^21 elements
PATH_ELEMS = 1 << 21


def _jump_rounds(n: int) -> int:
    """Pointer-doubling rounds that cover a chain of n links."""
    return max(int(n), 1).bit_length() + 1


def _walk_paths(nodef, scal, smeta, tmax, step_cap, rows):
    """The walk of every slot, as kernel B walks it, in passes of slots:
    yields (slots [k], base [k], row [k, A, 11], tn [k, A], box_hit [k,
    A], walked [k, A] bool, steps [k], capped [k]) for the A rows of each
    slot's octant table (table-local rows 0..A-1; rows past a slot's table
    are never walked).

    The tables are preorder with escape threading, so every successor
    (the child, or the escape row) lies past its node: the walk is the
    chain of successors from row 0, found here by pointer doubling over
    every row's successor at once instead of a step at a time.  Step
    windows (step_rows rows, the reference's compiled count at 8) are
    aligned blocks of rows from the table base, the block that starts
    past nrows - rows clamped GLOBALLY at the end of nodef (stream3.py:
    1341-1351), so that window takes every later row; a walk keeps the
    nodes of its first step_cap windows and is capped where a node of
    window step_cap + 1 follows."""
    dev = scal.device
    i64 = torch.int64
    nrows = nodef.shape[0]
    base_all = smeta[:, 2].to(i64)
    # rows of each slot's octant table that lie inside nodef (kernel B's)
    avail_all = torch.clamp(nrows - base_all, max=nrows // 8)
    amax = int(avail_all.max()) if smeta.shape[0] else 0
    per = max(PATH_ELEMS // max(amax, 1), 1)
    tmax_t = torch.tensor(tmax, dtype=torch.float32, device=dev)
    lane = torch.arange(amax + 1, device=dev)
    for lo in range(0, smeta.shape[0], per):
        sl = torch.arange(lo, min(lo + per, smeta.shape[0]), device=dev)
        base, avail = base_all[sl], avail_all[sl]
        k, n = sl.numel(), amax
        j = lane[:n]
        valid = j < avail[:, None]
        row = nodef[torch.clamp(base[:, None] + j, max=nrows - 1), :11]
        tn, tf = _interval_test(row[..., 0:3], row[..., 3:6],
                                scal[sl][:, None], float(tmax))
        box_hit = (tf >= tn) & (tn < tmax_t)
        nxt = torch.where((row[..., 10] > 0.0) | ~box_hit, row[..., 9],
                          row[..., 8]).to(i64)
        # successors as indices into [0, n]; n: the walk has ended
        jump = torch.cat([torch.where(valid & (nxt > j) & (nxt < n), nxt, n),
                          torch.full((k, 1), n, dtype=i64, device=dev)], 1)
        reach = torch.zeros(k, n + 1, dtype=torch.bool, device=dev)
        reach[:, 0] = smeta[sl, 1] > 0
        for _ in range(_jump_rounds(n)):
            reach |= torch.zeros(k, n + 1, dtype=torch.int32, device=dev) \
                .scatter_add_(1, jump, reach.to(torch.int32)) > 0
            jump = torch.gather(jump, 1, jump)
        on = reach[:, :n] & valid
        # step windows: aligned blocks, those past the clamp merged into one
        clamp_blk = torch.div(nrows - rows - base, rows,
                              rounding_mode="floor") + 1
        key = torch.minimum(j // rows, clamp_blk[:, None])
        nkey = n // rows + 1
        seen = torch.zeros(k, nkey, dtype=torch.int32, device=dev) \
            .scatter_add_(1, key, on.to(torch.int32)) > 0
        before = torch.cumsum(seen.to(i64), dim=1)
        wid = torch.gather(before, 1, key)          # 1-based, on the walk
        total = before[:, -1]
        walked = on & (wid <= step_cap)
        yield (sl, base, row, tn, box_hit, walked,
               torch.clamp(total, max=max(int(step_cap), 0)),
               total > step_cap)


def _window_loads(walked, window):
    """Kernel B's dependent loads of each slot's walk (walked [k, A],
    rows ascending): a load at the first node and at each node at or past
    the last load's row + window; in the loads' chain, by pointer
    doubling."""
    k, n = walked.shape
    dev = walked.device
    lane = torch.arange(n + 1, device=dev)
    at = torch.where(torch.cat([walked, torch.zeros_like(walked[:, :1])], 1),
                     lane, n)
    # the first walked row at or past each row (n: none)
    nxt = torch.flip(torch.cummin(torch.flip(at, [1]), dim=1).values, [1])
    jump = torch.gather(nxt, 1, torch.clamp(lane + window, max=n)
                        .expand(k, -1))
    jump[:, n] = n
    dist = (lane < n).to(torch.int64).expand(k, -1).clone()
    for _ in range(_jump_rounds(n)):
        dist = dist + torch.gather(dist, 1, jump)
        jump = torch.gather(jump, 1, jump)
    return torch.gather(dist, 1, nxt[:, :1]).squeeze(1)


def _emit_plain(scal, smeta, bscal, nodef, tmax, step_cap, pcap,
                stats=None, tq_bits=W_TQ_BITS, step_rows=STEP_ROWS):
    """Plain version of kernel B: each live slot's walk (_walk_paths), its
    step cap counted in step windows of step_rows rows (8: the reference's
    compiled treelet walks, _emit3t_kernel and _emit3wst_kernel; 1: its
    node walk, _emit3_kernel): a slot stops where it would begin window
    step_cap + 1, so a capped slot has walked step_cap whole windows.  At
    each walked leaf the slot frustum hits, the 32 sub-frustum tests make
    the keep mask, and a word is kept where it is not empty; words in
    walk order, in the format of tq_bits (word_format).  stats, if a dict,
    receives "steps" and "max_steps" (step windows, in all and of the
    longest slot: emeta lane 2), "nodes" and "max_nodes" (nodes visited)
    and "window_loads" and "max_window_loads": the dependent loads of
    kernel B's walk, which loads EMIT_WINDOW rows from the cursor and
    follows the walk inside them."""
    dev = scal.device
    i32, i64 = torch.int32, torch.int64
    fmt = word_format(tq_bits)
    rows = check_step_rows(step_rows)
    nslot = scal.shape[0]
    tmax_t = torch.tensor(tmax, dtype=torch.float32, device=dev)
    words = torch.zeros(nslot, pcap, dtype=i32, device=dev)
    cnt = torch.zeros(nslot, dtype=i64, device=dev)
    steps = torch.zeros(nslot, dtype=i64, device=dev)
    capped = torch.zeros(nslot, dtype=torch.bool, device=dev)
    nodes = torch.zeros(nslot, dtype=i64, device=dev)
    loads = torch.zeros(nslot, dtype=i64, device=dev)
    sub = bscal.view(-1, NLANES, 16)
    pow2 = (1 << torch.arange(8, device=dev)).to(i32)
    for sl, _, row, tn, box_hit, walked, st, cp in _walk_paths(
            nodef, scal, smeta, tmax, step_cap, rows):
        steps[sl], capped[sl] = st, cp
        nodes[sl] = walked.sum(dim=1)
        if stats is not None:
            loads[sl] = _window_loads(walked, EMIT_WINDOW)
        # the walked leaves the slot frustum hits, in walk order
        s, r = torch.nonzero(walked & (row[..., 10] > 0.0) & box_hit,
                             as_tuple=True)
        per = PATH_ELEMS // NLANES
        for q in range(0, s.numel(), per):
            s_q, r_q = s[q:q + per], r[q:q + per]
            node = row[s_q, r_q]
            tn_b, tf_b = _interval_test(
                node[:, None, 0:3], node[:, None, 3:6],
                sub[smeta[sl[s_q], 0].to(i64)], FMAX)
            keep = ((tf_b >= tn_b) & (tn_b < tmax_t)).view(-1, NLANES // 8,
                                                           8)
            kmask = (keep.any(dim=1).to(i32) * pow2).sum(dim=1, dtype=i32)
            t0 = tn[s_q, r_q]
            tq = torch.clamp((torch.maximum(t0, torch.zeros_like(t0))
                              .view(i32) >> fmt.tq_shift) - fmt.tq_bias3, 0,
                             fmt.tq_mask)
            word = (((node[:, 8].to(i32) + 1) << fmt.leaf_shift)
                    | (kmask << fmt.keep_shift) | tq)
            ok = kmask > 0
            slot, word = sl[s_q[ok]], word[ok]
            # each word's place in its slot's list: pairs are in slot order
            first = torch.searchsorted(slot, slot, right=False)
            pos = cnt[slot] + torch.arange(slot.numel(), device=dev) - first
            wr = pos < pcap
            words[slot[wr], pos[wr]] = word[wr]
            cnt.index_add_(0, slot, torch.ones_like(slot))
    emeta = torch.zeros(nslot, 8, dtype=i32, device=dev)
    emeta[:, 0] = cnt.to(i32)
    emeta[:, 1] = capped.to(i32)
    emeta[:, 2] = steps.to(i32)
    if stats is not None:
        stats.update(steps=int(steps.sum()),
                     max_steps=int(steps.max()) if nslot else 0,
                     nodes=int(nodes.sum()),
                     max_nodes=int(nodes.max()) if nslot else 0,
                     window_loads=int(loads.sum()),
                     max_window_loads=int(loads.max()) if nslot else 0)
    return words, emeta


def emit_cuda(scal, smeta, bscal, nodef, tmax, step_cap, pcap,
              tq_bits=W_TQ_BITS, step_rows=STEP_ROWS):
    """Kernel B: (words [nslot, pcap] i32, emeta [nslot, 8] i32), words
    in the format of tq_bits (its library built for that width), the step
    cap counted in windows of step_rows rows (_emit_plain).  Only the
    first min(emeta[:, 0], pcap) words of a row are defined."""
    dev = _cuda_only("emit_cuda", scal)
    chk = functools.partial(cuda_build.check_tensor, "emit_cuda",
                            dev=dev)
    nslot = scal.shape[0]
    chk("scal", scal, torch.float32, (nslot, 16))
    chk("smeta", smeta, torch.int32, (nslot, 8))
    chk("bscal", bscal, torch.float32, (None, 16))
    chk("nodef", nodef, torch.float32, (None, 16))
    if bscal.shape[0] % NLANES or nodef.shape[0] % 8:
        raise ValueError("emit_cuda: bscal rows must be a multiple of 32 "
                         "and nodef rows of 8")
    if not _aligned(nodef):
        raise ValueError("emit_cuda: nodef must be 16-byte aligned")
    step_rows = check_step_rows(step_rows)
    words = torch.empty(nslot, pcap, dtype=torch.int32, device=dev)
    emeta = torch.empty(nslot, 8, dtype=torch.int32, device=dev)
    if nslot:
        with cuda_build.on_device(dev) as stream:
            err = _lib("emit", tq_bits=tq_bits).rt_s3_emit(
                scal.data_ptr(), smeta.data_ptr(), bscal.data_ptr(),
                nodef.data_ptr(), nslot, nodef.shape[0], float(tmax),
                int(step_cap), step_rows, int(pcap), words.data_ptr(),
                emeta.data_ptr(), stream)
        cuda_build.check_launch("s3_emit", err)
        cuda_build.count_launch(emit_cuda)
    return words, emeta


emit_cuda.launches = 0


def stage_emit(scal, smeta, bscal, nodef, tmax, *, step_cap=STEP_CAP,
               pcap=PCAP, tq_bits=W_TQ_BITS, step_rows=STEP_ROWS):
    """Walk every slot: (words, emeta) with emeta lanes 0 count (past
    pcap on overflow), 1 capped (walk cut at step_cap step windows), 2
    step windows walked; windows of step_rows node rows (8, the default:
    the reference's compiled count; 1: its node walk); words in the
    format of tq_bits."""
    fn = emit_cuda if _route(scal) == "cuda" else _emit_plain
    return fn(scal, smeta, bscal, nodef, tmax, step_cap, pcap,
              tq_bits=tq_bits, step_rows=step_rows)


# ---------------------------------------------------------------------------
# C. exact refine
# ---------------------------------------------------------------------------

def _slot_rays(feats_t, slot_pkt, rows):
    """feats_t rows `rows` of each slot's packet: [len(rows), nslot, PKT]."""
    x = feats_t[rows].view(len(rows), -1, PKT)
    return x[:, slot_pkt.to(torch.int64)]


def tq_bucket(words, tq_bits=W_TQ_BITS):
    """The tq counting-sort bucket (0-31) of each word."""
    fmt = word_format(tq_bits)
    return (words & fmt.tq_mask) >> fmt.bucket_shift


def _refine_plain(words, emeta, slot_pkt, feats_t, aabb8, tmax, pcap,
                  sort=False, tq_bits=W_TQ_BITS):
    """Plain version of kernel C: _refine3_kernel over every slot, one
    word position per loop step; with sort, each kept list then in stable
    tq-bucket order (a stable argsort by bucket, the rest of the row
    zero)."""
    dev = words.device
    i32, i64 = torch.int32, torch.int64
    fmt = word_format(tq_bits)
    nslot = words.shape[0]
    tmax_t = torch.tensor(tmax, dtype=torch.float32, device=dev)
    cnt = torch.clamp(emeta[:, 0], max=pcap).to(i64)
    out = torch.zeros_like(words)
    kept = torch.zeros(nslot, dtype=i64, device=dev)
    live = torch.nonzero(cnt > 0).squeeze(1)
    pow2 = (1 << torch.arange(8, device=dev)).to(i32)
    if live.numel():
        x = _slot_rays(feats_t, slot_pkt[live], [0, 1, 2, 6, 7, 8])
        o, iv = x[3:6], 1.0 / x[0:3]                        # [3, k, PKT]
        for j in range(int(cnt.max())):
            q = torch.nonzero(cnt[live] > j).squeeze(1)     # into live
            s = live[q]
            w = words[s, j]
            box = aabb8[fmt.leaf(w).to(i64)]
            tn = torch.zeros(q.numel(), PKT, dtype=torch.float32, device=dev)
            tf = torch.full_like(tn, FMAX)
            for k in range(3):
                t0 = (box[:, k:k + 1] - o[k, q]) * iv[k, q]
                t1 = (box[:, 3 + k:4 + k] - o[k, q]) * iv[k, q]
                tn = torch.maximum(tn, torch.minimum(t0, t1))
                tf = torch.minimum(tf, torch.maximum(t0, t1))
            ok = (tf >= torch.maximum(tn, torch.zeros_like(tn))) \
                & (tn < tmax_t)
            kex = (ok.view(-1, 8, BLK).any(dim=2).to(i32) * pow2).sum(
                dim=1, dtype=i32)
            km = fmt.keep(w) & kex
            keep = km > 0
            w2 = (w & ~(255 << fmt.keep_shift)) | (km << fmt.keep_shift)
            out[s[keep], kept[s[keep]]] = w2[keep]
            kept[s] += keep.to(i64)
    if sort:
        pos = torch.arange(words.shape[1], device=dev)
        key = torch.where(pos[None, :] < kept[:, None],
                          tq_bucket(out, tq_bits), 32)
        out = torch.gather(out, 1, torch.argsort(key, dim=1, stable=True))
    emeta_out = emeta.clone()
    emeta_out[:, 0] = kept.to(i32)
    emeta_out[:, 4] = cnt.to(i32)
    return out, emeta_out


def refine_cuda(words, emeta, slot_pkt, feats_t, aabb8, tmax, pcap,
                sort=False, grid=0, tq_bits=W_TQ_BITS):
    """Kernel C: (words', emeta'); only the first emeta'[:, 0] words of
    a row are defined, in tq-bucket order with sort, words of the format
    of tq_bits (its library built for that width).  grid: the test
    kernel's blocks, each taking an equal share of the lists' 32-word
    chunks; 0 is the kernel's own choice, a full complement of blocks on
    every SM (refine_grid())."""
    dev = _cuda_only("refine_cuda", words)
    chk = functools.partial(cuda_build.check_tensor, "refine_cuda",
                            dev=dev)
    nslot = words.shape[0]
    chk("words", words, torch.int32, (nslot, pcap))
    chk("emeta", emeta, torch.int32, (nslot, 8))
    chk("slot_pkt", slot_pkt, torch.int32, (nslot,))
    chk("feats_t", feats_t, torch.float32, (16, None))
    chk("aabb8", aabb8, torch.float32, (None, 8))
    if feats_t.shape[1] % PKT:
        raise ValueError("refine_cuda: feats_t width must be whole packets")
    if not _aligned(feats_t, aabb8):
        raise ValueError("refine_cuda: feats_t and aabb8 must be 16-byte "
                         "aligned")
    out = torch.empty_like(words)
    emeta_out = torch.empty_like(emeta)
    if nslot:
        # one i32 scratch: the refined, uncompacted lists [nslot, pcap];
        # each slot's first 32-word chunk [nslot + 1]; each chunk's slot
        # [nslot * ceil(pcap / 32)]
        wtmp = nslot * pcap
        scratch = torch.empty(wtmp + nslot + 1 + nslot * -(-pcap // 32),
                              dtype=torch.int32, device=dev)
        at = scratch.data_ptr()
        with cuda_build.on_device(dev) as stream:
            err = _lib("refine", tq_bits=tq_bits).rt_s3_refine(
                words.data_ptr(), emeta.data_ptr(), slot_pkt.data_ptr(),
                feats_t.data_ptr(), feats_t.shape[1], aabb8.data_ptr(),
                nslot, int(pcap), float(tmax), int(grid), int(bool(sort)),
                at, at + 4 * wtmp, at + 4 * (wtmp + nslot + 1),
                out.data_ptr(), emeta_out.data_ptr(), stream)
        cuda_build.check_launch("s3_refine", err)
        cuda_build.count_launch(refine_cuda)
        if sort:
            cuda_build.count_launch(refine_cuda, "sort_launches")
    return out, emeta_out


refine_cuda.launches = 0
refine_cuda.sort_launches = 0


def refine_grid(dev) -> int:
    """Kernel C's default test grid on `dev`: its blocks an SM times the
    SMs."""
    with cuda_build.on_device(dev):
        return _lib("refine").rt_s3_refine_grid()


def emit_window() -> int:
    """The node rows kernel B loads per dependent load (its kWindow, which
    EMIT_WINDOW copies for the plain walk's statistics)."""
    return _lib("emit").rt_s3_emit_window()


def stage_refine(words, emeta, slot_pkt, feats_t, aabb8, tmax, *,
                 pcap=PCAP, sort: bool = False, tq_bits=W_TQ_BITS):
    """Exact per-ray slab refine of every word list: keep bits ANDed with
    the exact (leaf, 128-ray block) overlap, empty words dropped, order
    kept or, with sort, stable tq-bucket order (near leaves first); emeta'
    lane 0 kept count, lane 4 the pre-refine count.  Words in the format
    of tq_bits."""
    fn = refine_cuda if _route(words) == "cuda" else _refine_plain
    return fn(words, emeta, slot_pkt, feats_t, aabb8, tmax, pcap, sort,
              tq_bits=tq_bits)


# ---------------------------------------------------------------------------
# D. pair intersection (closest hit)
# ---------------------------------------------------------------------------

_ISECT_CHUNK = 256          # (slot, block) pairs per batched leaf product


def _pair_tests(x, wf, stable, tmin_t, tmax_t):
    """The Pluecker tests of c (block, leaf) pairs: rays x [c, BLK, 16]
    against leaf matrices wf [c, 16, 4T] -> (s0, s2, rv, t, ok), each
    [c, BLK, T]: the [BLK, 16] x [16, 4T] product, the stable-frame
    correction (o - c) x d, the sign test and the (tmin, tmax) window.
    The correction is added after the product, as the reference does:
    the side products cancel, so the order of their terms shows in t."""
    nt = wf.shape[2] // 4
    m = torch.bmm(x, wf)
    if stable:
        lo = x[:, :, 6:9] - wf[:, 12:15, 0][:, None, :]
        dv = x[:, :, 0:3]
        rm0 = lo[..., 1:2] * dv[..., 2:3] - lo[..., 2:3] * dv[..., 1:2]
        rm1 = lo[..., 2:3] * dv[..., 0:1] - lo[..., 0:1] * dv[..., 2:3]
        rm2 = lo[..., 0:1] * dv[..., 1:2] - lo[..., 1:2] * dv[..., 0:1]
        m = (m + rm0 * wf[:, 3:4, :] + rm1 * wf[:, 4:5, :]
             + rm2 * wf[:, 5:6, :])
    s0, s1, s2 = m[..., :nt], m[..., nt:2 * nt], m[..., 2 * nt:3 * nt]
    num = m[..., 3 * nt:]
    ssum = s0 + s1 + s2
    # the kernels' bitcast test ((i0 ^ i1) | (i1 ^ i2)) >= 0: equal signs
    g1 = torch.signbit(s1)
    inside = (torch.signbit(s0) == g1) & (g1 == torch.signbit(s2))
    rv = 1.0 / ssum                         # ssum == 0 -> inf/nan -> miss
    t = -num * rv
    return s0, s2, rv, t, inside & (t > tmin_t) & (t < tmax_t)


def _tri_lanes(kleaf):
    """[Nl] i64: each leaf's triangle lanes, those with a non-zero edge
    row 3-5 (a padded lane's are zero and can never be hit)."""
    nt = kleaf.shape[2] // 4
    return (kleaf[:, 3:6, :3 * nt].reshape(-1, 3, 3, nt) != 0) \
        .any(dim=2).any(dim=1).sum(dim=1)


def unparked(feats):
    """[Npad] bool: the rays of ray-major feats whose origin is nearer
    than 1e29 in every component; stream3.park_dead parks a dead lane at
    1e30, where the pair kernels test nothing."""
    return feats[:, 6:9].abs().amax(dim=1) < 1e29


def _isect_plain(words, emeta, slot_pkt, feats, kleaf, tmin, tmax, pcap,
                 stable, lean=False, cull=False, stats=None,
                 tq_bits=W_TQ_BITS):
    """Plain version of kernel D: for each word position, the Pluecker
    tests of every kept (slot, block) pair (_pair_tests), then a running
    per-ray best with the reference's tie rule (lower t, then lower leaf
    lane, then the earlier word).  lean leaves lanes 2-3 zero.  cull (when
    tmin >= 0) skips a pair whose word's entry bound, lb_bits(), is not
    below the largest f32 bits of its block's per-ray bests so far, as the
    TPU kernel does over a whole list (kernel D over 128-position chunks
    skips a subset of these).  stats, if a dict, receives "pairs": the
    kept (leaf, block) pairs tested, "ray_tests": their rays that are not
    parked (unparked()), "tri_tests": each such ray times its leaf's
    triangle lanes -- the ray-triangle tests the function needs -- and,
    with the cull, "culled": the pairs it skipped.  Words in the format
    of tq_bits; the leaf width is kleaf's."""
    dev = words.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    fmt = word_format(tq_bits)
    nslot = words.shape[0]
    nt = kleaf.shape[2] // 4
    tmin_t = torch.tensor(tmin, dtype=f32, device=dev)
    tmax_t = torch.tensor(tmax, dtype=f32, device=dev)
    cnt = torch.clamp(emeta[:, 0], max=pcap).to(i64)
    pairs = culled = 0
    cull = cull and tmin >= 0
    ray_tests = torch.zeros((), dtype=i64, device=dev)
    tri_tests = torch.zeros((), dtype=i64, device=dev)
    if stats is not None:
        tri_lanes = _tri_lanes(kleaf)
        act = unparked(feats).view(-1, 8, BLK).sum(dim=2)    # [npk, 8]
    best_t = torch.full((nslot, PKT), FMAX, dtype=f32, device=dev)
    best_lane = torch.full((nslot, PKT), nt, dtype=i64, device=dev)
    best_prim = torch.full((nslot, PKT), -1.0, dtype=f32, device=dev)
    best_b1 = torch.zeros(nslot, PKT, dtype=f32, device=dev)
    best_b2 = torch.zeros(nslot, PKT, dtype=f32, device=dev)
    xs = feats.view(-1, 8, BLK, 16)
    lanes = torch.arange(nt, dtype=i64, device=dev)
    in_blk = torch.arange(BLK, dtype=i64, device=dev)
    bits = torch.arange(8, dtype=i32, device=dev)
    for j in range(int(cnt.max()) if nslot else 0):
        sel = torch.nonzero(cnt > j).squeeze(1)
        w = words[sel, j]
        kmask = fmt.keep(w)
        ps, pb = torch.nonzero((kmask[:, None] >> bits) & 1, as_tuple=True)
        if cull:
            wbits = best_t.view(i32).view(nslot, 8, BLK).amax(dim=2)
            run = lb_bits(w[ps], tq_bits) < wbits[sel[ps], pb]
            culled += int((~run).sum())
            ps, pb = ps[run], pb[run]
        pairs += ps.numel()
        for c in range(0, ps.numel(), _ISECT_CHUNK):
            q, b = ps[c:c + _ISECT_CHUNK], pb[c:c + _ISECT_CHUNK]
            slot = sel[q]
            leaf = fmt.leaf(w[q]).to(i64)
            if stats is not None:
                need = act[slot_pkt[slot].to(i64), b]
                ray_tests += need.sum()
                tri_tests += (need * tri_lanes[leaf]).sum()
            x = xs[slot_pkt[slot].to(i64), b]                  # [c, BLK, 16]
            wf = kleaf[leaf]                                   # [c, 16, 4T]
            s0, s2, rv, t, ok = _pair_tests(x, wf, stable, tmin_t, tmax_t)
            tt = torch.where(ok, t, FMAX)                      # [c, BLK, T]
            tw = tt.amin(dim=2)
            lw = torch.where(tt == tw[..., None], lanes, nt).amin(dim=2)
            g = lw[..., None]
            prim = wf[:, 10, :nt].gather(1, lw)
            b1 = (s2 * rv).gather(2, g).squeeze(2)
            b2 = (s0 * rv).gather(2, g).squeeze(2)
            rr = (b * BLK)[:, None] + in_blk                   # [c, BLK]
            ss = slot[:, None].expand_as(rr)
            cur_t, cur_l = best_t[ss, rr], best_lane[ss, rr]
            imp = (tw < FMAX) & ((tw < cur_t) | ((tw == cur_t) & (lw < cur_l)))
            best_t[ss, rr] = torch.where(imp, tw, cur_t)
            best_lane[ss, rr] = torch.where(imp, lw, cur_l)
            best_prim[ss, rr] = torch.where(imp, prim, best_prim[ss, rr])
            best_b1[ss, rr] = torch.where(imp, b1, best_b1[ss, rr])
            best_b2[ss, rr] = torch.where(imp, b2, best_b2[ss, rr])
    if stats is not None:
        stats["pairs"] = pairs
        stats["ray_tests"] = int(ray_tests)
        stats["tri_tests"] = int(tri_tests)
        if cull:
            stats["culled"] = culled
    if lean:
        best_b1.zero_()
        best_b2.zero_()
    return torch.stack([best_t, best_prim, best_b1, best_b2], dim=2)


def lb_bits(words, tq_bits=W_TQ_BITS):
    """The quantised lower bound of each word's leaf entry distance as
    f32 bits, (tq + tq_bias3) << tq_shift, or 0 where tq is 0
    (stream3.py:1915), in the format of tq_bits."""
    fmt = word_format(tq_bits)
    tq = words & fmt.tq_mask
    return torch.where(tq == 0, 0, (tq + fmt.tq_bias3) << fmt.tq_shift)


def _check_isect_args(fn, words, emeta, slot_pkt, feats, kleaf, pcap):
    """The device and the leaf width T of a D or E launch's arguments."""
    dev = _cuda_only(fn, words)
    chk = functools.partial(cuda_build.check_tensor, fn, dev=dev)
    nslot = words.shape[0]
    chk("words", words, torch.int32, (nslot, pcap))
    chk("emeta", emeta, torch.int32, (nslot, 8))
    chk("slot_pkt", slot_pkt, torch.int32, (nslot,))
    chk("feats", feats, torch.float32, (None, 16))
    chk("kleaf", kleaf, torch.float32, (None, 16, None))
    if feats.shape[0] % PKT:
        raise ValueError(f"{fn}: feats must hold whole packets")
    return dev, leaf_width(kleaf)


def isect_cuda(words, emeta, slot_pkt, feats, kleaf, tmin, tmax, pcap,
               stable, lean=False, cull=False, stats=None,
               tq_bits=W_TQ_BITS):
    """Kernel D: out [nslot, PKT, 4] f32 (t, prim, b1, b2); rays with no
    hit hold (FLT_MAX, -1, 0, 0).  lean leaves b1, b2 zero; cull skips
    the (word, block) pairs whose entry bound is at or past every ray's
    best.  Its three launches share a [nslot * PKT] i64 scratch of
    per-ray keys.  stats, if a dict, receives with the cull "culled": the
    pairs the kernel skipped, counted on the card (a subset of
    _isect_plain's, which reads the bests of the whole list).  Launches
    the library built for kleaf's leaf width and tq_bits."""
    dev, lt = _check_isect_args("isect_cuda", words, emeta, slot_pkt, feats,
                                kleaf, pcap)
    if not _aligned(feats, kleaf):
        raise ValueError("isect_cuda: feats and kleaf must be 16-byte "
                         "aligned")
    if pcap > 1 << 16:
        raise ValueError("isect_cuda: pcap must be at most 65536")
    nslot = words.shape[0]
    out = torch.empty(nslot, PKT, 4, dtype=torch.float32, device=dev)
    culled = (torch.zeros(1, dtype=torch.int32, device=dev)
              if cull and stats is not None else None)
    if nslot:
        keys = torch.empty(nslot * PKT, dtype=torch.int64, device=dev)
        with cuda_build.on_device(dev) as stream:
            err = _lib("isect", lt, tq_bits).rt_s3_isect(
                words.data_ptr(), emeta.data_ptr(), slot_pkt.data_ptr(),
                feats.data_ptr(), kleaf.data_ptr(), nslot, int(pcap),
                float(tmin), float(tmax), int(bool(stable)), int(bool(lean)),
                int(bool(cull)), keys.data_ptr(), out.data_ptr(),
                None if culled is None else culled.data_ptr(), stream)
        cuda_build.check_launch("s3_isect", err)
        cuda_build.count_launch(isect_cuda)
        if lean:
            cuda_build.count_launch(isect_cuda, "lean_launches")
        if cull:
            cuda_build.count_launch(isect_cuda, "cull_launches")
    if culled is not None:
        stats["culled"] = int(culled)
    return out


isect_cuda.launches = 0
isect_cuda.lean_launches = 0
isect_cuda.cull_launches = 0


# ---------------------------------------------------------------------------
# E. pair intersection (occlusion)
# ---------------------------------------------------------------------------

def _isect_occl_plain(words, emeta, slot_pkt, feats, kleaf, tmin, tmax,
                      pcap, stable, stats=None, live=None,
                      tq_bits=W_TQ_BITS):
    """Plain version of kernel E under the reference's schedule: words in
    list order, each kept (slot, block) pair tested (_pair_tests) unless
    every ray of its block is already occluded, a slot's list left once
    all its rays are.  A ray is occluded by any accepted triangle, so the
    culls change no result.  stats, if a dict, receives "pairs": the
    (leaf, block) pairs tested, "ray_tests": the rays of those pairs
    that the function needs tested, those not yet occluded and, with
    `live` ([Npad] bool, ray-major like feats), live, and "tri_tests":
    each such ray times its leaf's triangle lanes (a padded lane, zero
    edge rows 3-5, can never occlude).  Words in the format of tq_bits."""
    dev = words.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    fmt = word_format(tq_bits)
    nslot = words.shape[0]
    tmin_t = torch.tensor(tmin, dtype=f32, device=dev)
    tmax_t = torch.tensor(tmax, dtype=f32, device=dev)
    cnt = torch.clamp(emeta[:, 0], max=pcap).to(i64)
    occ = torch.zeros(nslot, PKT, dtype=torch.bool, device=dev)
    xs = feats.view(-1, 8, BLK, 16)
    in_blk = torch.arange(BLK, dtype=i64, device=dev)
    bits = torch.arange(8, dtype=i32, device=dev)
    lv = None if live is None else live.view(-1, 8, BLK)
    pairs = 0
    ray_tests = torch.zeros((), dtype=i64, device=dev)
    tri_tests = torch.zeros((), dtype=i64, device=dev)
    if stats is not None:
        tri_lanes = _tri_lanes(kleaf)
    for j in range(int(cnt.max()) if nslot else 0):
        sat = occ.view(nslot, 8, BLK).all(dim=2)            # [nslot, 8]
        sel = torch.nonzero((cnt > j) & ~sat.all(dim=1)).squeeze(1)
        w = words[sel, j]
        kept = ((fmt.keep(w)[:, None] >> bits) & 1).bool()
        ps, pb = torch.nonzero(kept & ~sat[sel], as_tuple=True)
        pairs += ps.numel()
        for c in range(0, ps.numel(), _ISECT_CHUNK):
            q, b = ps[c:c + _ISECT_CHUNK], pb[c:c + _ISECT_CHUNK]
            slot = sel[q]
            leaf = fmt.leaf(w[q]).to(i64)
            pk = slot_pkt[slot].to(i64)
            x = xs[pk, b]                                      # [c, BLK, 16]
            ok = _pair_tests(x, kleaf[leaf], stable, tmin_t, tmax_t)[4]
            rr = (b * BLK)[:, None] + in_blk                   # [c, BLK]
            ss = slot[:, None].expand_as(rr)
            if stats is not None:
                need = ~occ[ss, rr]
                need = (need if lv is None else need & lv[pk, b]).sum(dim=1)
                ray_tests += need.sum()
                tri_tests += (need * tri_lanes[leaf]).sum()
            occ[ss, rr] = occ[ss, rr] | ok.any(dim=2)
    if stats is not None:
        stats["pairs"] = pairs
        stats["ray_tests"] = int(ray_tests)
        stats["tri_tests"] = int(tri_tests)
    out = torch.zeros(nslot, PKT, 4, dtype=f32, device=dev)
    out[..., 0] = torch.where(occ, 0.0, FMAX)
    out[..., 1] = torch.where(occ, 0.0, -1.0)
    return out


def isect_occl_cuda(words, emeta, slot_pkt, feats, kleaf, tmin, tmax, pcap,
                    stable, tq_bits=W_TQ_BITS):
    """Kernel E: out [nslot, PKT, 4] f32, (0, 0, 0, 0) on an occluded ray,
    (FLT_MAX, -1, 0, 0) otherwise, on refined or emitted word lists.
    Launches the library built for kleaf's leaf width and tq_bits."""
    dev, lt = _check_isect_args("isect_occl_cuda", words, emeta, slot_pkt,
                                feats, kleaf, pcap)
    if not _aligned(feats, kleaf):
        raise ValueError("isect_occl_cuda: feats and kleaf must be 16-byte "
                         "aligned")
    nslot = words.shape[0]
    out = torch.empty(nslot, PKT, 4, dtype=torch.float32, device=dev)
    if nslot:
        with cuda_build.on_device(dev) as stream:
            err = _lib("isect_occl", lt, tq_bits).rt_s3_isect_occl(
                words.data_ptr(), emeta.data_ptr(), slot_pkt.data_ptr(),
                feats.data_ptr(), kleaf.data_ptr(), nslot, int(pcap),
                float(tmin), float(tmax), int(bool(stable)), out.data_ptr(),
                stream)
        cuda_build.check_launch("s3_isect_occl", err)
        cuda_build.count_launch(isect_occl_cuda)
    return out


isect_occl_cuda.launches = 0


def stage_isect(words, emeta, slot_pkt, feats, kleaf, tmin, tmax, *,
                stable: bool, pcap=PCAP, occl: bool = False,
                lean: bool = False, cull: bool = False, tq_bits=W_TQ_BITS):
    """Pair intersection of every slot's word list against its packet's
    rays (ray-major feats [Npad, 16]): closest hit (kernel D, on refined
    lists; lean and cull select its forms) or, with occl, occlusion
    (kernel E, on refined or emitted lists).  Words in the format of
    tq_bits, leaves of kleaf's width."""
    cuda = _route(words) == "cuda"
    if occl:
        fn = isect_occl_cuda if cuda else _isect_occl_plain
        return fn(words, emeta, slot_pkt, feats, kleaf, tmin, tmax, pcap,
                  stable, tq_bits=tq_bits)
    fn = isect_cuda if cuda else _isect_plain
    return fn(words, emeta, slot_pkt, feats, kleaf, tmin, tmax, pcap,
              stable, lean=lean, cull=cull, tq_bits=tq_bits)


KERNELS = {"aos_rows": aos_rows_cuda, "transpose": transpose_cuda,
           "emit": emit_cuda,
           "refine": refine_cuda, "isect": isect_cuda,
           "isect_occl": isect_occl_cuda, "oscal": oscal_cuda}


FORM_COUNTS = ((refine_cuda, "sort_launches"),
               (isect_cuda, "lean_launches"), (isect_cuda, "cull_launches"))


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn, attr in FORM_COUNTS:
        setattr(fn, attr, 0)
