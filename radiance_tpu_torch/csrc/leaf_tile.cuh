// The leaf tile of the stream3 closest-hit pair kernel D (s3_isect.cu):
// a staged copy of one kernel leaf in shared memory and the Pluecker
// tests of a few rays held in registers against four of its triangles at
// a time; and the ray and test primitives (Ray, side, plane, candidate,
// Best, the ordered keys) that the packet kernel (packet_trace.cu)
// applies to a leaf's unstaged lanes, so its results keep D's bits.
//
// A kernel leaf is a [16, 4T] f32 matrix (bvh/kernel_pack.py): lanes
// [0, T) of rows 0-5 pair the ray's (d, moment) with the s0 edge, lanes
// [T, 2T) the s1 edge, [2T, 3T) the s2 edge; rows 6-9 of lanes [3T, 4T)
// give the plane numerator n . o + dp; row 10 of lanes [0, T) the
// triangle's primID as f32 (4294967296.0, the uint32 -1, on a padded
// lane); rows 12-14 of column 0 the leaf centroid of stable frames.
//
// Staged layout, in float4 "quads" of four neighbouring lanes: the 22
// coefficient rows a test reads, row c = 3 r + e for edge row r (0-5) of
// quarter e (0-2) and c = 18 + k for plane row 6 + k, each kQ quads wide;
// then row 10's prim quads (kernel D only); then rows 12-14 of columns
// 0-3 (the centroid in .x).  A leaf of ntri triangles needs only its
// first ceil(ntri / 4) quads of each row: its lanes past ntri are zero
// rows, which give s0 = s1 = s2 = 0 and num = 0, so never an accepted t.
//
// Arithmetic: every product is an IEEE FP32 FMA or multiply on the CUDA
// cores (never TF32 or the tensor cores), written with explicit
// rounding intrinsics so that no compiler contraction changes a result:
// a test gives the same bits wherever it is inlined (kernel D recomputes
// its winners' barycentrics in a second pass), whatever -fmad says.
//  * side product s_e = dx w0 + dy w1 + dz w2 + px w3 + py w4 + pz w5, an
//    FMA chain in that order: the stable frame's moment terms after the
//    direction terms, as the reference adds its correction after the
//    leaf product;
//  * the stable frame's moment (o - c) x d as the plain versions compute
//    it, two products and a difference per component (no FMA);
//  * num = ((ox n0 + oy n1) + oz n2) + dp;
//  * the inside test by the sign bits of s0, s1, s2; ssum = (s0 + s1) + s2.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace lt {

constexpr float kFltMax = 3.402823466e38f;
// Lanes a staged leaf holds: a build define (128 by default; a library
// built for a wider leaf cap sets it, and kernel D sets it to its T).
#ifndef RT_LEAF_MAXT
#define RT_LEAF_MAXT 128
#endif
constexpr int kMaxT = RT_LEAF_MAXT;
static_assert(kMaxT % 4 == 0 && kMaxT <= 512, "RT_LEAF_MAXT: 4..512 lanes");
constexpr int kQ = kMaxT / 4;               // quads of a staged row
constexpr int kRows = 22;                   // coefficient rows a test reads
constexpr int kPrimF4 = kRows * kQ;         // row 10's prim quads
constexpr int kCenF4 = kPrimF4 + kQ;        // the centroid rows
constexpr int kLeafF4 = kCenF4 + 3;         // a staged leaf, in float4

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Offset in floats, within one leaf matrix of width 4T, of coefficient
// row c's quad q.
__device__ __forceinline__ int coef_src(int c, int q, int T) {
  if (c < 18) return (c / 3) * 4 * T + (c % 3) * T + 4 * q;
  return (c - 12) * 4 * T + 3 * T + 4 * q;
}

// Start copying leaf W (a [16, 4T] matrix, 16-byte aligned, T a multiple
// of 4 and at most kMaxT) into the staged leaf dst: the first nq quads of
// each coefficient row, with kPrim also row 10's nq prim quads, and the
// centroid.  Threads tid of nthr (>= 3) share the copies; the caller
// commits the group.
template <bool kPrim>
__device__ __forceinline__ void stage_leaf(float4* dst, const float* W, int T,
                                           int nq, int tid, int nthr) {
  constexpr int kStagedRows = kRows + (kPrim ? 1 : 0);
  for (int i = tid; i < kStagedRows * kQ; i += nthr) {
    const int c = i / kQ, q = i % kQ;
    if (q >= nq) continue;
    const int src = c < kRows ? coef_src(c, q, T) : 10 * 4 * T + 4 * q;
    cp_async16(dst + i, W + src);
  }
  if (tid < 3) cp_async16(dst + kCenF4 + tid, W + (12 + tid) * 4 * T);
}

// One ray in the form the tests read: direction, the moment paired with
// the edge rows (o x d in legacy frames, (o - c) x d in stable ones) and
// origin.
struct Ray {
  float dx, dy, dz;
  float px, py, pz;
  float ox, oy, oz;
};

// The moment (o - c) x d, as the plain versions compute it; c = 0 gives
// the legacy o x d (torch.cross's formula).
__device__ __forceinline__ void set_moment(Ray& r, float cx, float cy,
                                           float cz) {
  const float lx = __fsub_rn(r.ox, cx), ly = __fsub_rn(r.oy, cy);
  const float lz = __fsub_rn(r.oz, cz);
  r.px = __fsub_rn(__fmul_rn(ly, r.dz), __fmul_rn(lz, r.dy));
  r.py = __fsub_rn(__fmul_rn(lz, r.dx), __fmul_rn(lx, r.dz));
  r.pz = __fsub_rn(__fmul_rn(lx, r.dy), __fmul_rn(ly, r.dx));
}

__device__ __forceinline__ float side(const Ray& r, float w0, float w1,
                                      float w2, float w3, float w4,
                                      float w5) {
  float s = __fmul_rn(r.dx, w0);
  s = __fmaf_rn(r.dy, w1, s);
  s = __fmaf_rn(r.dz, w2, s);
  s = __fmaf_rn(r.px, w3, s);
  s = __fmaf_rn(r.py, w4, s);
  return __fmaf_rn(r.pz, w5, s);
}

__device__ __forceinline__ float plane(const Ray& r, float n0, float n1,
                                       float n2, float dp) {
  return __fadd_rn(__fmaf_rn(r.oz, n2, __fmaf_rn(r.oy, n1,
                                                 __fmul_rn(r.ox, n0))), dp);
}

__device__ __forceinline__ float ssum3(float s0, float s1, float s2) {
  return __fadd_rn(__fadd_rn(s0, s1), s2);
}

// The bitcast sign test: s0, s1, s2 of one sign (the line meets the
// triangle, boundaries included).
__device__ __forceinline__ bool agree(float s0, float s1, float s2) {
  const int b0 = __float_as_int(s0), b1 = __float_as_int(s1);
  const int b2 = __float_as_int(s2);
  return ((b0 ^ b1) | (b1 ^ b2)) >= 0;
}

// May the lane be accepted?  Its signs agree and, where tmin >= 0
// (ahead_only), num and ssum have opposite signs: t = -num / ssum >
// tmin >= 0 needs that, so the triangles behind the origin, and the
// padded lanes (num = ssum = +0), never reach the division.  With a
// negative tmin every lane whose signs agree is a candidate.
__device__ __forceinline__ bool candidate(float s0, float s1, float s2,
                                          float num, float ssum,
                                          bool ahead_only) {
  return agree(s0, s1, s2) &&
         (!ahead_only || (__float_as_int(num) ^ __float_as_int(ssum)) < 0);
}

// Side products of edge quarter e for the four lanes of quad q of a
// staged leaf L, for each of R rays: the six coefficient float4s are
// loaded once for all R rays.
template <int R>
__device__ __forceinline__ void quad_sides(const float4* L, int e, int q,
                                           const Ray (&r)[R],
                                           float4 (&s)[R]) {
  const float4 w0 = L[(0 + e) * kQ + q], w1 = L[(3 + e) * kQ + q];
  const float4 w2 = L[(6 + e) * kQ + q], w3 = L[(9 + e) * kQ + q];
  const float4 w4 = L[(12 + e) * kQ + q], w5 = L[(15 + e) * kQ + q];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s[i].x = side(r[i], w0.x, w1.x, w2.x, w3.x, w4.x, w5.x);
    s[i].y = side(r[i], w0.y, w1.y, w2.y, w3.y, w4.y, w5.y);
    s[i].z = side(r[i], w0.z, w1.z, w2.z, w3.z, w4.z, w5.z);
    s[i].w = side(r[i], w0.w, w1.w, w2.w, w3.w, w4.w, w5.w);
  }
}

// The same products for one lane of an unstaged leaf W (width 4T).
__device__ __forceinline__ void lane_products(const float* W, int T, int lane,
                                              const Ray& r, float (&s)[3],
                                              float& num) {
  const int L = 4 * T;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float* c = W + e * T + lane;
    s[e] = side(r, __ldg(c), __ldg(c + L), __ldg(c + 2 * L), __ldg(c + 3 * L),
                __ldg(c + 4 * L), __ldg(c + 5 * L));
  }
  const float* c = W + 3 * T + lane;
  num = plane(r, __ldg(c + 6 * L), __ldg(c + 7 * L), __ldg(c + 8 * L),
              __ldg(c + 9 * L));
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// A running best hit: t, its leaf lane (kMaxT: none).  The tie rule of
// the reference's per-ray reduction: the lower t, then the lower lane;
// an equal (t, lane) later keeps the earlier one.
struct Best {
  float t;
  int lane;
  __device__ __forceinline__ bool improves(float tt, int ln) const {
    return tt < t || (tt == t && ln < lane);
  }
};

// The leaf tile: R rays (registers) against the four triangles of quad
// q of staged leaf L (shared memory), each of the 22 coefficient float4s
// loaded once for all R rays: 88 R FMAs for 22 loads.  Each ray's
// accepted lanes (tmin < t < tmax, in ascending lane order) fold into
// b[i]; changed[i] says whether b[i] moved.  kDivide: t = -num / ssum
// (the packet kernel); otherwise t = -num * (1 / ssum) (kernel D).
template <int R, bool kDivide>
__device__ __forceinline__ void test_quad(const float4* L, int q,
                                          const Ray (&r)[R], float tmin,
                                          float tmax, bool ahead_only,
                                          Best (&b)[R], bool (&changed)[R]) {
  float4 num[R], s0[R], s1[R];
  {
    const float4 n0 = L[18 * kQ + q], n1 = L[19 * kQ + q];
    const float4 n2 = L[20 * kQ + q], n3 = L[21 * kQ + q];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      num[i].x = plane(r[i], n0.x, n1.x, n2.x, n3.x);
      num[i].y = plane(r[i], n0.y, n1.y, n2.y, n3.y);
      num[i].z = plane(r[i], n0.z, n1.z, n2.z, n3.z);
      num[i].w = plane(r[i], n0.w, n1.w, n2.w, n3.w);
    }
  }
  quad_sides<R>(L, 0, q, r, s0);
  quad_sides<R>(L, 1, q, r, s1);
  float4 s2[R];
  quad_sides<R>(L, 2, q, r, s2);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    changed[i] = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float a0 = lane_of(s0[i], u), a1 = lane_of(s1[i], u);
      const float a2 = lane_of(s2[i], u), nm = lane_of(num[i], u);
      const float ss = ssum3(a0, a1, a2);
      if (candidate(a0, a1, a2, nm, ss, ahead_only)) {
        const float t = kDivide ? __fdiv_rn(-nm, ss)
                                : __fmul_rn(-nm, __frcp_rn(ss));
        const int ln = 4 * q + u;
        if (t > tmin && t < tmax && b[i].improves(t, ln)) {
          b[i].t = t;
          b[i].lane = ln;
          changed[i] = true;
        }
      }
    }
  }
}

// An order-preserving map of f32 to u32 (-0 sorts below +0) and back:
// a 64-bit key (ordered(t) << 32 | rest) sorts by t first.
__device__ __forceinline__ unsigned ordered(float t) {
  const unsigned u = __float_as_uint(t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

}  // namespace lt
