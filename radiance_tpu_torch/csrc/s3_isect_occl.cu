// Kernel E of the stream3 pipeline: occlusion (any-hit) pair intersection.
//
// Replaces the TPU kernel radiance_tpu/ops/stream3.py::_isect3_occl_kernel
// (:2100, launched by _stage_isect(occl=True) :2295-2299, :2316; f32,
// orient="major", the stable-frame correction on).  For every slot and
// every 128-ray block k of the slot's packet it tests block k against the
// leaf of each word of the slot's list whose keep bit k is set, in list
// order: the Pluecker side products s0, s1, s2 of the leaf's T triangles
// (T = 128 by default) from the [16, 4T] leaf matrix and the bitcast sign test, then,
// where the signs agree, the plane numerator, t = -num * (1 / (s0 + s1 +
// s2)) and tmin < t < tmax.  Any accepted triangle occludes the ray.
// out [nslot, 1024, 4] = (0, 0, 0, 0) on an occluded ray, (FLT_MAX, -1,
// 0, 0) otherwise -- the layout the glue stage folds (t < FLT_MAX and
// prim >= 0 there means occluded).
//
// A ray once occluded stays occluded, so any schedule of the same tests
// gives the same answer; the word lists may be refined or not.  Design:
// one block of 128 threads per (chunk of 128 words, slot, ray block), so
// no warp waits on a leaf that another block's rays test and no long
// list holds one block busy after the others are done.
//  * out is filled with misses first; a block writes only the rays it
//    finds occluded.  The chunks run in list order (chunk-major grid); a
//    later chunk leaves out the rays an earlier one has already written.
//  * Parked lanes retire at the start.  stream3.park_dead puts a dead
//    lane of a masked wave at origin 1e30, where no triangle can be hit,
//    so a lane whose object-space origin has a component of magnitude >=
//    1e29 is never tested and reports a miss, as the plain version finds.
//  * The chunk's kept leaves are compacted from its words first (one
//    block-wide scan of keep bit k).
//  * The rays still to test -- not parked, not yet occluded -- are a
//    compact list, rebuilt after every leaf.  The block ends when the
//    list is empty: the reference's saturation cull in this form.
//  * The leaf rows occlusion reads (rows 0-5 of the three edge quarters,
//    rows 6-9 of the plane quarter, the centroid: 11 KB) pass through a two-stage shared-memory ring filled
//    with cp.async, so the next kept leaf loads while this one is tested:
//    the TPU kernel's S_SLOTS copy ring.
//  * Triangles in registers, rays broadcast.  Shared memory returns 128
//    bytes a clock to an SM's registers, a quarter of what its FP32
//    units consume, so every float a lane loads must feed several FMAs.
//    Each thread holds two triangles' 22 coefficients each in registers
//    and walks its share of the ray list (the rays' d, moment and o
//    written to shared memory once per leaf): two float4 broadcasts feed
//    36 FMAs.  At T = 128 the 64 triangle pairs take two ray groups (the
//    even and odd rays); a narrower leaf takes 128 / (T / 2) groups, a
//    wider one several passes of 128 pairs.
//    Lanes past the leaf's triangles (zero rows) test nothing: each would
//    pass the sign test with s = 0 and pay a division for a NaN t.
//  * Per (ray, triangle): the 18 FMAs of the side products and the sign
//    test, two rays by two triangles at a time; where the signs agree,
//    the plane numerator, and only where it can give t > tmin >= 0 the
//    IEEE reciprocal and the t window (in_window()).  FP32 on the CUDA
//    cores, never TF32 or the tensor cores; the stable frame's ray moment
//    (o - c) x d is computed once per (ray, leaf).
//
// What bounds it: FLOPs.  The work the function needs is, for each kept
// (leaf, block) pair, its rays that are live and not yet occluded, each
// against its leaf's triangles at 22 FMAs (chip_smoke.py counts them with
// the plain version's stats).  A leaf is read from L2 once per kept block.
//
// The leaf width T is a build define (RT_LEAF_T, the scene's leaf cap, a
// multiple of 32 in [32, 512], 128 by default), as the tq width is
// (s3_common.cuh); past T = 128 the ring moves to dynamic shared memory.

#include "leaf_tile.cuh"
#include "s3_common.cuh"

#ifndef RT_LEAF_T
#define RT_LEAF_T 128
#endif

namespace {

using s3::kFltMax;

constexpr int kThreads = s3::kBlk;    // one thread per ray of a block
constexpr int kWarps = kThreads / 32;
constexpr int kT = RT_LEAF_T;         // triangles per leaf
static_assert(kT % 32 == 0 && kT >= 32 && kT <= 512,
              "RT_LEAF_T must be a multiple of 32 in [32, 512]");
constexpr int kL4 = 4 * kT / 4;       // float4 columns of a leaf row
constexpr int kQ = kT / 4;            // float4 columns of a quarter
constexpr int kStages = 2;            // depth of the leaf ring
// a staged leaf, in float4: rows 0-5 x the three edge quarters, rows 6-9
// x the plane quarter, then rows 12-14 of column 0 (the centroid in .x)
constexpr int kEdgeF4 = 6 * 3 * kQ;
constexpr int kPlaneF4 = 4 * kQ;
constexpr int kCenF4 = kEdgeF4 + kPlaneF4;
constexpr int kLeafF4 = kCenF4 + 3;
// each thread holds a pair of triangles, p and p + kPairs, and tests them
// against every kRayGroups-th ray of the list from its group g: at T =
// 128, p = t % 64 and g = t / 64 (the parity); past T = 256, one group
// and kPasses passes of 128 pairs
constexpr int kPairs = kT / 2;
constexpr int kRayGroups = kPairs >= kThreads ? 1 : kThreads / kPairs;
constexpr int kPasses = (kPairs + kThreads - 1) / kThreads;
constexpr bool kDynRing = kT > 128;   // the ring in dynamic shared memory
constexpr int kRingBytes = kDynRing ? kStages * kLeafF4 * 16 : 0;
// a block's word list is cut into chunks of 128 words, one CTA each, so
// that no long list keeps one CTA busy after the others are done
constexpr int kChunk = kThreads;
constexpr float kParked = 1e29f;

using lt::cp_async16;
using lt::cp_async_commit;
using lt::cp_async_wait;

// The float4 of the leaf matrix that a staged leaf's float4 i copies.
__device__ __forceinline__ int leaf_src(int i) {
  if (i < kEdgeF4) return (i / (3 * kQ)) * kL4 + i % (3 * kQ);
  if (i < kEdgeF4 + kPlaneF4) {
    const int j = i - kEdgeF4;
    return (6 + j / kQ) * kL4 + 3 * kQ + j % kQ;
  }
  return (12 + i - kCenF4) * kL4;
}

constexpr int kStageCopies = (kLeafF4 + kThreads - 1) / kThreads;

// Start the copy of leaf `leaf`'s rows into one ring stage; src holds
// this thread's leaf_src offsets (-1: none).
__device__ __forceinline__ void stage_leaf(float4* dst,
                                           const float* __restrict__ kleaf,
                                           int leaf, int tid,
                                           const int (&src)[kStageCopies]) {
  const float4* W = reinterpret_cast<const float4*>(
      kleaf + static_cast<int64_t>(leaf) * 16 * 4 * kT);
#pragma unroll
  for (int k = 0; k < kStageCopies; ++k) {
    if (src[k] >= 0) cp_async16(dst + tid + k * kThreads, W + src[k]);
  }
}

// One triangle's coefficients, held in registers: the side-product rows
// w[r][e] (rows 0-5 of edge quarter e) and the plane row n (rows 6-9).
struct Tri {
  float w[6][3];
  float n[4];
  bool valid;                          // not a padded lane (see load_tri)
};

__device__ __forceinline__ void load_tri(Tri& tr, const float* Ls, int tri) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int e = 0; e < 3; ++e) tr.w[r][e] = Ls[r * 3 * kT + e * kT + tri];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) tr.n[r] = Ls[4 * kEdgeF4 + r * kT + tri];
  // A lane whose three edge vectors (rows 3-5) are zero -- the padded
  // lanes past the leaf's triangles, or a triangle shrunk to a point --
  // has zero side products and a zero plane row: t = -0 * (1 / 0) is NaN
  // there, a miss, so it is never tested.
  tr.valid = false;
#pragma unroll
  for (int r = 3; r < 6; ++r) {
#pragma unroll
    for (int e = 0; e < 3; ++e) tr.valid |= tr.w[r][e] != 0.f;
  }
}

// The side products of triangle tr with the ray (d, moment) = (a.xyz,
// a.w b.xy).
__device__ __forceinline__ void sides(const Tri& tr, const float4& a,
                                      const float4& b, float (&s)[3]) {
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    s[e] = a.x * tr.w[0][e] + a.y * tr.w[1][e] + a.z * tr.w[2][e] +
           a.w * tr.w[3][e] + b.x * tr.w[4][e] + b.y * tr.w[5][e];
  }
}

// The bitcast sign test: s0, s1, s2 of one sign (the line meets the
// triangle), on a lane that holds a triangle.
__device__ __forceinline__ bool agree(const Tri& tr, const float (&s)[3]) {
  const int b0 = __float_as_int(s[0]), b1 = __float_as_int(s[1]);
  const int b2 = __float_as_int(s[2]);
  return tr.valid && ((b0 ^ b1) | (b1 ^ b2)) >= 0;
}

// The plane numerator n . o + dp of triangle tr for the origin (b.zw, oz).
__device__ __forceinline__ float plane_num(const Tri& tr, const float4& b,
                                           float oz) {
  return b.z * tr.n[0] + b.w * tr.n[1] + oz * tr.n[2] + tr.n[3];
}

// May the triangle be accepted?  Its signs agree and, with tmin >= 0
// (ahead_only), num and ssum have opposite signs: t = -num * (1 / ssum)
// > tmin >= 0 needs that, so the triangles behind the origin, most of
// those whose signs agree, never reach the division.
__device__ __forceinline__ bool candidate(const Tri& tr, const float (&s)[3],
                                          float num, float ssum,
                                          bool ahead_only) {
  return agree(tr, s) &&
         (!ahead_only || (__float_as_int(num) ^ __float_as_int(ssum)) < 0);
}

// The plain version's t and window: t = -num * (1 / (s0 + s1 + s2)) in
// (tmin, tmax); ssum == 0 gives an inf or NaN t, a miss.
__device__ __forceinline__ bool in_window(float num, float ssum, float tmin,
                                          float tmax) {
  const float t = -num * (1.0f / ssum);
  return t > tmin && t < tmax;
}

// this thread's pair of pass `pass` into ta, tb; returns its ray group
// (kRayGroups, and both triangles invalid, where it holds none)
__device__ __forceinline__ int load_pair(Tri& ta, Tri& tb, const float* Ls,
                                         int tid, int pass) {
  const int p = kPairs >= kThreads ? tid + pass * kThreads : tid % kPairs;
  const int g = kPairs >= kThreads ? 0 : tid / kPairs;
  if (p < kPairs && g < kRayGroups) {
    load_tri(ta, Ls, p);
    load_tri(tb, Ls, p + kPairs);
    return g;
  }
  ta.valid = tb.valid = false;
  return kRayGroups;
}

template <bool kStable>
__global__ void __launch_bounds__(kThreads, kDynRing ? 2 : 5)
isect_occl_kernel(const int* __restrict__ words,
                  const int* __restrict__ emeta,
                  const int* __restrict__ slot_pkt,
                  const float* __restrict__ feats,
                  const float* __restrict__ kleaf, int pcap, float tmin,
                  float tmax, int nslot, float* __restrict__ out) {
#if RT_LEAF_T > 128
  extern __shared__ float4 s_dyn[];
  auto s_ring = reinterpret_cast<float4 (*)[kLeafF4]>(s_dyn);
#else
  __shared__ float4 s_ring[kStages][kLeafF4];
#endif
  __shared__ float4 s_ray[kThreads][3];
  __shared__ float4 s_rd[kThreads][3];    // this leaf's ray records
  __shared__ int s_leaf[kChunk];          // the chunk's kept leaves
  __shared__ int s_act[2][kThreads];      // rays to test, per-warp segments
  __shared__ int s_cnt[2][kWarps];        // the segments' lengths
  __shared__ int s_scan[kWarps];
  __shared__ int s_occ[kThreads];

  // chunk-major: the chunks of every list start after all first chunks
  const int chunk = blockIdx.x / (nslot * 8);
  const int slot = (blockIdx.x >> 3) % nslot, blk = blockIdx.x & 7;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t lane0 = static_cast<int64_t>(slot) * s3::kPkt + blk * s3::kBlk;
  float4* res = reinterpret_cast<float4*>(out) + lane0 + tid;
  const bool ahead_only = tmin >= 0.f;
  const int cnt = min(emeta[slot * 8], pcap);
  const int w0 = chunk * kChunk;
  if (w0 >= cnt) return;

  // the block's rays; parked lanes, and rays an earlier chunk has found
  // occluded already, never enter the list
  const int64_t ray =
      static_cast<int64_t>(slot_pkt[slot]) * s3::kPkt + blk * s3::kBlk + tid;
  const float4* x = reinterpret_cast<const float4*>(feats + ray * 16);
  const float4 x0 = x[0], x1 = x[1], x2 = x[2];
  s_ray[tid][0] = x0;
  s_ray[tid][1] = x1;
  s_ray[tid][2] = x2;
  s_occ[tid] = 0;
  const bool parked = fabsf(x1.z) >= kParked || fabsf(x1.w) >= kParked ||
                      fabsf(x2.x) >= kParked;
  const bool test = !parked && (chunk == 0 || __ldcg(&res->x) != 0.f);
  const unsigned lb = __ballot_sync(~0u, test);
  if (test) s_act[0][warp * 32 + __popc(lb & below)] = tid;
  if (lane == 0) s_cnt[0][warp] = __popc(lb);

  // the leaves of this chunk's words whose keep bit `blk` is set, in
  // list order
  const int j = w0 + tid;
  const int wd = j < cnt ? words[static_cast<int64_t>(slot) * pcap + j] : 0;
  const bool kept = (wd >> (s3::kKeepShift + blk)) & 1;
  const unsigned kb0 = __ballot_sync(~0u, kept);
  if (lane == 0) s_scan[warp] = __popc(kb0);
  __syncthreads();
  int off = __popc(kb0 & below), nkept = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    if (v < warp) off += s_scan[v];
    nkept += s_scan[v];
  }
  if (kept) s_leaf[off] = s3::word_leaf(wd);
  __syncthreads();
  const int nlive = s_cnt[0][0] + s_cnt[0][1] + s_cnt[0][2] + s_cnt[0][3];
  if (nkept == 0 || nlive == 0) return;

  int src[kStageCopies];
#pragma unroll
  for (int k = 0; k < kStageCopies; ++k) {
    const int i = tid + k * kThreads;
    src[k] = i < kLeafF4 ? leaf_src(i) : -1;
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nkept) stage_leaf(s_ring[i], kleaf, s_leaf[i], tid, src);
    cp_async_commit();
  }
  int cur = 0;
  for (int i = 0; i < nkept; ++i) {
    cp_async_wait<kStages - 2>();     // this thread's copies of leaf i
    __syncthreads();                  // everyone's; leaf i - 1 is done
    const int p1 = s_cnt[cur][0], p2 = p1 + s_cnt[cur][1];
    const int p3 = p2 + s_cnt[cur][2], nact = p3 + s_cnt[cur][3];
    if (nact == 0) break;             // every ray occluded
    const int ahead = i + kStages - 1;
    if (ahead < nkept) {
      stage_leaf(s_ring[ahead % kStages], kleaf, s_leaf[ahead], tid, src);
    }
    cp_async_commit();
    // the rays to test against this leaf: d, the moment (o - c) x d of
    // the stable frame (o x d from the features in legacy frames), o
    const float4* L = s_ring[i % kStages];
    int r = 0;
    if (tid < nact) {
      const int at = tid < p1 ? tid
                     : tid < p2 ? 32 + tid - p1
                     : tid < p3 ? 64 + tid - p2
                                : 96 + tid - p3;
      r = s_act[cur][at];
      const float4 x0 = s_ray[r][0], x1 = s_ray[r][1], x2 = s_ray[r][2];
      const float dx = x0.x, dy = x0.y, dz = x0.z;
      const float ox = x1.z, oy = x1.w, oz = x2.x;
      float px = x0.w, py = x1.x, pz = x1.y;
      if (kStable) {
        const float lx = ox - L[kCenF4].x, ly = oy - L[kCenF4 + 1].x;
        const float lz = oz - L[kCenF4 + 2].x;
        px = ly * dz - lz * dy;
        py = lz * dx - lx * dz;
        pz = lx * dy - ly * dx;
      }
      s_rd[tid][0] = make_float4(dx, dy, dz, px);
      s_rd[tid][1] = make_float4(py, pz, ox, oy);
      s_rd[tid][2] = make_float4(oz, __int_as_float(r), 0.f, 0.f);
    }
    // this thread's two triangles, in registers
    Tri ta, tb;
    const float* Ls = reinterpret_cast<const float*>(L);
    int g = load_pair(ta, tb, Ls, tid, 0);
    __syncthreads();                  // the ray records are written
    for (int pass = 0;;) {
      if (ta.valid || tb.valid) {
        // two rays an iteration (the second repeats the first past the
        // list's end): four independent (ray, triangle) tests, branch-free
        // up to the rare candidate
        for (int j = g; j < nact; j += 2 * kRayGroups) {
          const int j1 = j + kRayGroups < nact ? j + kRayGroups : j;
          const float4 a0 = s_rd[j][0], b0 = s_rd[j][1];
          const float4 a1 = s_rd[j1][0], b1 = s_rd[j1][1];
          const float oz0 = s_rd[j][2].x, oz1 = s_rd[j1][2].x;
          float s00[3], s01[3], s10[3], s11[3];
          sides(ta, a0, b0, s00);
          sides(tb, a0, b0, s01);
          sides(ta, a1, b1, s10);
          sides(tb, a1, b1, s11);
          const float n00 = plane_num(ta, b0, oz0), n01 = plane_num(tb, b0, oz0);
          const float n10 = plane_num(ta, b1, oz1), n11 = plane_num(tb, b1, oz1);
          const float q00 = s00[0] + s00[1] + s00[2];
          const float q01 = s01[0] + s01[1] + s01[2];
          const float q10 = s10[0] + s10[1] + s10[2];
          const float q11 = s11[0] + s11[1] + s11[2];
          const bool c00 = candidate(ta, s00, n00, q00, ahead_only);
          const bool c01 = candidate(tb, s01, n01, q01, ahead_only);
          const bool c10 = candidate(ta, s10, n10, q10, ahead_only);
          const bool c11 = candidate(tb, s11, n11, q11, ahead_only);
          if (c00 | c01 | c10 | c11) {
            if ((c00 && in_window(n00, q00, tmin, tmax)) ||
                (c01 && in_window(n01, q01, tmin, tmax))) {
              s_occ[__float_as_int(s_rd[j][2].y)] = 1;
            }
            if ((c10 && in_window(n10, q10, tmin, tmax)) ||
                (c11 && in_window(n11, q11, tmin, tmax))) {
              s_occ[__float_as_int(s_rd[j1][2].y)] = 1;
            }
          }
        }
      }
      if (++pass == kPasses) break;
      g = load_pair(ta, tb, Ls, tid, pass);
    }
    __syncthreads();                  // this leaf's hits are marked
    // the rays still to test, for the next leaf
    const int nxt = cur ^ 1;
    const bool keep = tid < nact && !s_occ[r];
    const unsigned kb = __ballot_sync(~0u, keep);
    if (keep) s_act[nxt][warp * 32 + __popc(kb & below)] = r;
    if (lane == 0) s_cnt[nxt][warp] = __popc(kb);
    cur = nxt;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (s_occ[tid]) *res = make_float4(0.f, 0.f, 0.f, 0.f);
}

// out's every lane a miss, (FLT_MAX, -1, 0, 0); the chunks write only
// the occluded ones.
__global__ void fill_miss(float4* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = make_float4(kFltMax, -1.f, 0.f, 0.f);
}

}  // namespace

extern "C" {

// words [nslot, pcap] i32 (refined or emitted lists), emeta [nslot, 8]
// i32 (lane 0: count), slot_pkt [nslot] i32, feats [npad, 16] f32
// (ray-major), kleaf [nl, 16, 4 * RT_LEAF_T] f32 (both 16-byte aligned) -> out
// [nslot, 1024, 4] f32.  Returns cudaGetLastError().
int rt_s3_isect_occl(const int* words, const int* emeta, const int* slot_pkt,
                     const float* feats, const float* kleaf, int nslot,
                     int pcap, float tmin, float tmax, int stable, float* out,
                     void* stream) {
  if (nslot <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t lanes = static_cast<int64_t>(nslot) * s3::kPkt;
  fill_miss<<<static_cast<unsigned>((lanes + 255) / 256), 256, 0, s>>>(
      reinterpret_cast<float4*>(out), lanes);
  const int nchunk = (max(pcap, 1) + kChunk - 1) / kChunk;
  const unsigned grid = static_cast<unsigned>(nchunk) * nslot *
                        (s3::kPkt / s3::kBlk);
  auto kernel = stable ? isect_occl_kernel<true> : isect_occl_kernel<false>;
  if (kDynRing) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kRingBytes);
  }
  kernel<<<grid, kThreads, kRingBytes, s>>>(
      words, emeta, slot_pkt, feats, kleaf, pcap, tmin, tmax, nslot, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
