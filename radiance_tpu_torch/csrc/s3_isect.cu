// Kernel D of the stream3 pipeline: closest-hit pair intersection.
//
// Replaces the TPU kernel radiance_tpu/ops/stream3.py::_isect3_kernel
// (:1853, launched by _stage_isect :2316; closest hit, orient="major",
// f32, the stable-frame correction on).  For every slot it walks the
// slot's refined word list; for each word and each set keep bit k it
// intersects block k of the slot's packet (128 rays) with the word's
// leaf: the Pluecker side products s0, s1, s2 and the plane numerator of
// the leaf's triangles from the [16, 4T] leaf matrix (kleaf,
// bvh/kernel_pack.py), then the sign test, t = -num * (1 / (s0+s1+s2))
// inside (tmin, tmax), the winner's prim (leaf row 10) and barycentrics
// b1 = s2 / ssum, b2 = s0 / ssum.  out [nslot, 1024, 4] = (t, prim, b1,
// b2), (FLT_MAX, -1, 0, 0) where nothing was hit -- the layout the glue
// stage folds.  The tie rule is the reference's (per-(ray, lane) minima
// with strict < across words, then the lowest lane among equal t,
// :2054-2082): the lowest (t, lane, word position).
//
// Two forms of the TPU kernel are template flags, both off by default so
// that the default route keeps its hits bit for bit:
//  * kLean (lean=True, :1870-1894, :2085-2087; the reference's
//    RADIANCE_ISECT_LEAN): isect_finish writes zeros in lanes 2-3; the
//    caller recomputes the winner's barycentrics (stream3._winner_barys);
//  * kCull (cull=True, :1935-1946, the reference's default): the tq
//    occlusion cull.  A kept (word, block) pair is skipped when the word's
//    quantised entry distance, lb = (tq + kTqBias3) << kTqShift as f32 bits
//    (0 where tq is 0), is not below wbits, the largest over the block's
//    128 rays of the bits of each ray's best t so far.  Every hit in the
//    leaf lies at t >= lb >= that ray's best, so no ray's t can change; at
//    an exact tie a lower lane in the skipped leaf would have won, so prims
//    may differ there, as they do on the TPU.  The TPU kernel reads the
//    best of the whole slot's list so far from its scratch.  Here a block
//    holds a chunk of 128 list positions and its own running bests, so the
//    cull reads the bests of the chunk's words before the current one:
//    the same as the TPU's in a list's first chunk, looser (fewer pairs
//    skipped, never a wrong one) in later chunks, which start from "no
//    hit".  A ray's best is split over the 4 warps that hold its
//    quads: after each leaf every thread writes the bits of its partial
//    bests to a shared-memory row, double-buffered so the next leaf's
//    barrier orders the writes before the reads; every warp then takes
//    the minimum over the 4 rows for its rays, the maximum over its rays
//    and one warp reduction, so all warps reach the same decision.  A
//    block with parked rays (they never hit, their best stays FLT_MAX)
//    never culls, as on the TPU; nor does a launch with tmin < 0, where a
//    negative t's bits would not order as the floats do.  With a
//    tq-sorted list (kernel C's sort form) near leaves come first and the
//    cull skips more.  If the caller passes a counter, each block adds the
//    pairs it skipped (one atomicAdd a block), so a run can show that the
//    cull fired and skipped no more pairs than the whole-list rule does.
//
// Design, three launches:
//  1. every ray's 64-bit key set to "no hit";
//  2. isect_kernel: one 128-thread block per (chunk of 128 list
//     positions, slot, 128-ray block), so no long list keeps one block
//     busy after the others are done.  The block compacts the chunk's
//     words whose keep bit is its ray block, and the block's rays that are
//     not parked (stream3.park_dead puts a dead lane at origin 1e30, where
//     no triangle is hit: it reports a miss, as the plain version finds).
//     The leaf rows (the 22 coefficient rows, the prim row, the centroid:
//     csrc/leaf_tile.cuh) pass through a two-slot shared-memory ring
//     filled with cp.async, so the next kept leaf loads while this one is
//     tested.  Rays in registers, triangles broadcast: the lanes of a
//     warp are rays, up to R = 4 of them a thread (the compacted rays
//     j, j + 32, ...), and warp w takes quads w, w + 4, ... of four
//     triangles, so each float4 of coefficients a warp loads feeds 4 R
//     FMAs.  Quads past the leaf's triangles (its padded lanes, prim
//     4294967296.0, found by a binary search of the prim row) are never
//     loaded; the sign test and a sign check of num against ssum (where
//     tmin >= 0) come before the reciprocal.  Each thread keeps a running
//     best (t, lane, word position) for each of its rays over all its
//     words and quads, and at the end folds it into the ray's key by one
//     atomicMin in device memory: ordered(t) << 32 | lane << 16 | word.
//  3. isect_finish: per ray, the key's winner -- t from the key, prim
//     from the leaf's row 10, b1 and b2 recomputed with the same
//     arithmetic (leaf_tile.cuh's explicit-rounding products give the
//     same bits in both passes), or zeros in the lean form.
//
// What bounds it: FLOPs.  The work the function needs is, for each kept
// (leaf, block) pair, the block's rays that are not parked against the
// leaf's triangle lanes at 22 FMAs each (chip_smoke.py counts them with
// the plain version's stats); a leaf is read from L2 once per block that
// keeps it.  Every product is an FP32 FMA on the CUDA cores, never TF32
// or the tensor cores.

// The leaf width T is a build define (RT_LEAF_T, the scene's leaf cap: a
// multiple of 32 in [32, 512], 128 by default), as the tq width is
// (s3_common.cuh): ops/stream3_stages.py builds one library for each
// (T, tq bits) pair a process uses.  The staged leaf holds T lanes; past
// T = 128 the two-slot ring no longer fits beside the block's other
// arrays in 48 KB, so it moves to dynamic shared memory.
#ifndef RT_LEAF_T
#define RT_LEAF_T 128
#endif
#define RT_LEAF_MAXT RT_LEAF_T
#include "leaf_tile.cuh"
#include "s3_common.cuh"

namespace {

using lt::kFltMax;

constexpr int kThreads = s3::kBlk;    // one block per (chunk, slot, ray block)
constexpr int kWarps = kThreads / 32;
constexpr int kT = RT_LEAF_T;         // triangles per leaf
static_assert(kT % 32 == 0 && kT >= 32 && kT <= 512,
              "RT_LEAF_T must be a multiple of 32 in [32, 512]");
constexpr bool kDynRing = kT > 128;   // the ring in dynamic shared memory
constexpr int kRingBytes = kDynRing ? 2 * lt::kLeafF4 * 16 : 0;
constexpr int kChunk = kThreads;      // list positions per block
constexpr int kMaxR = kThreads / 32;  // rays a thread holds
constexpr float kParked = 1e29f;
constexpr unsigned long long kNoHit = ~0ull;

// Lanes of the staged leaf L that hold a triangle: its first invalid
// lane, by a binary search of the prim row (valid lanes are a prefix).
__device__ __forceinline__ int leaf_tris(const float4* L) {
  const float* prim = reinterpret_cast<const float*>(L + lt::kPrimF4);
  int lo = 0, hi = kT;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float p = prim[mid];
    if (p >= 0.f && p < 16777216.f) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ lt::Ray ray_of(const float4& x0, const float4& x1,
                                          const float4& x2) {
  // feats: d (0-2), o x d (3-5), o (6-8)
  return lt::Ray{x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w, x2.x};
}

// wb: the cull's double-buffered rows of partial-best bits [2][kWarps *
// kThreads] (unused without kCull).
template <bool kStable, bool kCull, int R>
__device__ __forceinline__ void run_block(
    float4 (*ring)[lt::kLeafF4], const float4 (*s_ray)[3], const int* s_idx,
    const int* s_leaf, const int* s_pos, const int* s_lb, int* wb,
    int nkept, int nact, const float* __restrict__ kleaf, float tmin,
    float tmax, unsigned long long* __restrict__ key_row,
    int* __restrict__ culled) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ahead_only = tmin >= 0.f;
  const bool cull = kCull && ahead_only && nact == kThreads;
  lt::Ray ray[R];
  lt::Best best[R];
  int best_pos[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    // past the list's end a thread tests a duplicate and records nothing
    const int j = min(lane + 32 * i, nact - 1);
    ray[i] = ray_of(s_ray[j][0], s_ray[j][1], s_ray[j][2]);
    best[i] = lt::Best{kFltMax, kT};
    best_pos[i] = 0;
  }
  int nskip = 0;
  for (int k = 0; k < nkept; ++k) {
    lt::cp_async_wait<0>();           // this thread's copies of leaf k
    __syncthreads();                  // everyone's; leaf k - 1 is done
    if (k + 1 < nkept) {
      lt::stage_leaf<true>(ring[(k + 1) & 1],
                           kleaf + static_cast<int64_t>(s_leaf[k + 1]) * 16 * 4 * kT,
                           kT, lt::kQ, tid, kThreads);
    }
    lt::cp_async_commit();
    const float4* L = ring[k & 1];
    const int nq = (leaf_tris(L) + 3) >> 2;
    if (kStable) {
      const float cx = L[lt::kCenF4].x, cy = L[lt::kCenF4 + 1].x;
      const float cz = L[lt::kCenF4 + 2].x;
#pragma unroll
      for (int i = 0; i < R; ++i) lt::set_moment(ray[i], cx, cy, cz);
    }
    const int pos = s_pos[k];
    bool skip = false;
    if (cull && k > 0) {   // the bests after leaf k - 1
      const int* prev = wb + ((k - 1) & 1) * kWarps * kThreads;
      int worst = 0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        int m = prev[lane + 32 * i];
#pragma unroll
        for (int v = 1; v < kWarps; ++v) {
          m = min(m, prev[v * kThreads + lane + 32 * i]);
        }
        worst = max(worst, m);
      }
      skip = s_lb[k] >= __reduce_max_sync(~0u, worst);
      nskip += skip;
    }
    if (!skip) {
      for (int q = warp; q < nq; q += kWarps) {
        bool changed[R];
        lt::test_quad<R, false>(L, q, ray, tmin, tmax, ahead_only, best,
                                changed);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (changed[i]) best_pos[i] = pos;
        }
      }
    }
    if (cull) {
      int* cur = wb + (k & 1) * kWarps * kThreads + warp * kThreads;
#pragma unroll
      for (int i = 0; i < R; ++i) cur[lane + 32 * i] = __float_as_int(best[i].t);
    }
  }
  if (kCull && culled != nullptr && tid == 0 && nskip > 0) {
    atomicAdd(culled, nskip);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (lane + 32 * i < nact && best[i].lane < kT) {
      atomicMin(&key_row[s_idx[lane + 32 * i]],
                (static_cast<unsigned long long>(lt::ordered(best[i].t)) << 32) |
                    (static_cast<unsigned long long>(best[i].lane) << 16) |
                    static_cast<unsigned>(best_pos[i]));
    }
  }
}

template <bool kStable, bool kCull>
__global__ void __launch_bounds__(kThreads, 3)
isect_kernel(const int* __restrict__ words, const int* __restrict__ emeta,
             const int* __restrict__ slot_pkt,
             const float* __restrict__ feats, const float* __restrict__ kleaf,
             int pcap, float tmin, float tmax, int nslot,
             unsigned long long* __restrict__ keys, int* __restrict__ culled) {
#if RT_LEAF_T > 128
  extern __shared__ float4 s_dyn[];
  auto s_ring = reinterpret_cast<float4 (*)[lt::kLeafF4]>(s_dyn);
#else
  __shared__ float4 s_ring[2][lt::kLeafF4];
#endif
  __shared__ float4 s_ray[kThreads][3];   // the compacted rays' features
  __shared__ int s_idx[kThreads];         // their lanes in the block
  __shared__ int s_leaf[kChunk];          // the chunk's kept leaves
  __shared__ int s_pos[kChunk];           // and their list positions
  __shared__ int s_scan[2][kWarps];
  // the cull's entry bounds of the kept leaves, and its rows of partial
  // bests (one int each without kCull)
  __shared__ int s_lb[kCull ? kChunk : 1];
  __shared__ int s_wb[kCull ? 2 * kWarps * kThreads : 1];

  // chunk-major, as kernel E's grid
  const int chunk = blockIdx.x / (nslot * 8);
  const int slot = (blockIdx.x >> 3) % nslot, blk = blockIdx.x & 7;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int cnt = min(emeta[slot * 8], pcap);
  const int w0 = chunk * kChunk;
  if (w0 >= cnt) return;

  // the chunk's words whose keep bit `blk` is set, in list order
  const int j = w0 + tid;
  const int wd = j < cnt ? words[static_cast<int64_t>(slot) * pcap + j] : 0;
  const bool kept = (wd >> (s3::kKeepShift + blk)) & 1;
  const unsigned kb = __ballot_sync(~0u, kept);
  // the block's rays that are not parked
  const int64_t ray =
      static_cast<int64_t>(slot_pkt[slot]) * s3::kPkt + blk * s3::kBlk + tid;
  const float4* x = reinterpret_cast<const float4*>(feats + ray * 16);
  const float4 x0 = x[0], x1 = x[1], x2 = x[2];
  const bool act = fabsf(x1.z) < kParked && fabsf(x1.w) < kParked &&
                   fabsf(x2.x) < kParked;
  const unsigned ab = __ballot_sync(~0u, act);
  if (lane == 0) {
    s_scan[0][warp] = __popc(kb);
    s_scan[1][warp] = __popc(ab);
  }
  __syncthreads();
  int koff = __popc(kb & below), aoff = __popc(ab & below);
  int nkept = 0, nact = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    if (v < warp) {
      koff += s_scan[0][v];
      aoff += s_scan[1][v];
    }
    nkept += s_scan[0][v];
    nact += s_scan[1][v];
  }
  if (nkept == 0 || nact == 0) return;
  if (kept) {
    s_leaf[koff] = s3::word_leaf(wd);
    s_pos[koff] = j;
    if (kCull) s_lb[koff] = s3::word_lb_bits(wd);
  }
  if (act) {
    s_ray[aoff][0] = x0;
    s_ray[aoff][1] = x1;
    s_ray[aoff][2] = x2;
    s_idx[aoff] = tid;
  }
  __syncthreads();
  lt::stage_leaf<true>(s_ring[0], kleaf + static_cast<int64_t>(s_leaf[0]) * 16 * 4 * kT,
                       kT, lt::kQ, tid, kThreads);
  lt::cp_async_commit();

  unsigned long long* key_row =
      keys + static_cast<int64_t>(slot) * s3::kPkt + blk * s3::kBlk;
  switch ((nact + 31) >> 5) {
    case 1: run_block<kStable, kCull, 1>(s_ring, s_ray, s_idx, s_leaf, s_pos, s_lb, s_wb, nkept, nact, kleaf, tmin, tmax, key_row, culled); break;
    case 2: run_block<kStable, kCull, 2>(s_ring, s_ray, s_idx, s_leaf, s_pos, s_lb, s_wb, nkept, nact, kleaf, tmin, tmax, key_row, culled); break;
    case 3: run_block<kStable, kCull, 3>(s_ring, s_ray, s_idx, s_leaf, s_pos, s_lb, s_wb, nkept, nact, kleaf, tmin, tmax, key_row, culled); break;
    default: run_block<kStable, kCull, kMaxR>(s_ring, s_ray, s_idx, s_leaf, s_pos, s_lb, s_wb, nkept, nact, kleaf, tmin, tmax, key_row, culled); break;
  }
  lt::cp_async_wait<0>();
}

__global__ void isect_keys(unsigned long long* __restrict__ keys, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = kNoHit;
}

// One thread per slot lane: the key's winner -> (t, prim, b1, b2), or
// (t, prim, 0, 0) with kLean.
template <bool kStable, bool kLean>
__global__ void isect_finish(const unsigned long long* __restrict__ keys,
                             const int* __restrict__ words,
                             const int* __restrict__ slot_pkt,
                             const float* __restrict__ feats,
                             const float* __restrict__ kleaf, int pcap,
                             int64_t n, float4* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long k = keys[i];
  if (k == kNoHit) {
    out[i] = make_float4(kFltMax, -1.f, 0.f, 0.f);
    return;
  }
  const int64_t slot = i / s3::kPkt;
  const int ln = static_cast<int>((k >> 16) & 0xffff);
  const int pos = static_cast<int>(k & 0xffff);
  const float* W = kleaf + static_cast<int64_t>(
      s3::word_leaf(words[slot * pcap + pos])) * 16 * 4 * kT;
  const float t = lt::unordered(static_cast<unsigned>(k >> 32));
  if (kLean) {
    out[i] = make_float4(t, __ldg(W + 10 * 4 * kT + ln), 0.f, 0.f);
    return;
  }
  const int64_t ray = static_cast<int64_t>(slot_pkt[slot]) * s3::kPkt +
                      i % s3::kPkt;
  const float4* x = reinterpret_cast<const float4*>(feats + ray * 16);
  lt::Ray r = ray_of(x[0], x[1], x[2]);
  if (kStable) {
    lt::set_moment(r, __ldg(W + 12 * 4 * kT), __ldg(W + 13 * 4 * kT),
                   __ldg(W + 14 * 4 * kT));
  }
  float s[3], num;
  lt::lane_products(W, kT, ln, r, s, num);
  const float rv = __frcp_rn(lt::ssum3(s[0], s[1], s[2]));
  out[i] = make_float4(t, __ldg(W + 10 * 4 * kT + ln), __fmul_rn(s[2], rv),
                       __fmul_rn(s[0], rv));
}

template <bool kStable, bool kCull, bool kLean>
void launch(const int* words, const int* emeta, const int* slot_pkt,
            const float* feats, const float* kleaf, int nslot, int pcap,
            float tmin, float tmax, unsigned long long* k, float4* o,
            int* culled, unsigned grid, unsigned fill, int64_t lanes,
            cudaStream_t s) {
  if (kDynRing) {
    cudaFuncSetAttribute(isect_kernel<kStable, kCull>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kRingBytes);
  }
  isect_kernel<kStable, kCull><<<grid, kThreads, kRingBytes, s>>>(
      words, emeta, slot_pkt, feats, kleaf, pcap, tmin, tmax, nslot, k,
      culled);
  isect_finish<kStable, kLean><<<fill, 256, 0, s>>>(
      k, words, slot_pkt, feats, kleaf, pcap, lanes, o);
}

}  // namespace

extern "C" {

// words [nslot, pcap] i32 (refined lists, pcap <= 65536), emeta [nslot,
// 8] i32 (lane 0: count), slot_pkt [nslot] i32, feats [npad, 16] f32
// (ray-major), kleaf [nl, 16, 4 * RT_LEAF_T] f32 (both 16-byte aligned), keys
// [nslot * 1024] u64 scratch -> out [nslot, 1024, 4] f32.  lean: lanes
// 2-3 left zero; cull: the tq occlusion cull, which adds the pairs it
// skipped to *culled unless culled is null.  Returns cudaGetLastError().
int rt_s3_isect(const int* words, const int* emeta, const int* slot_pkt,
                const float* feats, const float* kleaf, int nslot, int pcap,
                float tmin, float tmax, int stable, int lean, int cull,
                void* keys, float* out, int* culled, void* stream) {
  if (nslot <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<unsigned long long*>(keys);
  const int64_t lanes = static_cast<int64_t>(nslot) * s3::kPkt;
  const unsigned fill = static_cast<unsigned>((lanes + 255) / 256);
  isect_keys<<<fill, 256, 0, s>>>(k, lanes);
  const int nchunk = (max(pcap, 1) + kChunk - 1) / kChunk;
  const unsigned grid = static_cast<unsigned>(nchunk) * nslot *
                        (s3::kPkt / s3::kBlk);
  auto* o = reinterpret_cast<float4*>(out);
  using Fn = void (*)(const int*, const int*, const int*, const float*,
                      const float*, int, int, float, float,
                      unsigned long long*, float4*, int*, unsigned,
                      unsigned, int64_t, cudaStream_t);
  static const Fn forms[8] = {
      launch<false, false, false>, launch<false, false, true>,
      launch<false, true, false>, launch<false, true, true>,
      launch<true, false, false>, launch<true, false, true>,
      launch<true, true, false>, launch<true, true, true>};
  forms[(stable ? 4 : 0) + (cull ? 2 : 0) + (lean ? 1 : 0)](
      words, emeta, slot_pkt, feats, kleaf, nslot, pcap, tmin, tmax, k, o,
      culled, grid, fill, lanes, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
