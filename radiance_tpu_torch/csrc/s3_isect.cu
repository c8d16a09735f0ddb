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
// :2054-2082): the lowest (t, lane, word position).  The TPU kernel's tq
// occlusion cull is not kept: at equal t it could drop a lower lane.
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
//     same bits in both passes).
//
// What bounds it: FLOPs.  The work the function needs is, for each kept
// (leaf, block) pair, the block's rays that are not parked against the
// leaf's triangle lanes at 22 FMAs each (chip_smoke.py counts them with
// the plain version's stats); a leaf is read from L2 once per block that
// keeps it.  Every product is an FP32 FMA on the CUDA cores, never TF32
// or the tensor cores.

#include "leaf_tile.cuh"
#include "s3_common.cuh"

namespace {

using lt::kFltMax;

constexpr int kThreads = s3::kBlk;    // one block per (chunk, slot, ray block)
constexpr int kWarps = kThreads / 32;
constexpr int kT = 128;               // triangles per leaf
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

template <bool kStable, int R>
__device__ __forceinline__ void run_block(
    float4 (*ring)[lt::kLeafF4], const float4 (*s_ray)[3], const int* s_idx,
    const int* s_leaf, const int* s_pos, int nkept, int nact,
    const float* __restrict__ kleaf, float tmin, float tmax,
    unsigned long long* __restrict__ key_row) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ahead_only = tmin >= 0.f;
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

template <bool kStable>
__global__ void __launch_bounds__(kThreads, 3)
isect_kernel(const int* __restrict__ words, const int* __restrict__ emeta,
             const int* __restrict__ slot_pkt,
             const float* __restrict__ feats, const float* __restrict__ kleaf,
             int pcap, float tmin, float tmax, int nslot,
             unsigned long long* __restrict__ keys) {
  __shared__ float4 s_ring[2][lt::kLeafF4];
  __shared__ float4 s_ray[kThreads][3];   // the compacted rays' features
  __shared__ int s_idx[kThreads];         // their lanes in the block
  __shared__ int s_leaf[kChunk];          // the chunk's kept leaves
  __shared__ int s_pos[kChunk];           // and their list positions
  __shared__ int s_scan[2][kWarps];

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
    case 1: run_block<kStable, 1>(s_ring, s_ray, s_idx, s_leaf, s_pos, nkept, nact, kleaf, tmin, tmax, key_row); break;
    case 2: run_block<kStable, 2>(s_ring, s_ray, s_idx, s_leaf, s_pos, nkept, nact, kleaf, tmin, tmax, key_row); break;
    case 3: run_block<kStable, 3>(s_ring, s_ray, s_idx, s_leaf, s_pos, nkept, nact, kleaf, tmin, tmax, key_row); break;
    default: run_block<kStable, kMaxR>(s_ring, s_ray, s_idx, s_leaf, s_pos, nkept, nact, kleaf, tmin, tmax, key_row); break;
  }
  lt::cp_async_wait<0>();
}

__global__ void isect_keys(unsigned long long* __restrict__ keys, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = kNoHit;
}

// One thread per slot lane: the key's winner -> (t, prim, b1, b2).
template <bool kStable>
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
  out[i] = make_float4(lt::unordered(static_cast<unsigned>(k >> 32)),
                       __ldg(W + 10 * 4 * kT + ln), __fmul_rn(s[2], rv),
                       __fmul_rn(s[0], rv));
}

}  // namespace

extern "C" {

// words [nslot, pcap] i32 (refined lists, pcap <= 65536), emeta [nslot,
// 8] i32 (lane 0: count), slot_pkt [nslot] i32, feats [npad, 16] f32
// (ray-major), kleaf [nl, 16, 512] f32 (both 16-byte aligned), keys
// [nslot * 1024] u64 scratch -> out [nslot, 1024, 4] f32.  Returns
// cudaGetLastError().
int rt_s3_isect(const int* words, const int* emeta, const int* slot_pkt,
                const float* feats, const float* kleaf, int nslot, int pcap,
                float tmin, float tmax, int stable, void* keys, float* out,
                void* stream) {
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
  if (stable) {
    isect_kernel<true><<<grid, kThreads, 0, s>>>(
        words, emeta, slot_pkt, feats, kleaf, pcap, tmin, tmax, nslot, k);
    isect_finish<true><<<fill, 256, 0, s>>>(k, words, slot_pkt, feats, kleaf,
                                            pcap, lanes, o);
  } else {
    isect_kernel<false><<<grid, kThreads, 0, s>>>(
        words, emeta, slot_pkt, feats, kleaf, pcap, tmin, tmax, nslot, k);
    isect_finish<false><<<fill, 256, 0, s>>>(k, words, slot_pkt, feats, kleaf,
                                             pcap, lanes, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
