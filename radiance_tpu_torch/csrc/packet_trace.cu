// Packet-table BVH traversal for Hopper (sm_90a): one cursor per packet.
//
// Replaces the TPU kernel radiance_tpu/ops/packet_trace.py::_kernel
// (launched by _run through pl.pallas_call, :532).  Given object-space
// rays, the escape-threaded octant node tables knode_f [8*Nk, 16] f32 and
// the Pluecker leaf matrices kleaf [Nl, 16, 4T] f32 (bvh/kernel_pack.py),
// it writes per ray the nearest accepted t in (tmin, tmax) and the face
// row of that triangle (-1 on a miss).
//
// Schedule: the TPU kernel's.  One block of kP = 64 threads is one
// packet of 64 rays, a thread per ray.  The block walks one table -- the
// packet-mean direction octant's, whose row base the wrapper computes as
// packet_trace.py's _run does -- with one shared cursor.
//  * Node step: every live ray tests the node's box against its own
//    clip (its best t); the step is a vote (__syncthreads_or): the packet
//    opens the node if any ray hits it.  Dead rays (masked) and rays
//    whose any-hit is found never vote.
//  * A leaf some ray enters is staged: the rays inside its box are
//    compacted (ballot) into a list, and its used rows -- the 22
//    coefficient rows of its ntri lanes and the centroid
//    (csrc/leaf_tile.cuh) -- start copying into one slot of a two-slot
//    shared-memory ring with cp.async.  Then the previously staged leaf,
//    whose copy was in flight across the node steps since, is tested:
//    the TPU kernel's two-slot leaf DMA.  The last one drains after the
//    walk.
//  * Leaf tile: the (two listed rays, quad of four triangles) items are
//    spread over the packet's threads.  An item is 22 float4 shared
//    loads for 176 FMAs plus the tests (leaf_tile.cuh's test_quad); the
//    sign test and, where tmin >= 0, a sign check of num against ssum
//    come before any division, so triangles behind the ray and padded
//    lanes never reach it.  Each ray's best (t, lane) of an item goes to
//    its leaf-local 64-bit key by atomicMin in shared memory (t's
//    order-preserving bits, then the lane); after the leaf the ray's own
//    thread folds the key into its running best.
//
// Results are exact whatever table a packet walks: a ray's hits are
// tested in every leaf whose box it enters before its clip.  Ties: per
// leaf the key keeps the lowest lane among equal t; across leaves a ray
// takes (t, lane) only if it beats its best by t, or ties it with a
// lower lane -- the reference's per-(ray, lane) strict < across leaves,
// then the lowest lane (packet_trace.py:227-233, 327-333).
//
// What bounds it on an H100: the FP32 rate on the leaf tests (22 FMAs a
// ray-triangle test, the rays inside each leaf box against its ntri
// triangles: 17.6 GFLOP on the city's 1080p primary, 0.26 ms), and the
// walk's chain of dependent node loads, a vote and a barrier per step.
// The packet shares each node row and leaf copy among its rays and keeps
// warps converged through the tree; the tile feeds 8 FMAs per float4
// loaded; the ring hides a leaf's copy behind the walk.
//
// Leaf width: T lanes at run time, up to the staged tile's kMaxT
// (leaf_tile.cuh's RT_LEAF_MAXT, 128 by default).  A scene built with a
// leaf cap past 128 takes a library built with RT_LEAF_MAXT = its cap;
// its Shared state then passes 48 KB and lives in dynamic shared memory.
//
// Exactness rules kept from the TPU kernel:
//  * node meta words 8-11 are f32 VALUES (a, esc, ntri, tri_start), read
//    by value conversion, not by bit cast;
//  * slab min/max propagate NaN like jnp.minimum/maximum (fminf/fmaxf
//    would drop it): an axis-parallel ray lying exactly on a slab plane
//    gets 0 * inf = NaN and misses that box, as in the reference;
//  * inside test by the sign bits of the three side products, then
//    t = -num / (s0 + s1 + s2) with IEEE division; the stable frame's
//    moment term after the direction terms (leaf_tile.cuh); no
//    --use_fast_math, so no flush-to-zero or approximate division;
//  * any_hit retires a ray at its first accepted leaf hit and ends the
//    packet when every live ray has one; the t returned is that hit's;
//  * masked: dead rays (live[i] == 0) vote for nothing, are tested
//    against nothing and write a miss, so NaN/Inf in a dead lane never
//    reaches a live one.

#include "leaf_tile.cuh"

namespace {

using lt::kFltMax;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// Rays in a packet, one block: 64 measured fastest of 32, 64 and 128
// over the main path's launches on an H100.
constexpr int kP = 64;
constexpr int kWarps = kP / 32;
constexpr bool kDynShared = lt::kMaxT > 128;

// The packet's shared state.
struct Shared {
  float4 leaf[2][lt::kLeafF4];       // the two-slot leaf ring
  float4 ray[kP][3];                 // d, o and the legacy moment o x d
  float2 best[kP];                   // each ray's running best (t, lane)
  unsigned long long key[kP];        // each ray's best in the leaf tested
  int list[2][kP];                   // rays inside each staged leaf's box
  int wcnt[2][kWarps];               // per-warp list counts of a vote
};

// Test the staged leaf in ring slot `slot` against its listed rays and
// fold the results into each ray's running best (the calling thread's
// ray: best_t, best_lane, best_tri).
template <bool kStable>
__device__ __forceinline__ void process_leaf(Shared& sh, int slot, int nin,
                                             int ntri, int tri_start,
                                             float tmin, float tmax,
                                             float& best_t, int& best_lane,
                                             int& best_tri) {
  const int tid = threadIdx.x;
  sh.key[tid] = ~0ull;
  __syncthreads();                  // the copy, the list and keys are set
  const float4* L = sh.leaf[slot];
  const int nq = (ntri + 3) >> 2;
  const bool ahead_only = tmin >= 0.f;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (kStable) {
    cx = L[lt::kCenF4].x;
    cy = L[lt::kCenF4 + 1].x;
    cz = L[lt::kCenF4 + 2].x;
  }
  // items: (pair of listed rays, quad); an odd list's last pair tests
  // its ray twice and records it once
  const int npair = (nin + 1) >> 1;
  for (int it = tid; it < npair * nq; it += kP) {
    const int q = it / npair;
    const int j = 2 * (it - q * npair);
    const int rr[2] = {sh.list[slot][j], sh.list[slot][min(j + 1, nin - 1)]};
    lt::Ray ray[2];
    lt::Best bst[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4 a = sh.ray[rr[u]][0], b = sh.ray[rr[u]][1];
      const float4 c = sh.ray[rr[u]][2];
      ray[u] = lt::Ray{a.x, a.y, a.z, c.x, c.y, c.z, a.w, b.x, b.y};
      if (kStable) lt::set_moment(ray[u], cx, cy, cz);
      const float2 rb = sh.best[rr[u]];
      bst[u] = lt::Best{rb.x, static_cast<int>(rb.y)};
    }
    bool changed[2];
    lt::test_quad<2, true>(L, q, ray, tmin, tmax, ahead_only, bst, changed);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (changed[u] && (u == 0 || j + 1 < nin)) {
        atomicMin(&sh.key[rr[u]],
                  (static_cast<unsigned long long>(lt::ordered(bst[u].t)) << 32) |
                      static_cast<unsigned>(bst[u].lane));
      }
    }
  }
  __syncthreads();                  // every pair's key is in
  const unsigned long long k = sh.key[tid];
  if (k != ~0ull) {
    const float t = lt::unordered(static_cast<unsigned>(k >> 32));
    const int ln = static_cast<int>(k & 0xffffffffu);
    if (t < best_t || (t == best_t && ln < best_lane)) {
      best_t = t;
      best_lane = ln;
      best_tri = tri_start + ln;
      sh.best[tid] = make_float2(t, static_cast<float>(ln));
    }
  }
}

template <bool kAnyHit, bool kMasked, bool kStable>
__global__ void __launch_bounds__(kP)
packet_trace_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const uint8_t* __restrict__ live,
                    const int* __restrict__ base,
                    const float* __restrict__ knode,
                    const float* __restrict__ kleaf, int64_t n, int lanes,
                    float tmin, float tmax, float* __restrict__ out_t,
                    int* __restrict__ out_tri) {
#if RT_LEAF_MAXT > 128
  extern __shared__ float4 s_dyn[];
  Shared& sh = *reinterpret_cast<Shared*>(s_dyn);
#else
  __shared__ Shared sh;
#endif
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kP + tid;
  const bool active = i < n && (!kMasked || live[i] != 0);

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  if (active) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
  }
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  {
    lt::Ray r{dx, dy, dz, 0.f, 0.f, 0.f, ox, oy, oz};
    if (!kStable) lt::set_moment(r, 0.f, 0.f, 0.f);   // o x d
    sh.ray[tid][0] = make_float4(dx, dy, dz, ox);
    sh.ray[tid][1] = make_float4(oy, oz, 0.f, 0.f);
    sh.ray[tid][2] = make_float4(r.px, r.py, r.pz, 0.f);
  }
  sh.best[tid] = make_float2(kFltMax, static_cast<float>(lanes));

  const float4* rows =
      reinterpret_cast<const float4*>(knode) + static_cast<int64_t>(base[blockIdx.x]) * 4;
  const int64_t L = 4 * static_cast<int64_t>(lanes);
  float best_t = kFltMax;
  int best_lane = lanes, best_tri = -1;
  // the staged leaf waiting to be tested
  int cnt = 0, p_nin = 0, p_ntri = 0, p_start = 0;
  int step = 0;
  int idx = 0;
  while (idx >= 0) {
    const float4 r0 = __ldg(rows + 4 * static_cast<int64_t>(idx));      // min.xyz, max.x
    const float4 r1 = __ldg(rows + 4 * static_cast<int64_t>(idx) + 1);  // max.yz
    const float4 r2 = __ldg(rows + 4 * static_cast<int64_t>(idx) + 2);  // meta values
    const int a = static_cast<int>(r2.x);
    const int esc = static_cast<int>(r2.y);
    const int ntri = static_cast<int>(r2.z);
    const int tri_start = static_cast<int>(r2.w);

    bool in_box = false;
    if (active && !(kAnyHit && best_t < kFltMax)) {
      const float clip = fminf(best_t, tmax);
      const float t0x = (r0.x - ox) * ix, t1x = (r0.w - ox) * ix;
      const float t0y = (r0.y - oy) * iy, t1y = (r1.x - oy) * iy;
      const float t0z = (r0.z - oz) * iz, t1z = (r1.y - oz) * iz;
      const float tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                               nan_min(t0z, t1z));
      const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                               nan_max(t0z, t1z));
      in_box = (tf >= nan_max(tn, 0.f)) && (tn < clip);
    }
    if (ntri > 0) {
      // a leaf: list the rays inside its box; the vote's barrier
      // publishes the per-warp counts (double-buffered by step parity: a
      // warp a step ahead writes the other half)
      const int par = step & 1;
      const unsigned bal = __ballot_sync(~0u, in_box);
      if (lane == 0) sh.wcnt[par][warp] = __popc(bal);
      if (__syncthreads_or(in_box)) {
        const int slot = cnt & 1;
        int off = __popc(bal & below), nin = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int c = sh.wcnt[par][w];
          if (w < warp) off += c;
          nin += c;
        }
        if (in_box) sh.list[slot][off] = tid;
        lt::stage_leaf<false>(sh.leaf[slot], kleaf + static_cast<int64_t>(a) * 16 * L,
                              lanes, (ntri + 3) >> 2, tid, kP);
        lt::cp_async_commit();
        if (cnt > 0) {
          lt::cp_async_wait<1>();     // the previous leaf's copy
          process_leaf<kStable>(sh, slot ^ 1, p_nin, p_ntri, p_start, tmin,
                                tmax, best_t, best_lane, best_tri);
        }
        p_nin = nin;
        p_ntri = ntri;
        p_start = tri_start;
        ++cnt;
        if (kAnyHit && cnt > 1 &&
            __syncthreads_and(!active || best_t < kFltMax)) {
          cnt = 0;                    // every live ray has a hit: done
          break;
        }
      }
      idx = esc;
    } else {
      idx = __syncthreads_or(in_box) ? a : esc;
    }
    ++step;
  }
  if (cnt > 0) {                      // drain the last staged leaf
    lt::cp_async_wait<0>();
    process_leaf<kStable>(sh, (cnt - 1) & 1, p_nin, p_ntri, p_start, tmin,
                          tmax, best_t, best_lane, best_tri);
  } else {
    lt::cp_async_wait<0>();           // a copy may still be in flight
  }
  if (i < n) {
    out_t[i] = best_t;
    out_tri[i] = best_tri;
  }
}

template <bool kAnyHit, bool kMasked, bool kStable>
void launch(const float* o, const float* d, const uint8_t* live,
            const int* base, const float* knode, const float* kleaf,
            int64_t n, int lanes, float tmin, float tmax, float* out_t,
            int* out_tri, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((n + kP - 1) / kP);
  constexpr int kDynBytes = kDynShared ? static_cast<int>(sizeof(Shared)) : 0;
  if (kDynShared) {
    cudaFuncSetAttribute(packet_trace_kernel<kAnyHit, kMasked, kStable>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kDynBytes);
  }
  packet_trace_kernel<kAnyHit, kMasked, kStable><<<grid, kP, kDynBytes, stream>>>(
      o, d, live, base, knode, kleaf, n, lanes, tmin, tmax, out_t, out_tri);
}

}  // namespace

extern "C" {

// Trace n rays in packets of 64 rays.  o, d: [n, 3] f32 (object space);
// live: [n] u8 or NULL (NULL = every ray live, the unmasked variant);
// base: [ceil(n / 64)] i32, each packet's node table row base (octant *
// nk); knode: [8 * nk, 16] f32; kleaf: [Nl, 16, 4 * lanes] f32, 16-byte
// aligned, lanes a multiple of 4 and <= RT_LEAF_MAXT; out_t: [n] f32; out_tri:
// [n] i32.  Enqueues on `stream` and returns cudaGetLastError() of the
// launch (cudaErrorInvalidValue for a lane count it does not take).
int rt_packet_trace(const float* o, const float* d, const uint8_t* live,
                    const int* base, const float* knode, const float* kleaf,
                    int64_t n, int lanes, float tmin, float tmax, int any_hit,
                    int stable, float* out_t, int* out_tri, void* stream) {
  if (n <= 0) return 0;
  if (lanes % 4 || lanes > lt::kMaxT || lanes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = (any_hit ? 4 : 0) | (live ? 2 : 0) | (stable ? 1 : 0);
  switch (v) {
    case 0: launch<false, false, false>(o, d, live, base, knode, kleaf, n, lanes, tmin, tmax, out_t, out_tri, s); break;
    case 1: launch<false, false, true>(o, d, live, base, knode, kleaf, n, lanes, tmin, tmax, out_t, out_tri, s); break;
    case 2: launch<false, true, false>(o, d, live, base, knode, kleaf, n, lanes, tmin, tmax, out_t, out_tri, s); break;
    case 3: launch<false, true, true>(o, d, live, base, knode, kleaf, n, lanes, tmin, tmax, out_t, out_tri, s); break;
    case 4: launch<true, false, false>(o, d, live, base, knode, kleaf, n, lanes, tmin, tmax, out_t, out_tri, s); break;
    case 5: launch<true, false, true>(o, d, live, base, knode, kleaf, n, lanes, tmin, tmax, out_t, out_tri, s); break;
    case 6: launch<true, true, false>(o, d, live, base, knode, kleaf, n, lanes, tmin, tmax, out_t, out_tri, s); break;
    default: launch<true, true, true>(o, d, live, base, knode, kleaf, n, lanes, tmin, tmax, out_t, out_tri, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
