// Packet-table BVH traversal for Hopper (sm_90a): a ray-private walk of
// each packet's table.
//
// Replaces the TPU kernel radiance_tpu/ops/packet_trace.py::_kernel
// (launched by _run through pl.pallas_call, :532).  Given object-space
// rays, the escape-threaded octant node tables knode_f [8*Nk, 16] f32 and
// the Pluecker leaf matrices kleaf [Nl, 16, 4T] f32 (bvh/kernel_pack.py),
// it writes per ray the nearest accepted t in (tmin, tmax) and the face
// row of that triangle (-1 on a miss).
//
// Schedule.  A packet is kP = 64 consecutive rays, one block of 64
// threads, a thread per ray.  The packet picks one table -- the
// packet-mean direction octant's, whose row base the wrapper computes as
// packet_trace.py's _run does -- and each ray walks it with its own
// cursor: a on a box hit, esc on a miss or after a leaf (the table is
// escape-threaded, so no stack).  No ray steps through a node for
// another ray and there is no block-wide vote; a ray steps alone until it
// stands at a leaf whose box it enters.
//  * Leaf test, a warp at a time, once every ray of the warp stands at a
//    leaf or is done: the rays are grouped by leaf (__match_any_sync) and
//    each leaf is tested once for all the warp's rays at it.  Leaf lane l
//    goes to warp lane l % 32, in passes of 32 lanes; each lane loads its
//    triangle's 22 coefficients straight from kleaf's [row, lane] layout
//    (a coalesced 128-byte row a warp).  The group's rays are broadcast
//    (shuffles) one at a time and tested by every lane; the lanes'
//    accepted (t, lane) that improve the ray's best fold by a shuffle
//    min of a 64-bit key (t's order-preserving bits, then the lane) into
//    the ray's running best.
//  * No shared memory: a block holds only its registers (63 a thread),
//    so 16 blocks (32 warps) fit an SM.
//
// Why not the TPU kernel's schedule (one cursor a packet, a vote a node,
// each leaf some ray enters staged in a shared-memory ring and tested as
// a tile): on a diffuse bounce the 64 rays of a packet fan out, so a
// packet's walk is close to the union of theirs (8.8 times a ray's node
// steps on the interior's 1080p bounce) and every ray waits at every
// vote, and a 28-KB leaf ring held an SM to 8 blocks.  On an H100 the
// ray-private walk ran the interior's diffuse bounce waves 2.7-3.3 times
// faster than that schedule, coherent shadows, mirror bounces and
// primaries 8-40 percent faster, and the interior's mirror bounce 2-4
// percent slower (PERF.md, row 1).
//
// Results are exact whatever table a packet walks: a ray's hits are tested
// in every leaf whose box it enters before its clip (its best t), and a
// leaf's arithmetic is leaf_tile.cuh's test_quad's, operation for
// operation.  Ties: per leaf the lowest lane among equal t; across
// leaves a ray takes (t, lane) only if it beats its best by t, or ties it
// with a lower lane -- the reference's per-(ray, lane) strict < across
// leaves, then the lowest lane (packet_trace.py:227-233, 327-333).
//
// What bounds it on an H100: the FP32 rate on the leaf tests (22 FMAs a
// ray-triangle test, the rays inside each leaf box against its ntri
// triangles), the coefficient rows a leaf's group loads, and each ray's
// chain of dependent node loads.
//
// Leaf width: any T that is a multiple of 4 (a pass covers 32 lanes).
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
//  * any_hit retires a ray at its first leaf with an accepted hit; the t
//    returned is that leaf's nearest;
//  * masked: dead rays (live[i] == 0) walk nothing, are tested against
//    nothing and write a miss, so NaN/Inf in a dead lane never reaches a
//    live one.

#include "leaf_tile.cuh"

namespace {

using lt::kFltMax;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// Rays in a packet: one block, walking one table.
constexpr int kP = 64;

template <bool kAnyHit, bool kMasked, bool kStable>
__global__ void __launch_bounds__(kP)
packet_trace_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const uint8_t* __restrict__ live,
                    const int* __restrict__ base,
                    const float* __restrict__ knode,
                    const float* __restrict__ kleaf, int64_t n, int lanes,
                    float tmin, float tmax, float* __restrict__ out_t,
                    int* __restrict__ out_tri) {
  const int lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kP + threadIdx.x;
  const bool active = i < n && (!kMasked || live[i] != 0);

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  if (active) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
  }
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  lt::Ray ray{dx, dy, dz, 0.f, 0.f, 0.f, ox, oy, oz};
  if (!kStable) lt::set_moment(ray, 0.f, 0.f, 0.f);   // o x d

  const float4* rows =
      reinterpret_cast<const float4*>(knode) + static_cast<int64_t>(base[blockIdx.x]) * 4;
  const int64_t L = 4 * static_cast<int64_t>(lanes);
  const bool ahead_only = tmin >= 0.f;
  float best_t = kFltMax;
  int best_lane = lanes, best_tri = -1;
  int idx = active ? 0 : -1;
  // the leaf this ray stands at, waiting for the warp's leaf test
  int leaf = -1, l_ntri = 0, l_start = 0;
  for (;;) {
    while (idx >= 0 && leaf < 0) {
      const float4 r0 = __ldg(rows + 4 * static_cast<int64_t>(idx));      // min.xyz, max.x
      const float4 r1 = __ldg(rows + 4 * static_cast<int64_t>(idx) + 1);  // max.yz
      const float4 r2 = __ldg(rows + 4 * static_cast<int64_t>(idx) + 2);  // meta values
      const int a = static_cast<int>(r2.x);
      const int esc = static_cast<int>(r2.y);
      const int ntri = static_cast<int>(r2.z);
      const float clip = fminf(best_t, tmax);
      const float t0x = (r0.x - ox) * ix, t1x = (r0.w - ox) * ix;
      const float t0y = (r0.y - oy) * iy, t1y = (r1.x - oy) * iy;
      const float t0z = (r0.z - oz) * iz, t1z = (r1.y - oz) * iz;
      const float tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                               nan_min(t0z, t1z));
      const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                               nan_max(t0z, t1z));
      const bool in_box = (tf >= nan_max(tn, 0.f)) && (tn < clip);
      if (ntri > 0) {
        if (in_box) {
          leaf = a;
          l_ntri = ntri;
          l_start = static_cast<int>(r2.w);
        }
        idx = esc;
      } else {
        idx = in_box ? a : esc;
      }
    }
    unsigned pend = __ballot_sync(~0u, leaf >= 0);
    if (pend == 0) break;             // every ray of the warp is done
    const unsigned same = __match_any_sync(~0u, leaf);
    while (pend) {                    // one leaf and the rays standing at it
      const int src = __ffs(pend) - 1;
      const unsigned grp = __shfl_sync(~0u, same, src);
      pend &= ~grp;
      const int g_leaf = __shfl_sync(~0u, leaf, src);
      const int g_ntri = __shfl_sync(~0u, l_ntri, src);
      const float* W = kleaf + static_cast<int64_t>(g_leaf) * 16 * L;
      lt::Ray mine = ray;
      if (kStable) {
        lt::set_moment(mine, __ldg(W + 12 * L), __ldg(W + 13 * L),
                       __ldg(W + 14 * L));
      }
      for (int t0 = 0; t0 < g_ntri; t0 += 32) {
        const int tl = t0 + lane;
        const bool has = tl < g_ntri;
        float c[22];
#pragma unroll
        for (int k = 0; k < 22; ++k) c[k] = 0.f;
        if (has) {
          // rows 0-5 of quarters 0-2 (the edges), rows 6-9 of quarter 3
#pragma unroll
          for (int e = 0; e < 3; ++e) {
#pragma unroll
            for (int r = 0; r < 6; ++r) c[6 * e + r] = __ldg(W + r * L + e * lanes + tl);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) c[18 + k] = __ldg(W + (6 + k) * L + 3 * lanes + tl);
        }
        unsigned todo = grp;
        while (todo) {
          const int rl = __ffs(todo) - 1;
          todo &= todo - 1;
          lt::Ray r;
          r.dx = __shfl_sync(~0u, mine.dx, rl);
          r.dy = __shfl_sync(~0u, mine.dy, rl);
          r.dz = __shfl_sync(~0u, mine.dz, rl);
          r.px = __shfl_sync(~0u, mine.px, rl);
          r.py = __shfl_sync(~0u, mine.py, rl);
          r.pz = __shfl_sync(~0u, mine.pz, rl);
          r.ox = __shfl_sync(~0u, mine.ox, rl);
          r.oy = __shfl_sync(~0u, mine.oy, rl);
          r.oz = __shfl_sync(~0u, mine.oz, rl);
          const lt::Best b{__shfl_sync(~0u, best_t, rl),
                           __shfl_sync(~0u, best_lane, rl)};
          bool take = false;
          float t = 0.f;
          if (has) {
            const float nm = lt::plane(r, c[18], c[19], c[20], c[21]);
            const float s0 = lt::side(r, c[0], c[1], c[2], c[3], c[4], c[5]);
            const float s1 = lt::side(r, c[6], c[7], c[8], c[9], c[10], c[11]);
            const float s2 = lt::side(r, c[12], c[13], c[14], c[15], c[16], c[17]);
            const float ss = lt::ssum3(s0, s1, s2);
            if (lt::candidate(s0, s1, s2, nm, ss, ahead_only)) {
              t = __fdiv_rn(-nm, ss);
              take = t > tmin && t < tmax && b.improves(t, tl);
            }
          }
          if (__ballot_sync(~0u, take)) {
            unsigned long long key =
                take ? (static_cast<unsigned long long>(lt::ordered(t)) << 32) |
                           static_cast<unsigned>(tl)
                     : ~0ull;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              const unsigned long long other = __shfl_xor_sync(~0u, key, off);
              key = other < key ? other : key;
            }
            if (lane == rl) {
              best_t = lt::unordered(static_cast<unsigned>(key >> 32));
              best_lane = static_cast<int>(key & 0xffffffffu);
              best_tri = l_start + best_lane;
            }
          }
        }
      }
    }
    if (leaf >= 0) {
      leaf = -1;
      if (kAnyHit && best_t < kFltMax) idx = -1;   // retired on its hit
    }
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
  packet_trace_kernel<kAnyHit, kMasked, kStable><<<grid, kP, 0, stream>>>(
      o, d, live, base, knode, kleaf, n, lanes, tmin, tmax, out_t, out_tri);
}

}  // namespace

extern "C" {

// Trace n rays in packets of 64 rays.  o, d: [n, 3] f32 (object space);
// live: [n] u8 or NULL (NULL = every ray live, the unmasked variant);
// base: [ceil(n / 64)] i32, each packet's node table row base (octant *
// nk); knode: [8 * nk, 16] f32; kleaf: [Nl, 16, 4 * lanes] f32, lanes a
// multiple of 4; out_t: [n] f32; out_tri: [n] i32.  Enqueues on `stream`
// and returns cudaGetLastError() of the launch (cudaErrorInvalidValue
// for a lane count it does not take).
int rt_packet_trace(const float* o, const float* d, const uint8_t* live,
                    const int* base, const float* knode, const float* kleaf,
                    int64_t n, int lanes, float tmin, float tmax, int any_hit,
                    int stable, float* out_t, int* out_tri, void* stream) {
  if (n <= 0) return 0;
  if (lanes % 4 || lanes <= 0) {
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
