// Kernel F of the stream3 pipeline: the prep's octant scalars and its
// 32-ray sub-frustum rows, in one pass over the packet's rays.
//
// Replaces the TPU kernel radiance_tpu/ops/stream3.py::_oscal_kernel
// (:294, launched by _octant_scalars_kernel :367-399) and, from the same
// registers, the reference prep's 32-ray _group_scalars (:509-515).  For
// every 1024-ray packet it reduces the six object-space component rows
// (and the live mask) to the interval-frustum scalars of each direction
// octant, of the whole packet and of each 32-ray sub-frustum: per axis
// sgn (the sign of d over the member rays, 0 when mixed), olo/ohi (the
// extrema of o, negated and swapped on a negative axis), ilo/ihi (the
// extrema of 1 / max(|d|, 1e-30), capped at 1e30), and each octant's
// presence.  Outputs: cand [npk, 8, 16] (lane 15 zero), present [npk, 8]
// (bool bytes), full [npk, 16] (lane 15 zero) and bscal [npk * 32, 16]
// (lane 15 zero; sub s of 128-ray block j at row s * 8 + j of its
// packet) -- octant_scalars' return layout in ops/stream3_stages.py.
//
// The fills are the plain version's: rays outside a group (or dead) read
// +-1e30 for the d and o extrema and for ilo, 0 for ihi, so an empty
// group comes out exactly as the plain version's.  min/max propagate NaN
// (as torch.amin / amax do), 1/|d| is an IEEE division, and the library
// is built with -fmad=false: the result equals the plain version's value
// for value (a min or max over +0 and -0 may return either zero in
// either version).
//
// What bounds it on an H100: bytes.  Seven [npad] rows are read once (28
// B a ray) and 2.6 KB is written a packet; the 1080p wave's 2032
// packets move ~64 MB, ~19 us at 3.35 TB/s.  Reducing all 9 groups x 18
// statistics in every warp by 5-step shuffle chains (~810 shuffles a
// warp) would cost more instructions than the bytes take time, and a
// multi64 launch of ~100 packets (under one wave of blocks) would pay
// that chain as latency.
//
// Design: one 1024-thread block a packet, one thread a ray, so warp w
// holds sub-frustum w.  Each float is mapped to an order-preserving
// 32-bit key and reduced by one redux.sync (__reduce_min_sync /
// __reduce_max_sync); a NaN member is found by an OR of NaN bits, and
// makes its statistic NaN.  A warp reduces only the octants its live
// rays occupy (the set bits of one OR of 1 << octant), then the whole
// packet's group -- the same reduction when its live rays share one
// octant, the coherent case, so it runs once there.  The warp's
// whole-group result, with the fill when a lane is dead, is its
// sub-frustum row, written straight from the lanes.  Lane s of a warp
// holds statistic s and folds it into the block's accumulators by a
// shared-memory atomicMin / atomicMax on the key, one lane a statistic,
// with the group's member count and NaN bits; one barrier, then the 9 x
// 16 scalars are formed, the fill joining a group that not all 1024
// rays are members of.

#include "s3_common.cuh"

namespace {

constexpr int kThreads = s3::kPkt;
constexpr int kWarps = kThreads / 32;   // = s3::kNLanes sub-frusta
constexpr int kGroups = 9;              // 8 octants, then the whole packet
constexpr int kStats = 6;               // dmin dmax omin omax ilo ihi
constexpr int kKeys = 3 * kStats;       // a group's keys: axis * 6 + stat
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kMinId = 0xffffffffu;  // identity of a min of keys
constexpr unsigned kMaxId = 0u;           // identity of a max of keys

static_assert(kWarps == s3::kNLanes, "a warp is a 32-ray sub-frustum");

// float -> unsigned key whose order is the floats' (NaN aside), and back
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the value statistic st reads for a ray outside the group
__device__ __forceinline__ float fill_of(int st) {
  return st == 5 ? 0.f : ((st & 1) ? -kBig : kBig);
}

// One axis' six statistics from their keys.  The fill joins unless every
// ray of the span was a member; nan bit 0 makes the d and 1/|d| extrema
// NaN, bit 1 the o extrema.
__device__ __forceinline__ void finish(const unsigned* key, unsigned nan,
                                       bool all_in, float* v) {
#pragma unroll
  for (int st = 0; st < kStats; ++st) {
    unsigned k = key[st];
    if (!all_in) {
      const unsigned f = key_of(fill_of(st));
      k = (st & 1) ? max(k, f) : min(k, f);
    }
    const bool is_nan = (st == 2 || st == 3) ? (nan & 2u) : (nan & 1u);
    v[st] = is_nan ? __uint_as_float(0x7fffffffu) : float_of(k);
  }
}

// axis a's two NaN bits out of the six (d: bit a, o: bit 3 + a)
__device__ __forceinline__ unsigned axis_nan(unsigned bits, int a) {
  return ((bits >> a) & 1u) | (((bits >> (3 + a)) & 1u) << 1);
}

// Lane c (< 15) of a scalar row from its axis' six statistics: sgn, olo,
// ohi, ilo, ihi, each family three lanes (x, y, z).
__device__ __forceinline__ float row_lane(int c, const float* a) {
  const float dmin = a[0], dmax = a[1], omin = a[2], omax = a[3];
  const bool neg = dmax < 0.f;
  switch (c / 3) {
    case 0: return dmin > 0.f ? 1.f : (neg ? -1.f : 0.f);
    case 1: return neg ? -omax : omin;
    case 2: return neg ? -omin : omax;
    case 3: return a[4];
    default: return a[5];
  }
}

// One warp's reduction of a group's member rays m: lane s < kKeys holds
// key s, every lane c the six keys of axis c % 3.
struct Part {
  unsigned mine;
  unsigned ax[kStats];
  unsigned nan;          // the members' NaN bits (d: bit k, o: bit 3 + k)
  unsigned bal;          // the member lanes
};

__device__ __forceinline__ Part reduce_group(bool m, const unsigned* kv,
                                             unsigned nanbits, int lane) {
  Part p;
  p.bal = __ballot_sync(kFull, m);
  p.nan = __reduce_or_sync(kFull, m ? nanbits : 0u);
  p.mine = 0u;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int st = 0; st < kStats; ++st) {
      const unsigned x = kv[k * 3 + st / 2];
      const unsigned r = (st & 1) ? __reduce_max_sync(kFull, m ? x : kMaxId)
                                  : __reduce_min_sync(kFull, m ? x : kMinId);
      if (lane == k * kStats + st) p.mine = r;
      if (k == 0) p.ax[st] = r;
      else if (lane % 3 == k) p.ax[st] = r;
    }
  }
  return p;
}

// Fold a warp's part into group g's block accumulators.
__device__ __forceinline__ void commit(const Part& p, int g, int lane,
                                       unsigned (*s_key)[kKeys],
                                       unsigned* s_nan, unsigned* s_cnt) {
  if (p.bal == 0u) return;
  if (lane < kKeys) {
    if (lane & 1) {
      atomicMax(&s_key[g][lane], p.mine);
    } else {
      atomicMin(&s_key[g][lane], p.mine);
    }
  } else if (lane == kKeys) {
    if (p.nan) atomicOr(&s_nan[g], p.nan);
  } else if (lane == kKeys + 1) {
    atomicAdd(&s_cnt[g], static_cast<unsigned>(__popc(p.bal)));
  }
}

__global__ void __launch_bounds__(kThreads, 2)
oscal_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
             const float* __restrict__ oz, const float* __restrict__ dx,
             const float* __restrict__ dy, const float* __restrict__ dz,
             const unsigned char* __restrict__ live,
             float* __restrict__ cand, unsigned char* __restrict__ present,
             float* __restrict__ full, float* __restrict__ bscal) {
  __shared__ unsigned s_key[kGroups][kKeys];
  __shared__ unsigned s_nan[kGroups], s_cnt[kGroups];

  const int pk = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t r = static_cast<int64_t>(pk) * s3::kPkt + tid;
  const float o[3] = {ox[r], oy[r], oz[r]};
  const float d[3] = {dx[r], dy[r], dz[r]};
  const bool lv = live == nullptr || live[r] != 0;
  if (tid < kGroups * kKeys) {          // kKeys is even: parity is stat's
    s_key[tid / kKeys][tid % kKeys] = (tid & 1) ? kMaxId : kMinId;
  } else if (tid < kGroups * kKeys + kGroups) {
    s_nan[tid - kGroups * kKeys] = 0u;
    s_cnt[tid - kGroups * kKeys] = 0u;
  }
  const int oct = (d[0] < 0.f) + 2 * (d[1] < 0.f) + 4 * (d[2] < 0.f);
  unsigned kv[9];                       // axis k: keys of d, o, 1/|d|
  unsigned nanbits = 0u;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float iv = s3::nan_min(1.0f / s3::nan_max(fabsf(d[k]), 1e-30f),
                                 kBig);
    kv[k * 3 + 0] = key_of(d[k]);
    kv[k * 3 + 1] = key_of(o[k]);
    kv[k * 3 + 2] = key_of(iv);
    nanbits |= (d[k] != d[k] ? 1u << k : 0u)
        | (o[k] != o[k] ? 8u << k : 0u);
  }
  __syncthreads();                      // the accumulators are set

  const unsigned octs = __reduce_or_sync(kFull, lv ? 1u << oct : 0u);
  Part whole;
  if (__popc(octs) == 1) {
    // the live rays share one octant: its group is the whole packet's
    whole = reduce_group(lv, kv, nanbits, lane);
    commit(whole, __ffs(octs) - 1, lane, s_key, s_nan, s_cnt);
  } else {
    for (unsigned todo = octs; todo; todo &= todo - 1u) {
      const int g = __ffs(todo) - 1;
      commit(reduce_group(lv && oct == g, kv, nanbits, lane), g, lane,
             s_key, s_nan, s_cnt);
    }
    whole = reduce_group(lv, kv, nanbits, lane);
  }
  commit(whole, 8, lane, s_key, s_nan, s_cnt);

  // warp w = 4 j + s is sub-frustum s of block j: row s * 8 + j
  if (lane < 16) {
    float v = 0.f;
    if (lane < 15) {
      float st[kStats];
      finish(whole.ax, axis_nan(whole.nan, lane % 3), whole.bal == kFull,
             st);
      v = row_lane(lane, st);
    }
    bscal[(static_cast<int64_t>(pk) * s3::kNLanes + (warp % 4) * 8
           + warp / 4) * 16 + lane] = v;
  }
  __syncthreads();

  if (tid < kGroups * 16) {
    const int g = tid / 16, c = tid % 16;
    float v = 0.f;
    if (c < 15) {
      float st[kStats];
      finish(&s_key[g][(c % 3) * kStats], axis_nan(s_nan[g], c % 3),
             s_cnt[g] == static_cast<unsigned>(kThreads), st);
      v = row_lane(c, st);
    }
    if (g < 8) {
      cand[(static_cast<int64_t>(pk) * 8 + g) * 16 + c] = v;
    } else {
      full[static_cast<int64_t>(pk) * 16 + c] = v;
    }
  } else if (tid < kGroups * 16 + 8) {
    const int g = tid - kGroups * 16;
    present[static_cast<int64_t>(pk) * 8 + g] = s_cnt[g] != 0u;
  }
}

}  // namespace

extern "C" {

// Six [npk * 1024] f32 rows (ox, oy, oz, dx, dy, dz), live [npk * 1024]
// bool bytes or null -> cand [npk, 8, 16] f32, present [npk, 8] bool
// bytes, full [npk, 16] f32, bscal [npk * 32, 16] f32.  Returns
// cudaGetLastError().
int rt_s3_oscal(const float* ox, const float* oy, const float* oz,
                const float* dx, const float* dy, const float* dz,
                const unsigned char* live, int npk, float* cand,
                unsigned char* present, float* full, float* bscal,
                void* stream) {
  if (npk <= 0) return 0;
  oscal_kernel<<<npk, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, live, cand, present, full, bscal);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
