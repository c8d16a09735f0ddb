// Kernel F of the stream3 pipeline: the prep's octant scalars.
//
// Replaces the TPU kernel radiance_tpu/ops/stream3.py::_oscal_kernel
// (:294, launched by _octant_scalars_kernel :367-399).  For every
// 1024-ray packet it reduces the six object-space component rows (and
// the live mask) to the interval-frustum scalars of each direction octant
// and of the whole packet: per axis sgn (the sign of d over the member
// rays, 0 when mixed), olo/ohi (the extrema of o, negated and swapped on
// a negative axis), ilo/ihi (the extrema of 1 / max(|d|, 1e-30), capped at
// 1e30), and each octant's presence.  Outputs: cand [npk, 8, 16] (lane 15
// zero), present [npk, 8] (bool bytes), full [npk, 16] (lane 15 zero) --
// _octant_scalars' return layout in ops/stream3_stages.py.
//
// The fills are the plain version's: rays outside an octant (or dead)
// read +-1e30 for the d and o extrema and for ilo, 0 for ihi, so an empty
// octant comes out exactly as the plain version's.  min/max propagate NaN
// (s3::nan_min / nan_max, as torch.amin / amax do), 1/|d| is an IEEE
// division, and the library is built with -fmad=false: the result equals
// the plain version's value for value (a min or max over +0 and -0 may
// return either zero in either version).
//
// What bounds it: bytes.  Seven [npad] rows are read once (28 B a ray)
// and 1.1 KB is written per packet: 2M rays move ~60 MB, ~18 us at
// 3.35 TB/s.  Design: one block of 1024 threads per packet, one thread per
// ray.  Each thread loads its ray once; the 162 (group, axis, statistic)
// extrema are reduced with warp shuffles, then across the 32 warps through
// shared memory; the octants' presence is one OR-reduction of a bit per
// ray.  The shuffle reductions (162 x 5 per warp) cost more instructions
// than the bytes take time; a segmented reduction by octant is later work.

#include "s3_common.cuh"

namespace {

constexpr int kThreads = s3::kPkt;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 9;              // 8 octants, then the whole packet
constexpr int kStats = 6;               // dmin dmax omin omax ilo ihi
constexpr int kVals = kGroups * 3 * kStats;
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    v = s3::nan_min(v, __shfl_xor_sync(kFull, v, s));
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    v = s3::nan_max(v, __shfl_xor_sync(kFull, v, s));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
oscal_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
             const float* __restrict__ oz, const float* __restrict__ dx,
             const float* __restrict__ dy, const float* __restrict__ dz,
             const unsigned char* __restrict__ live,
             float* __restrict__ cand, unsigned char* __restrict__ present,
             float* __restrict__ full) {
  __shared__ float s_part[kWarps][kVals];
  __shared__ float s_val[kVals];
  __shared__ unsigned s_present;

  const int pk = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t r = static_cast<int64_t>(pk) * s3::kPkt + tid;
  const float o[3] = {ox[r], oy[r], oz[r]};
  const float d[3] = {dx[r], dy[r], dz[r]};
  const bool lv = live == nullptr || live[r] != 0;
  const int oct = (d[0] < 0.f) + 2 * (d[1] < 0.f) + 4 * (d[2] < 0.f);
  float iv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    iv[k] = s3::nan_min(1.0f / s3::nan_max(fabsf(d[k]), 1e-30f), kBig);
  }
  if (tid == 0) s_present = 0u;

#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const bool m = g < 8 ? (lv && oct == g) : lv;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int base = (g * 3 + k) * kStats;
      const float dmin = warp_min(m ? d[k] : kBig);
      const float dmax = warp_max(m ? d[k] : -kBig);
      const float omin = warp_min(m ? o[k] : kBig);
      const float omax = warp_max(m ? o[k] : -kBig);
      const float ilo = warp_min(m ? iv[k] : kBig);
      const float ihi = warp_max(m ? iv[k] : 0.f);
      if (lane == 0) {
        s_part[warp][base + 0] = dmin;
        s_part[warp][base + 1] = dmax;
        s_part[warp][base + 2] = omin;
        s_part[warp][base + 3] = omax;
        s_part[warp][base + 4] = ilo;
        s_part[warp][base + 5] = ihi;
      }
    }
  }
  const unsigned bits = __reduce_or_sync(kFull, lv ? 1u << oct : 0u);
  __syncthreads();                      // s_present is initialised
  if (lane == 0) atomicOr(&s_present, bits);
  if (tid < kVals) {
    const bool is_max = (tid % kStats) & 1;
    float v = s_part[0][tid];
    for (int w = 1; w < kWarps; ++w) {
      v = is_max ? s3::nan_max(v, s_part[w][tid])
                 : s3::nan_min(v, s_part[w][tid]);
    }
    s_val[tid] = v;
  }
  __syncthreads();

  if (tid < kGroups * 16) {
    const int g = tid / 16, c = tid % 16;
    float v = 0.f;
    if (c < 15) {
      const float* a = s_val + (g * 3 + c % 3) * kStats;
      const float dmin = a[0], dmax = a[1], omin = a[2], omax = a[3];
      const bool neg = dmax < 0.f;
      switch (c / 3) {
        case 0: v = dmin > 0.f ? 1.f : (neg ? -1.f : 0.f); break;
        case 1: v = neg ? -omax : omin; break;
        case 2: v = neg ? -omin : omax; break;
        case 3: v = a[4]; break;
        default: v = a[5]; break;
      }
    }
    if (g < 8) {
      cand[(static_cast<int64_t>(pk) * 8 + g) * 16 + c] = v;
    } else {
      full[static_cast<int64_t>(pk) * 16 + c] = v;
    }
  } else if (tid < kGroups * 16 + 8) {
    const int g = tid - kGroups * 16;
    present[static_cast<int64_t>(pk) * 8 + g] = (s_present >> g) & 1u;
  }
}

}  // namespace

extern "C" {

// Six [npk * 1024] f32 rows (ox, oy, oz, dx, dy, dz), live [npk * 1024]
// bool bytes or null -> cand [npk, 8, 16] f32, present [npk, 8] bool
// bytes, full [npk, 16] f32.  Returns cudaGetLastError().
int rt_s3_oscal(const float* ox, const float* oy, const float* oz,
                const float* dx, const float* dy, const float* dz,
                const unsigned char* live, int npk, float* cand,
                unsigned char* present, float* full, void* stream) {
  if (npk <= 0) return 0;
  oscal_kernel<<<npk, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, live, cand, present, full);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
