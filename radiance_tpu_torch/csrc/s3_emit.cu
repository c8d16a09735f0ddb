// Kernel B of the stream3 pipeline: the emit walk, one warp per slot.
//
// Replaces the four TPU emit kernels of radiance_tpu/ops/stream3.py,
// which all produce the same word lists by different TPU schedules:
// _emit3_kernel (:595, the lockstep walk whose slot-order output is the
// contract), _emit3t_kernel (:753, aligned 8-row treelet windows),
// _emit3ws_kernel (:1031) and _emit3wst_kernel (:1257) (work stealing,
// rows in retire order); launched by _stage_emit (:993) and
// _stage_emit_ws (:1528).
//
// Each slot (a packet, or one direction octant of a mixed packet) walks
// the escape-threaded node table of its octant (knode_f, rows base..)
// with the slot's interval frustum (scal), and at every leaf it
// overlaps, appends one i32 word: (leaf + 1) << 17 | keepmask << 9 | tq.
// Bit j of keepmask says whether any of block j's four 32-ray
// sub-frusta (bscal rows pkt * 32 + s * 8 + j) overlaps the leaf box.
//
// Design: the 32 lanes of a warp are the slot's 32 sub-frusta.  Each
// step every lane reads the same 16-word node row (one broadcast
// transaction), evaluates the slot's interval test (redundantly, so no
// shuffle is needed) and its own sub-frustum's; __ballot_sync folds the
// 32 sub-frustum results and an OR over the four sub-frusta of a block
// gives keepmask.  Lane 0 appends.  The walk stops when the cursor
// escapes (-1) or after step_cap steps (the packet is then flagged for
// the exact residual).  A slot's list may hold pcap words; the count
// keeps counting past it, which flags the packet too.
//
// What bounds it on an H100: the walk is a dependent chain, one 64-byte
// node row per step (the bound counted is steps * 64 B / 3.35 TB/s, and
// the rows mostly come from L2).  Latency of that chain and the walk
// lengths of the longest slots bound it, not bytes or FLOPs; 2288 warps
// at the city's 1080p primary wave keep each SM busy with ~17 walks.
//
// Exactness: the arithmetic is products, differences and comparisons;
// built with -fmad=false so no product is contracted into an FMA, the
// word lists are bit-identical to the plain version's.  Node words 8-11
// are f32 VALUES (a, esc, ntri, tri_start) read by value conversion.
// min/max propagate NaN as torch.minimum/maximum do.

#include "s3_common.cuh"

namespace {

using s3::kFltMax;
using s3::nan_max;
using s3::nan_min;

constexpr int kWarps = 4;

struct Frustum {
  float sgn[3], olo[3], ohi[3], ilo[3], ihi[3];
};

__device__ __forceinline__ Frustum load_frustum(const float* __restrict__ s) {
  Frustum f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.sgn[k] = s[k];
    f.olo[k] = s[3 + k];
    f.ohi[k] = s[6 + k];
    f.ilo[k] = s[9 + k];
    f.ihi[k] = s[12 + k];
  }
  return f;
}

// Interval-frustum test of a node box (stream3.py :653-689): tn, tf.
__device__ __forceinline__ void interval(const Frustum& f, const float* bmn,
                                         const float* bmx, float tf0,
                                         float& tn, float& tf) {
  tn = 0.f;
  tf = tf0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float m0 = f.sgn[k] * bmn[k];
    const float m1 = f.sgn[k] * bmx[k];
    const float lo = nan_min(m0, m1) - f.ohi[k];
    const float hi = nan_max(m0, m1) - f.olo[k];
    const float tnk = lo * (lo >= 0.f ? f.ilo[k] : f.ihi[k]);
    const float tfk = hi * (hi >= 0.f ? f.ihi[k] : f.ilo[k]);
    const bool mixed = f.sgn[k] == 0.f;
    tn = nan_max(tn, mixed ? 0.f : tnk);
    tf = nan_min(tf, mixed ? kFltMax : tfk);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
emit_kernel(const float* __restrict__ scal, const int* __restrict__ smeta,
            const float* __restrict__ bscal, const float* __restrict__ nodef,
            int nslot, float tmax, int step_cap, int pcap,
            int* __restrict__ words, int* __restrict__ emeta) {
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slot >= nslot) return;  // whole warps only
  const int pkt = smeta[slot * 8];
  const int alive = smeta[slot * 8 + 1];
  const int64_t base = smeta[slot * 8 + 2];
  const Frustum fs = load_frustum(scal + static_cast<int64_t>(slot) * 16);
  const Frustum fb = load_frustum(
      bscal + (static_cast<int64_t>(pkt) * s3::kNLanes + lane) * 16);
  int* out = words + static_cast<int64_t>(slot) * pcap;

  int idx = alive > 0 ? 0 : -1;
  int cnt = 0, steps = 0;
  while (idx >= 0 && steps < step_cap) {
    const float4* row =
        reinterpret_cast<const float4*>(nodef + (base + idx) * 16);
    const float4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
    const float bmn[3] = {r0.x, r0.y, r0.z};
    const float bmx[3] = {r0.w, r1.x, r1.y};
    const int a = static_cast<int>(r2.x);
    const int esc = static_cast<int>(r2.y);
    const bool is_leaf = r2.z > 0.f;

    float tn, tf, tn_b, tf_b;
    interval(fs, bmn, bmx, tmax, tn, tf);
    const bool box_hit = (tf >= tn) && (tn < tmax);
    interval(fb, bmn, bmx, kFltMax, tn_b, tf_b);
    const unsigned m =
        __ballot_sync(0xffffffffu, (tf_b >= tn_b) && (tn_b < tmax));
    const int kmask = static_cast<int>((m | (m >> 8) | (m >> 16) | (m >> 24))
                                       & 0xffu);
    if (is_leaf && box_hit && kmask > 0) {
      if (lane == 0 && cnt < pcap) {
        const int tq = min(max((__float_as_int(nan_max(tn, 0.f))
                                >> s3::kTqShift) - s3::kTqBias3, 0),
                           s3::kTqMask);
        out[cnt] = ((a + 1) << s3::kLeafShift) | (kmask << s3::kKeepShift)
                   | tq;
      }
      ++cnt;
    }
    idx = (is_leaf || !box_hit) ? esc : a;
    ++steps;
  }
  if (lane < 8) {
    const int v[3] = {cnt, idx >= 0 ? 1 : 0, steps};
    emeta[slot * 8 + lane] = lane < 3 ? v[lane] : 0;
  }
}

}  // namespace

extern "C" {

// scal [nslot, 16] f32, smeta [nslot, 8] i32 (pkt, alive, base row),
// bscal [npk * 32, 16] f32, nodef [8 * nk, 16] f32 -> words [nslot, pcap]
// i32 (the first min(count, pcap) of a row defined), emeta [nslot, 8] i32
// (count, capped, steps, 0...).  Returns cudaGetLastError().
int rt_s3_emit(const float* scal, const int* smeta, const float* bscal,
               const float* nodef, int nslot, float tmax, int step_cap,
               int pcap, int* words, int* emeta, void* stream) {
  if (nslot <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((nslot + kWarps - 1) / kWarps);
  emit_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      scal, smeta, bscal, nodef, nslot, tmax, step_cap, pcap, words, emeta);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
