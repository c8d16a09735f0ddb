// Kernel C of the stream3 pipeline: the exact per-ray block refine.
//
// Replaces the TPU kernel radiance_tpu/ops/stream3.py::_refine3_kernel
// (:1635, launched by _stage_refine_exact :1808; the sort=False form).
// The emit walk's keep bits are conservative over 32-ray sub-frusta.
// This stage re-tests every (leaf, 128-ray block) pair of a slot's word
// list ray by ray with the slab test of :1683-1687 against the leaf's
// box (aabb8 [nlp, 8]: min xyz, max xyz, 0, 0), ANDs the exact result
// into the keepmask, and compacts the list: a word whose mask becomes
// empty is dropped, the order of the others is kept.  emeta' lane 0 is
// the kept count, lane 4 the pre-refine count (min(count, pcap)), lanes
// 1-3 and 5-7 are copied.
//
// Design: one block per slot, one thread per ray of the slot's packet
// (1024 threads; block b of the packet is warps 4b..4b+3).  Each thread
// holds its ray's origin and IEEE reciprocal direction (feats_t rows 6-8
// and 0-2).  Words are taken in list order: every thread tests the leaf
// box, each warp ballots, lane 0 posts the warp's "any" to shared memory
// (double-buffered by word parity, so one barrier per word suffices),
// and thread 0 ORs the four warps of each block into the exact mask and
// appends the word.
//
// What bounds it: for each word the slot's 1024 rays run 6 subtractions,
// 6 products and ~12 comparisons; the bytes are one word, one 32-byte box
// and, once per slot, 24 bytes a ray.  Both bounds are microseconds at
// the city's 1080p wave.  The kernel is bound by the per-word barrier
// and the serial append on thread 0 (latency, not throughput); batching
// several words between barriers is later work.
//
// Exactness: built with -fmad=false; (box - o) * iv, NaN-propagating
// min/max and IEEE 1/d give the plain version's bits, so the kept lists
// are identical.

#include "s3_common.cuh"

namespace {

using s3::kFltMax;
using s3::nan_max;
using s3::nan_min;

constexpr int kThreads = s3::kPkt;

__global__ void __launch_bounds__(kThreads)
refine_kernel(const int* __restrict__ words, const int* __restrict__ emeta,
              const int* __restrict__ slot_pkt,
              const float* __restrict__ feats_t, int64_t npad,
              const float* __restrict__ aabb8, int pcap, float tmax,
              int* __restrict__ words_out, int* __restrict__ emeta_out) {
  __shared__ unsigned s_any[2][kThreads / 32];
  const int slot = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cnt = min(emeta[slot * 8], pcap);
  const int64_t ray = static_cast<int64_t>(slot_pkt[slot]) * s3::kPkt + tid;
  const float iv[3] = {1.0f / feats_t[ray], 1.0f / feats_t[npad + ray],
                       1.0f / feats_t[2 * npad + ray]};
  const float o[3] = {feats_t[6 * npad + ray], feats_t[7 * npad + ray],
                      feats_t[8 * npad + ray]};
  const int* in = words + static_cast<int64_t>(slot) * pcap;
  int* out = words_out + static_cast<int64_t>(slot) * pcap;
  int kept = 0;  // meaningful on thread 0

  for (int j = 0; j < cnt; ++j) {
    const int w = in[j];
    const float* box = aabb8 + static_cast<int64_t>(s3::word_leaf(w)) * 8;
    float tn = 0.f, tf = kFltMax;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float t0 = (__ldg(box + k) - o[k]) * iv[k];
      const float t1 = (__ldg(box + 3 + k) - o[k]) * iv[k];
      tn = nan_max(tn, nan_min(t0, t1));
      tf = nan_min(tf, nan_max(t0, t1));
    }
    const bool ok = (tf >= nan_max(tn, 0.f)) && (tn < tmax);
    const unsigned any = __ballot_sync(0xffffffffu, ok) != 0u;
    if (lane == 0) s_any[j & 1][warp] = any;
    __syncthreads();
    if (tid == 0) {
      int kex = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const unsigned* q = s_any[j & 1] + 4 * b;
        if (q[0] | q[1] | q[2] | q[3]) kex |= 1 << b;
      }
      const int km = ((w >> s3::kKeepShift) & 255) & kex;
      if (km > 0) {
        out[kept++] = (w & ~(255 << s3::kKeepShift)) | (km << s3::kKeepShift);
      }
    }
  }
  if (tid < 8) {
    const int e = emeta[slot * 8 + tid];
    emeta_out[slot * 8 + tid] = tid == 0 ? kept : (tid == 4 ? cnt : e);
  }
}

}  // namespace

extern "C" {

// words [nslot, pcap] i32, emeta [nslot, 8] i32, slot_pkt [nslot] i32,
// feats_t [16, npad] f32, aabb8 [nlp, 8] f32 -> words_out [nslot, pcap]
// (the first emeta_out[:, 0] of a row defined), emeta_out [nslot, 8].
// Returns cudaGetLastError().
int rt_s3_refine(const int* words, const int* emeta, const int* slot_pkt,
                 const float* feats_t, int64_t npad, const float* aabb8,
                 int nslot, int pcap, float tmax, int* words_out,
                 int* emeta_out, void* stream) {
  if (nslot <= 0) return 0;
  refine_kernel<<<nslot, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      words, emeta, slot_pkt, feats_t, npad, aabb8, pcap, tmax, words_out,
      emeta_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
