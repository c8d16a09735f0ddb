// Kernel C of the stream3 pipeline: the exact per-ray block refine, a
// chunk of 32 words per barrier.
//
// Replaces the TPU kernel radiance_tpu/ops/stream3.py::_refine3_kernel
// (:1635, launched by _stage_refine_exact :1808), both its forms.
// The emit walk's keep bits are conservative over 32-ray sub-frusta.
// This stage re-tests every (leaf, 128-ray block) pair of a slot's word
// list ray by ray with the slab test of :1683-1687 against the leaf's
// box (aabb8 [nlp, 8]: min xyz, max xyz, 0, 0), ANDs the exact result
// into the keepmask, and compacts the list: a word whose mask becomes
// empty is dropped.  The sort=False form keeps the order of the others;
// the sort=True form (:1703-1737, the reference's RADIANCE_TQSORT)
// orders them by a stable counting sort on tq in 32 buckets of
// kTqBucketShift bits, near leaves first, for kernel D's occlusion cull.
// emeta' lane 0 is the kept count, lane 4 the pre-refine count
// (min(count, pcap)), lanes 1-3 and 5-7 are copied.
//
// What bounds it on an H100: the work is ~28 instructions a (ray, word)
// -- 6 differences, 6 products, 12 NaN-propagating minima and maxima and
// the window test -- over a slot's 1024 rays; bytes are a word, its
// 32-byte box and, once per slot, 24 bytes a ray (microseconds at the
// city's 1080p wave).  One block a slot taking its words one at a time
// is a latency chain instead: a word load, a box load, a barrier and a
// serial append a word, ~1000 barriers for a full list, and a
// 64-instance sub-wave's few live slots leave most SMs idle.
//
// Design: three launches.  refine_scan_kernel (one block) numbers the
// lists' 32-word chunks in slot order.  refine_test_kernel: a fixed grid
// of 256-thread blocks, kBlocksPerSm an SM, each taking an equal
// contiguous share of the chunks, so a long list spreads over several
// SMs and a sub-wave's few live slots over all of them.  Thread t holds
// rays 4t..4t+3 of the slot's packet (origin and IEEE reciprocal
// direction, feats_t rows 6-8 and 0-2, reloaded when the share moves to
// another slot), so warp w holds 128-ray block w.  Warp 0 stages a
// chunk's words and boxes in shared memory, double-buffered: it loads
// the next chunk into registers while the block tests the current one.
// Warp w tests only the words whose keep bit w is set (the exact mask is
// ANDed into the keep mask, so the others cannot change a result): the
// box from broadcast reads against its 128 rays, 32 at a time (each
// thread's next ray), until __any_sync finds one that overlaps it, then
// sets bit j of the warp's mask.  One barrier a chunk, and warp 0's
// lane j forms word j's exact keepmask from the eight masks and writes
// the refined word, or 0 for a dropped one, to a scratch row.
// refine_compact_kernel: one warp a slot compacts the scratch row 128
// words at a time (loads first, then a ballot and a popcount a 32), and
// writes emeta'.  Its sort form reads the row twice, 32 words a step:
// the first pass counts the kept words of each tq bucket (__match_any_sync
// groups a step's equal buckets, the group's first lane adds its size to
// the warp's 32 counters in shared memory), a warp scan turns the counts
// into offsets, and the second pass places each kept word at its
// bucket's offset plus its rank among the step's earlier lanes of that
// bucket, so equal buckets keep list order (stable).  That is ~2 x 32
// steps of a few instructions for a full list, beside the test kernel's
// 1024 rays a word; a simple form, not yet tuned.  The test grid is kBlocksPerSm blocks on every SM
// unless the caller asks for another (rt_s3_refine_grid).
//
// Exactness: built with -fmad=false; (box - o) * iv and IEEE 1/d give
// the plain version's bits.  min.NaN / max.NaN propagate NaN as
// torch.minimum / maximum do (a canonical NaN, where the plain version
// keeps a payload; only comparisons read them), so the kept lists are
// identical.

#include "s3_common.cuh"

namespace {

using s3::kFltMax;

constexpr int kThreads = 256;   // 8 warps: warp w tests 128-ray block w
constexpr int kRays = 4;        // rays a thread
constexpr int kChunk = 32;      // words a chunk
constexpr int kBlocksPerSm = 4;  // resident test blocks an SM
constexpr int kCompactWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Warp 0's lane j: word j of chunk c of a slot's list (0 past cnt) and
// its box.
__device__ __forceinline__ void load_word(const int* __restrict__ in,
                                          const float* __restrict__ aabb8,
                                          int c, int cnt, int lane, int& w,
                                          float4& b0, float4& b1) {
  const int j = c * kChunk + lane;
  w = j < cnt ? in[j] : 0;
  const float4* box = reinterpret_cast<const float4*>(
      aabb8 + static_cast<int64_t>(s3::word_leaf(w)) * 8);
  b0 = __ldg(box);
  b1 = __ldg(box + 1);
}

// One block: item_slot[i] = the slot of chunk item i, the items of a
// slot consecutive and in slot order; start[s] = its first item;
// start[nslot] = the number of items.
__global__ void __launch_bounds__(1024)
refine_scan_kernel(const int* __restrict__ emeta, int nslot, int pcap,
                   int* __restrict__ start, int* __restrict__ item_slot) {
  __shared__ int s_sum[32];
  __shared__ int s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_base = 0;
  __syncthreads();
  for (int s0 = 0; s0 < nslot; s0 += 1024) {
    const int s = s0 + tid;
    const int n = s < nslot
        ? (min(emeta[static_cast<int64_t>(s) * 8], pcap) + kChunk - 1)
              / kChunk
        : 0;
    int x = n;      // inclusive scan over the warp, then over the warps
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) s_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int v = s_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += y;
      }
      s_sum[lane] = v;
    }
    __syncthreads();
    const int first = s_base + (warp ? s_sum[warp - 1] : 0) + x - n;
    if (s < nslot) {
      start[s] = first;
      for (int k = 0; k < n; ++k) item_slot[first + k] = s;
    }
    __syncthreads();
    if (tid == 0) s_base += s_sum[31];
    __syncthreads();
  }
  if (tid == 0) start[nslot] = s_base;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
refine_test_kernel(const int* __restrict__ words,
                   const int* __restrict__ emeta,
                   const int* __restrict__ slot_pkt,
                   const float* __restrict__ feats_t, int64_t npad,
                   const float* __restrict__ aabb8, int nslot, int pcap,
                   float tmax, const int* __restrict__ start,
                   const int* __restrict__ item_slot,
                   int* __restrict__ wtmp) {
  __shared__ int s_word[2][kChunk];
  __shared__ float4 s_box[2][kChunk][2];
  __shared__ unsigned s_mask[2][kThreads / 32];
  // this block's contiguous share of the chunk items
  const int total = start[nslot];
  const int per = (total + gridDim.x - 1) / gridDim.x;
  int item = blockIdx.x * per;
  const int end = min(item + per, total);
  if (item >= end) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int slot = item_slot[item];
  int c = item - start[slot];
  int cnt = min(emeta[slot * 8], pcap);
  if (warp == 0) {
    int w;
    float4 b0, b1;
    load_word(words + static_cast<int64_t>(slot) * pcap, aabb8, c, cnt,
              lane, w, b0, b1);
    s_word[0][lane] = w;
    s_box[0][lane][0] = b0;
    s_box[0][lane][1] = b1;
  }
  float o[3][kRays], iv[3][kRays];
  int ray_slot = -1;
  __syncthreads();    // the first chunk is staged

  for (int buf = 0; item < end; ++item, buf ^= 1) {
    if (slot != ray_slot) {     // this slot's packet: origins, 1 / d
      const int64_t ray0 = static_cast<int64_t>(slot_pkt[slot]) * s3::kPkt
                           + kRays * tid;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 d4 = __ldg(reinterpret_cast<const float4*>(
            feats_t + k * npad + ray0));
        const float4 o4 = __ldg(reinterpret_cast<const float4*>(
            feats_t + (6 + k) * npad + ray0));
        const float dv[kRays] = {d4.x, d4.y, d4.z, d4.w};
        const float ov[kRays] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          iv[k][r] = 1.0f / dv[r];
          o[k][r] = ov[r];
        }
      }
      ray_slot = slot;
    }
    // warp 0 fetches the next item's words and boxes while all test
    int n_slot = slot, n_c = c + 1, n_cnt = cnt, pw = 0;
    float4 pb0, pb1;
    const bool more = item + 1 < end;
    if (more && n_c * kChunk >= cnt) {
      n_slot = item_slot[item + 1];
      n_c = 0;
      n_cnt = min(emeta[n_slot * 8], pcap);
    }
    if (warp == 0 && more) {
      load_word(words + static_cast<int64_t>(n_slot) * pcap, aabb8, n_c,
                n_cnt, lane, pw, pb0, pb1);
    }
    const int n = min(kChunk, cnt - c * kChunk);
    // only this warp's block's keep bit needs its rays tested
    unsigned todo = __ballot_sync(
        kFull, lane < n
                   && ((s_word[buf][lane] >> (s3::kKeepShift + warp)) & 1));
    unsigned m = 0;
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const float4 b0 = s_box[buf][j][0], b1 = s_box[buf][j][1];
      const float bmn[3] = {b0.x, b0.y, b0.z};
      const float bmx[3] = {b0.w, b1.x, b1.y};
      // the block's 128 rays, 32 at a time, until one overlaps the box
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        float tn = 0.f, tf = kFltMax;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float t0 = (bmn[k] - o[k][r]) * iv[k][r];
          const float t1 = (bmx[k] - o[k][r]) * iv[k][r];
          tn = max_nan(tn, min_nan(t0, t1));
          tf = min_nan(tf, max_nan(t0, t1));
        }
        if (__any_sync(kFull, (tf >= max_nan(tn, 0.f)) && (tn < tmax))) {
          m |= 1u << j;
          break;
        }
      }
    }
    if (lane == 0) s_mask[buf][warp] = m;
    if (warp == 0 && more) {
      s_word[buf ^ 1][lane] = pw;
      s_box[buf ^ 1][lane][0] = pb0;
      s_box[buf ^ 1][lane][1] = pb1;
    }
    __syncthreads();    // the masks and the next chunk are staged
    if (warp == 0 && lane < n) {
      int kex = 0;
#pragma unroll
      for (int b = 0; b < kThreads / 32; ++b) {
        kex |= static_cast<int>((s_mask[buf][b] >> lane) & 1u) << b;
      }
      const int w = s_word[buf][lane];
      const int km = ((w >> s3::kKeepShift) & 255) & kex;
      wtmp[static_cast<int64_t>(slot) * pcap + c * kChunk + lane] =
          km > 0 ? (w & ~(255 << s3::kKeepShift)) | (km << s3::kKeepShift)
                 : 0;
    }
    slot = n_slot;
    c = n_c;
    cnt = n_cnt;
  }
}

template <bool kSort>
__global__ void __launch_bounds__(kCompactWarps * 32)
refine_compact_kernel(const int* __restrict__ emeta,
                      const int* __restrict__ wtmp, int nslot, int pcap,
                      int* __restrict__ words_out,
                      int* __restrict__ emeta_out) {
  __shared__ int s_off[kCompactWarps][32];   // the sort form's buckets
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * kCompactWarps + warp;
  if (slot >= nslot) return;  // whole warps only
  const int cnt = min(emeta[slot * 8], pcap);
  const int* tmp = wtmp + static_cast<int64_t>(slot) * pcap;
  int* out = words_out + static_cast<int64_t>(slot) * pcap;
  const unsigned below = (1u << lane) - 1u;
  int kept = 0;
  if (!kSort) {
    for (int b = 0; b < cnt; b += 4 * 32) {
      int w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = b + q * 32 + lane;
        w[q] = j < cnt ? tmp[j] : 0;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned keep = __ballot_sync(kFull, w[q] != 0);
        if (w[q] != 0) out[kept + __popc(keep & below)] = w[q];
        kept += __popc(keep);
      }
    }
  } else {
    int* off = s_off[warp];
    off[lane] = 0;
    __syncwarp();
    // a dropped word (0) takes key 32, no bucket
    for (int b = 0; b < cnt; b += 32) {
      const int j = b + lane;
      const int w = j < cnt ? tmp[j] : 0;
      const int key = w != 0 ? (w & s3::kTqMask) >> s3::kTqBucketShift : 32;
      const unsigned peers = __match_any_sync(kFull, key);
      if (key < 32 && lane == __ffs(peers) - 1) off[key] += __popc(peers);
      __syncwarp();
    }
    const int c = off[lane];
    int x = c;      // inclusive scan of the bucket counts
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    kept = __shfl_sync(kFull, x, 31);
    __syncwarp();
    off[lane] = x - c;
    __syncwarp();
    for (int b = 0; b < cnt; b += 32) {
      const int j = b + lane;
      const int w = j < cnt ? tmp[j] : 0;
      const int key = w != 0 ? (w & s3::kTqMask) >> s3::kTqBucketShift : 32;
      const unsigned peers = __match_any_sync(kFull, key);
      if (key < 32) out[off[key] + __popc(peers & below)] = w;
      __syncwarp();
      if (key < 32 && lane == __ffs(peers) - 1) off[key] += __popc(peers);
      __syncwarp();
    }
  }
  if (lane < 8) {
    const int e = emeta[slot * 8 + lane];
    emeta_out[slot * 8 + lane] = lane == 0 ? kept : (lane == 4 ? cnt : e);
  }
}

}  // namespace

extern "C" {

// refine_test_kernel's default grid on the current device: kBlocksPerSm
// blocks on every SM.
int rt_s3_refine_grid() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return kBlocksPerSm * sms;
}

// words [nslot, pcap] i32, emeta [nslot, 8] i32, slot_pkt [nslot] i32,
// feats_t [16, npad] f32 (16-byte aligned, npad whole packets), aabb8
// [nlp, 8] f32 (16-byte aligned) -> words_out [nslot, pcap] (the first
// emeta_out[:, 0] of a row defined; with sort, in tq-bucket order),
// emeta_out [nslot, 8].  Scratch: wtmp [nslot, pcap] i32, start
// [nslot + 1] i32, item_slot [nslot * ceil(pcap / 32)] i32.  grid:
// refine_test_kernel's blocks, or <= 0 for rt_s3_refine_grid().  Returns
// cudaGetLastError().
int rt_s3_refine(const int* words, const int* emeta, const int* slot_pkt,
                 const float* feats_t, int64_t npad, const float* aabb8,
                 int nslot, int pcap, float tmax, int grid, int sort,
                 int* wtmp, int* start, int* item_slot, int* words_out,
                 int* emeta_out, void* stream) {
  if (nslot <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid <= 0) grid = rt_s3_refine_grid();
  refine_scan_kernel<<<1, 1024, 0, st>>>(emeta, nslot, pcap, start,
                                         item_slot);
  refine_test_kernel<<<grid, kThreads, 0, st>>>(
      words, emeta, slot_pkt, feats_t, npad, aabb8, nslot, pcap, tmax,
      start, item_slot, wtmp);
  const int cgrid = (nslot + kCompactWarps - 1) / kCompactWarps;
  if (sort) {
    refine_compact_kernel<true><<<cgrid, kCompactWarps * 32, 0, st>>>(
        emeta, wtmp, nslot, pcap, words_out, emeta_out);
  } else {
    refine_compact_kernel<false><<<cgrid, kCompactWarps * 32, 0, st>>>(
        emeta, wtmp, nslot, pcap, words_out, emeta_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
