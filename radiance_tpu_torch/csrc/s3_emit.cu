// Kernel B of the stream3 pipeline: the emit walk, one warp per slot,
// a window of node rows per dependent load.
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
// What bounds it on an H100: the walk is a chain of dependent node
// reads.  A walk step is a handful of instructions, but the next row's
// index is known only once the row is read, and an L2 round trip is
// ~0.5 us; the longest slot's chain sets the launch time (2288 slots at
// the city's 1080p primary, a few live ones in a 64-instance sub-wave),
// not bytes (its bound counts a 64-byte row a step) or FLOPs.
//
// Design: the tables are preorder with escape threading, so a walk only
// moves forward (an interior hit goes to row my + 1, a leaf or a miss to
// its escape row, further on, or -1) and a window of consecutive rows
// resolves without another load.  Lane j of the slot's warp loads row
// cur + j (48 bytes; one coalesced request for 32 rows, lanes past the
// octant table or nodef masked), runs the slot-frustum test on it and
// forms its row's successor; the walk then follows inside the window by
// __shfl_sync of the successor, a register chain of ~30 cycles a node in
// place of a round trip, and reloads where the cursor leaves the window.
// The cursor never depends on keepmask, so the 32 sub-frustum tests
// (lane s holds sub-frustum s) run only at visited leaves the slot
// frustum hits: the row's bounds and tn are broadcast from its lane and
// __ballot_sync folds the results.  Words are kept in lane (count % 32)
// and stored 32 at a time.  The walk stops when the cursor escapes (-1)
// or where it would begin step window step_cap + 1 (the packet is then
// flagged for the exact residual).  Step windows are the reference's
// counting unit, apart from the 32-row load windows: a window of
// step_rows rows starts at clip(base + (c / step_rows) * step_rows, 0,
// nrows - step_rows) - base for the cursor c that enters it (the clamp
// is global: on the native route's concatenated tables the start can be
// negative), and the walk stays in it while the next row lies past the
// current one and before the window's end.  step_rows 8 counts as the
// compiled treelet walks (_emit3t_kernel :961-966, _emit3wst_kernel
// :1298, :1346-1351, :1420-1431, :1490) do, 1 as the node walk
// (_emit3_kernel :733).  count, capped and steps (step windows begun)
// are those of the reference, and a slot's list keeps the first pcap
// words while the count goes on past it.  (Issuing
// the next window's loads before making this window's words, and 64-row
// windows of two rows a lane, measured slower on the H100.)
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
constexpr int kWindow = 32;     // node rows a load: one a lane
constexpr unsigned kFull = 0xffffffffu;

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
emit_window_kernel(const float* __restrict__ scal,
                   const int* __restrict__ smeta,
                   const float* __restrict__ bscal,
                   const float* __restrict__ nodef, int nslot, int nrows,
                   float tmax, int step_cap, int step_rows, int pcap,
                   int* __restrict__ words, int* __restrict__ emeta) {
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slot >= nslot) return;  // whole warps only
  const int pkt = smeta[slot * 8];
  const int alive = smeta[slot * 8 + 1];
  const int64_t base = smeta[slot * 8 + 2];
  // rows of the slot's octant table that lie inside nodef
  const int64_t left = nrows - base;
  const int avail = static_cast<int>(left < nrows / 8 ? left : nrows / 8);
  const Frustum fs = load_frustum(scal + static_cast<int64_t>(slot) * 16);
  const Frustum fb = load_frustum(
      bscal + (static_cast<int64_t>(pkt) * s3::kNLanes + lane) * 16);
  int* out = words + static_cast<int64_t>(slot) * pcap;

  int cur = alive > 0 ? 0 : -1;
  int cnt = 0, steps = 0;
  int wend = 0;   // table-local end of the current step window
  bool stop = false;
  // the cursor begins a step window: count it, or stop at the cap
  const auto enter = [&]() {
    if (steps < step_cap) {
      ++steps;
      const int64_t g = base + static_cast<int64_t>(cur / step_rows)
                        * step_rows;
      const int64_t hi = nrows - step_rows;
      wend = static_cast<int>((g < 0 ? 0 : (g > hi ? hi : g)) - base)
             + step_rows;
    } else {
      stop = true;
    }
  };
  if (cur >= 0) enter();
  int pend = 0;   // word cnt - cnt % 32 + lane, until its 32 are stored
  while (!stop && cur >= 0 && cur < avail) {
    const int win = cur;
    const int nvalid = min(kWindow, avail - win);
    float bmn[3] = {0.f, 0.f, 0.f}, bmx[3] = {0.f, 0.f, 0.f};
    float tn = 0.f, tf = 0.f;
    int a = 0, esc = -1;
    bool leaf = false, hit = false;
    if (lane < nvalid) {
      const float4* row =
          reinterpret_cast<const float4*>(nodef + (base + win + lane) * 16);
      const float4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
      bmn[0] = r0.x; bmn[1] = r0.y; bmn[2] = r0.z;
      bmx[0] = r0.w; bmx[1] = r1.x; bmx[2] = r1.y;
      a = static_cast<int>(r2.x);
      esc = static_cast<int>(r2.y);
      leaf = r2.z > 0.f;
      interval(fs, bmn, bmx, tmax, tn, tf);
      hit = (tf >= tn) && (tn < tmax);
    }
    const int nxt = (leaf || !hit) ? esc : a;
    const unsigned cand = __ballot_sync(kFull, leaf && hit);
    int p = 0;      // the cursor's lane in the window
    do {
      const int nx = __shfl_sync(kFull, nxt, p);
      if ((cand >> p) & 1u) {
        float qmn[3], qmx[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          qmn[k] = __shfl_sync(kFull, bmn[k], p);
          qmx[k] = __shfl_sync(kFull, bmx[k], p);
        }
        const float tn_p = __shfl_sync(kFull, tn, p);
        const int a_p = __shfl_sync(kFull, a, p);
        float tn_b, tf_b;
        interval(fb, qmn, qmx, kFltMax, tn_b, tf_b);
        const unsigned m =
            __ballot_sync(kFull, (tf_b >= tn_b) && (tn_b < tmax));
        const int kmask =
            static_cast<int>((m | (m >> 8) | (m >> 16) | (m >> 24)) & 0xffu);
        if (kmask > 0) {
          const int tq = min(max((__float_as_int(nan_max(tn_p, 0.f))
                                  >> s3::kTqShift) - s3::kTqBias3, 0),
                             s3::kTqMask);
          if (lane == (cnt & 31)) {
            pend = ((a_p + 1) << s3::kLeafShift)
                   | (kmask << s3::kKeepShift) | tq;
          }
          if ((++cnt & 31) == 0 && cnt - 32 + lane < pcap) {
            out[cnt - 32 + lane] = pend;
          }
        }
      }
      const bool same = nx > cur && nx < wend;
      cur = nx;
      if (cur >= 0 && !same) enter();
      p = cur - win;
    } while (!stop && cur >= 0
             && static_cast<unsigned>(p) < static_cast<unsigned>(nvalid));
  }
  if (lane < (cnt & 31) && cnt - (cnt & 31) + lane < pcap) {
    out[cnt - (cnt & 31) + lane] = pend;
  }
  if (lane < 8) {
    const int v[3] = {cnt, cur >= 0 ? 1 : 0, steps};
    emeta[slot * 8 + lane] = lane < 3 ? v[lane] : 0;
  }
}

}  // namespace

extern "C" {

// scal [nslot, 16] f32, smeta [nslot, 8] i32 (pkt, alive, base row),
// bscal [npk * 32, 16] f32, nodef [nrows = 8 * nk, 16] f32 -> words
// [nslot, pcap] i32 (the first min(count, pcap) of a row defined), emeta
// [nslot, 8] i32 (count, capped, step windows, 0...); step_rows in
// [1, 8] (nrows is a multiple of 8).  Returns cudaGetLastError().
int rt_s3_emit(const float* scal, const int* smeta, const float* bscal,
               const float* nodef, int nslot, int nrows, float tmax,
               int step_cap, int step_rows, int pcap, int* words,
               int* emeta, void* stream) {
  if (nslot <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((nslot + kWarps - 1) / kWarps);
  emit_window_kernel<<<grid, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      scal, smeta, bscal, nodef, nslot, nrows, tmax, step_cap, step_rows,
      pcap, words, emeta);
  return static_cast<int>(cudaGetLastError());
}

// The node rows a dependent load brings in (one a lane); the plain walk's
// statistics count kernel B's loads with the same window.
int rt_s3_emit_window() { return kWindow; }

}  // extern "C"
