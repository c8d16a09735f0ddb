// Kernel D of the stream3 pipeline: closest-hit pair intersection.
//
// Replaces the TPU kernel radiance_tpu/ops/stream3.py::_isect3_kernel
// (:1853, launched by _stage_isect :2316; closest hit, orient="major",
// f32, the stable-frame correction on).  For every slot it walks the
// slot's refined word list; for each word and each set keep bit k it
// intersects block k of the slot's packet (128 rays) with the word's
// leaf: the Pluecker side products s0, s1, s2 and the plane numerator of
// the leaf's T = 128 triangles from the [16, 4T] leaf matrix (kleaf,
// bvh/kernel_pack.py), then the sign test, t = -num * (1 / (s0+s1+s2))
// inside (tmin, tmax), the winner's prim (leaf row 10) and barycentrics
// b1 = s2 / ssum, b2 = s0 / ssum.  out [nslot, 1024, 4] = (t, prim, b1,
// b2), (FLT_MAX, -1, 0, 0) where nothing was hit -- the layout the glue
// stage folds.
//
// Design: one block per slot, one thread per ray (1024 threads).  For
// each word the block stages the used rows of the leaf matrix (rows 0-9,
// row 10's prim quarter and the centroid, 23 KB) in shared memory; the
// threads of each kept block then loop over the T triangles four at a
// time (float4 loads, every lane of a warp reading the same address: a
// broadcast).  Per triangle: 22 FP32 FMAs on the CUDA cores -- never
// TF32, never the tensor cores -- with the ray moment of the stable frame
// computed once per leaf as (o - c) x d (legacy frames read o x d from
// the features).  The tie rule is the reference's (per-(ray, lane)
// minima with strict < across words, then the lowest lane among equal
// t, :2054-2082), kept by one running best per ray that improves when
// t < best or t == best with a lower lane.  The TPU kernel's tq
// occlusion cull is not kept: at equal t it could drop a lower lane.
//
// What bounds it: FLOPs.  Each kept (leaf, block) pair is 128 rays x 128
// triangles x 22 FMAs (44 FLOPs), ~1.4 MFLOP, against 23 KB of leaf
// rows, so the FP32 rate (67 TFLOP/s) is the bound, not the bytes.  This
// version reaches only part of it: a barrier pair per word, the blocks
// whose keep bit is clear idle, and one shared-memory load per 4 FMAs.
// wgmma on the tensor cores (with error-free splits for exactness) and a
// TMA ring of leaf matrices are later work.

#include "s3_common.cuh"

namespace {

using s3::kFltMax;

constexpr int kThreads = s3::kPkt;
constexpr int kT = 128;               // triangles per leaf
constexpr int kL = 4 * kT;            // leaf matrix width

template <bool kStable>
__global__ void __launch_bounds__(kThreads)
isect_kernel(const int* __restrict__ words, const int* __restrict__ emeta,
             const int* __restrict__ slot_pkt,
             const float* __restrict__ feats, const float* __restrict__ kleaf,
             int pcap, float tmin, float tmax, float* __restrict__ out) {
  // rows 0-5 of the three edge quarters, rows 6-9 of the plane quarter,
  // row 10 of quarter 0 (prim), the centroid (rows 12-14, column 0)
  __shared__ float4 s_edge[6][3 * kT / 4];
  __shared__ float4 s_plane[4][kT / 4];
  __shared__ float4 s_prim[kT / 4];
  __shared__ float s_c[3];

  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int blk = tid / s3::kBlk;
  const int cnt = min(emeta[slot * 8], pcap);
  const int64_t ray = static_cast<int64_t>(slot_pkt[slot]) * s3::kPkt + tid;
  const float4* x = reinterpret_cast<const float4*>(feats + ray * 16);
  const float4 x0 = x[0], x1 = x[1], x2 = x[2];
  const float dx = x0.x, dy = x0.y, dz = x0.z;
  const float ox = x1.z, oy = x1.w, oz = x2.x;
  const float mxo = x0.w, myo = x1.x, mzo = x1.y;   // o x d (legacy frames)

  float best_t = kFltMax, best_prim = -1.f, best_b1 = 0.f, best_b2 = 0.f;
  int best_lane = kT;
  const int* wl = words + static_cast<int64_t>(slot) * pcap;

  for (int j = 0; j < cnt; ++j) {
    const int w = wl[j];
    const int kmask = (w >> s3::kKeepShift) & 255;
    const float4* W = reinterpret_cast<const float4*>(
        kleaf + static_cast<int64_t>(s3::word_leaf(w)) * 16 * kL);
    __syncthreads();                  // the previous leaf is done
    for (int i = tid; i < 6 * (3 * kT / 4); i += kThreads) {
      const int r = i / (3 * kT / 4), c = i % (3 * kT / 4);
      s_edge[r][c] = __ldg(W + r * (kL / 4) + c);
    }
    if (tid < 4 * (kT / 4)) {
      const int r = tid / (kT / 4), c = tid % (kT / 4);
      s_plane[r][c] = __ldg(W + (6 + r) * (kL / 4) + 3 * kT / 4 + c);
    } else if (tid < 5 * (kT / 4)) {
      const int c = tid - 4 * (kT / 4);
      s_prim[c] = __ldg(W + 10 * (kL / 4) + c);
    } else if (tid < 5 * (kT / 4) + 3) {
      const int k = tid - 5 * (kT / 4);
      s_c[k] = __ldg(reinterpret_cast<const float*>(W) + (12 + k) * kL);
    }
    __syncthreads();
    if (!((kmask >> blk) & 1)) continue;

    float px = mxo, py = myo, pz = mzo;
    if (kStable) {
      const float lx = ox - s_c[0], ly = oy - s_c[1], lz = oz - s_c[2];
      px = ly * dz - lz * dy;
      py = lz * dx - lx * dz;
      pz = lx * dy - ly * dx;
    }
    for (int q = 0; q < kT / 4; ++q) {
      float s[3][4];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int c = e * (kT / 4) + q;
        const float4 w0 = s_edge[0][c], w1 = s_edge[1][c], w2 = s_edge[2][c];
        const float4 w3 = s_edge[3][c], w4 = s_edge[4][c], w5 = s_edge[5][c];
        s[e][0] = dx * w0.x + dy * w1.x + dz * w2.x + px * w3.x + py * w4.x + pz * w5.x;
        s[e][1] = dx * w0.y + dy * w1.y + dz * w2.y + px * w3.y + py * w4.y + pz * w5.y;
        s[e][2] = dx * w0.z + dy * w1.z + dz * w2.z + px * w3.z + py * w4.z + pz * w5.z;
        s[e][3] = dx * w0.w + dy * w1.w + dz * w2.w + px * w3.w + py * w4.w + pz * w5.w;
      }
      const float4 n0 = s_plane[0][q], n1 = s_plane[1][q];
      const float4 n2 = s_plane[2][q], n3 = s_plane[3][q];
      const float num[4] = {ox * n0.x + oy * n1.x + oz * n2.x + n3.x,
                            ox * n0.y + oy * n1.y + oz * n2.y + n3.y,
                            ox * n0.z + oy * n1.z + oz * n2.z + n3.z,
                            ox * n0.w + oy * n1.w + oz * n2.w + n3.w};
      const float4 pr = s_prim[q];
      const float prim[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b0 = __float_as_int(s[0][u]);
        const int b1 = __float_as_int(s[1][u]);
        const int b2 = __float_as_int(s[2][u]);
        const bool inside = ((b0 ^ b1) | (b1 ^ b2)) >= 0;
        const float rv = 1.0f / (s[0][u] + s[1][u] + s[2][u]);
        const float t = -num[u] * rv;   // ssum == 0 -> inf / NaN -> miss
        const int lane = 4 * q + u;
        if (inside && t > tmin && t < tmax &&
            (t < best_t || (t == best_t && lane < best_lane))) {
          best_t = t;
          best_lane = lane;
          best_prim = prim[u];
          best_b1 = s[2][u] * rv;
          best_b2 = s[0][u] * rv;
        }
      }
    }
  }
  reinterpret_cast<float4*>(out)[static_cast<int64_t>(slot) * s3::kPkt + tid] =
      make_float4(best_t, best_prim, best_b1, best_b2);
}

}  // namespace

extern "C" {

// words [nslot, pcap] i32 (refined lists), emeta [nslot, 8] i32 (lane 0:
// count), slot_pkt [nslot] i32, feats [npad, 16] f32 (ray-major), kleaf
// [nl, 16, 512] f32 -> out [nslot, 1024, 4] f32.  Returns
// cudaGetLastError().
int rt_s3_isect(const int* words, const int* emeta, const int* slot_pkt,
                const float* feats, const float* kleaf, int nslot, int pcap,
                float tmin, float tmax, int stable, float* out,
                void* stream) {
  if (nslot <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stable) {
    isect_kernel<true><<<nslot, kThreads, 0, s>>>(
        words, emeta, slot_pkt, feats, kleaf, pcap, tmin, tmax, out);
  } else {
    isect_kernel<false><<<nslot, kThreads, 0, s>>>(
        words, emeta, slot_pkt, feats, kleaf, pcap, tmin, tmax, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
