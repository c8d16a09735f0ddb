// Kernel E of the stream3 pipeline: occlusion (any-hit) pair intersection.
//
// Replaces the TPU kernel radiance_tpu/ops/stream3.py::_isect3_occl_kernel
// (:2100, launched by _stage_isect(occl=True) :2295-2299, :2316; f32,
// orient="major", the stable-frame correction on).  For every slot it
// walks the slot's UNREFINED word list (occlusion waves skip the refine);
// for each word and each set keep bit k it tests block k of the slot's
// packet (128 rays) against the word's leaf: the Pluecker side products
// s0, s1, s2 and the plane numerator of the leaf's T = 128 triangles from
// the [16, 4T] leaf matrix, the bitcast sign test, t = -num * (1 / (s0 +
// s1 + s2)) and tmin < t < tmax.  Any accepted triangle occludes the ray.
// out [nslot, 1024, 4] = (0, 0, 0, 0) on an occluded ray, (FLT_MAX, -1,
// 0, 0) otherwise -- the layout the glue stage folds (t < FLT_MAX and
// prim >= 0 there means occluded).
//
// A ray once occluded stays occluded, so any schedule of the same tests
// gives the same answer.  The reference's two culls are kept in GPU form:
// a kept block is skipped when all 128 of its rays are occluded (each warp
// votes with __all_sync after a word; the next word reads its block's 4
// votes), and the word loop ends when all 1024 rays are (__syncthreads_and).
// A thread also stops testing a leaf's triangles at its first hit.  Dead
// (parked) lanes never hit, so a slot holding one never ends early, as in
// the reference.
//
// What bounds it: FLOPs, as kernel D (s3_isect.cu): each tested (leaf,
// block) pair is 128 rays x 128 triangles x 22 FMAs against 21 KB of leaf
// rows.  Per triangle the same 22 FP32 FMAs as kernel D on the CUDA cores,
// never TF32 and never the tensor cores, with the stable frame's ray
// moment (o - c) x d computed once per leaf.  The leaf rows occlusion
// needs (rows 0-5 of the three edge quarters, rows 6-9 of the plane
// quarter, the centroid; no prim or barycentric rows) are staged in shared
// memory once per word; every lane of a warp reads the same float4 (a
// broadcast).  Saturated blocks and occluded rays drop out, so a shadow
// wave gets cheaper as it saturates; a barrier pair per word remains.

#include "s3_common.cuh"

namespace {

using s3::kFltMax;

constexpr int kThreads = s3::kPkt;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 128;               // triangles per leaf
constexpr int kL = 4 * kT;            // leaf matrix width

template <bool kStable>
__global__ void __launch_bounds__(kThreads)
isect_occl_kernel(const int* __restrict__ words,
                  const int* __restrict__ emeta,
                  const int* __restrict__ slot_pkt,
                  const float* __restrict__ feats,
                  const float* __restrict__ kleaf, int pcap, float tmin,
                  float tmax, float* __restrict__ out) {
  __shared__ float4 s_edge[6][3 * kT / 4];
  __shared__ float4 s_plane[4][kT / 4];
  __shared__ float s_c[3];
  __shared__ int s_warp_occ[kWarps];

  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int blk = tid / s3::kBlk;
  const int cnt = min(emeta[slot * 8], pcap);
  const int64_t ray = static_cast<int64_t>(slot_pkt[slot]) * s3::kPkt + tid;
  const float4* x = reinterpret_cast<const float4*>(feats + ray * 16);
  const float4 x0 = x[0], x1 = x[1], x2 = x[2];
  const float dx = x0.x, dy = x0.y, dz = x0.z;
  const float ox = x1.z, oy = x1.w, oz = x2.x;
  const float mxo = x0.w, myo = x1.x, mzo = x1.y;   // o x d (legacy frames)

  bool occ = false;
  if (tid < kWarps) s_warp_occ[tid] = 0;
  const int* wl = words + static_cast<int64_t>(slot) * pcap;

  for (int j = 0; j < cnt; ++j) {
    // the previous leaf is done; end when every ray of the slot is occluded
    if (__syncthreads_and(occ)) break;
    const int w = wl[j];
    const int kmask = (w >> s3::kKeepShift) & 255;
    const float4* W = reinterpret_cast<const float4*>(
        kleaf + static_cast<int64_t>(s3::word_leaf(w)) * 16 * kL);
    for (int i = tid; i < 6 * (3 * kT / 4); i += kThreads) {
      const int r = i / (3 * kT / 4), c = i % (3 * kT / 4);
      s_edge[r][c] = __ldg(W + r * (kL / 4) + c);
    }
    if (tid < 4 * (kT / 4)) {
      const int r = tid / (kT / 4), c = tid % (kT / 4);
      s_plane[r][c] = __ldg(W + (6 + r) * (kL / 4) + 3 * kT / 4 + c);
    } else if (tid < 4 * (kT / 4) + 3) {
      const int k = tid - 4 * (kT / 4);
      s_c[k] = __ldg(reinterpret_cast<const float*>(W) + (12 + k) * kL);
    }
    // the block's four warp votes from the previous word
    const int* v = s_warp_occ + blk * (s3::kBlk / 32);
    const bool saturated = v[0] && v[1] && v[2] && v[3];
    __syncthreads();
    if (((kmask >> blk) & 1) && !saturated && !occ) {
      float px = mxo, py = myo, pz = mzo;
      if (kStable) {
        const float lx = ox - s_c[0], ly = oy - s_c[1], lz = oz - s_c[2];
        px = ly * dz - lz * dy;
        py = lz * dx - lx * dz;
        pz = lx * dy - ly * dx;
      }
      for (int q = 0; q < kT / 4 && !occ; ++q) {
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
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int b0 = __float_as_int(s[0][u]);
          const int b1 = __float_as_int(s[1][u]);
          const int b2 = __float_as_int(s[2][u]);
          const bool inside = ((b0 ^ b1) | (b1 ^ b2)) >= 0;
          const float t = -num[u] * (1.0f / (s[0][u] + s[1][u] + s[2][u]));
          occ = occ || (inside && t > tmin && t < tmax);  // NaN t -> miss
        }
      }
    }
    const bool all_occ = __all_sync(0xffffffffu, occ);
    if ((tid & 31) == 0) s_warp_occ[warp] = all_occ;
  }
  reinterpret_cast<float4*>(out)[static_cast<int64_t>(slot) * s3::kPkt + tid] =
      occ ? make_float4(0.f, 0.f, 0.f, 0.f)
          : make_float4(kFltMax, -1.f, 0.f, 0.f);
}

}  // namespace

extern "C" {

// words [nslot, pcap] i32 (unrefined lists), emeta [nslot, 8] i32 (lane
// 0: count), slot_pkt [nslot] i32, feats [npad, 16] f32 (ray-major),
// kleaf [nl, 16, 512] f32 -> out [nslot, 1024, 4] f32.  Returns
// cudaGetLastError().
int rt_s3_isect_occl(const int* words, const int* emeta, const int* slot_pkt,
                     const float* feats, const float* kleaf, int nslot,
                     int pcap, float tmin, float tmax, int stable, float* out,
                     void* stream) {
  if (nslot <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stable) {
    isect_occl_kernel<true><<<nslot, kThreads, 0, s>>>(
        words, emeta, slot_pkt, feats, kleaf, pcap, tmin, tmax, out);
  } else {
    isect_occl_kernel<false><<<nslot, kThreads, 0, s>>>(
        words, emeta, slot_pkt, feats, kleaf, pcap, tmin, tmax, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
