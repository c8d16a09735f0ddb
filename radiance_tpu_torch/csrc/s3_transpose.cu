// Kernel A of the stream3 pipeline: the wave's two layout changes, one
// kernel for each shape, for Hopper.
//
// Replaces two TPU kernels of radiance_tpu/ops/stream3.py, both plain
// layout changes:
//  * _aos2rows_kernel (:1595, launched by rows_from_aos_fast :1619):
//    [n, 3] origins and directions -> the six [n] component rows of one
//    [6, n] buffer, both inputs in one launch (aos_rows_kernel);
//  * _transpose_kernel (:1575, launched by feats_rows_to_major :1584):
//    the phase-2 features [16, npad] -> ray-major [npad, 16]
//    (rows16_kernel).
//
// What bounds them: bytes.  Each element is read once and written once,
// 2 * 4 * (6 n + 16 npad) B a wave over 3.35 TB/s.  Both kernels move
// whole, contiguous, 16-byte-aligned spans where the shapes allow it and
// reshuffle through shared memory free of bank conflicts:
//  * aos_rows: a warp takes 128 rays.  Their 384 floats of o (and of d)
//    are one contiguous span: three float4 loads a lane for each, stored
//    to shared memory as they came, then read back at stride 3 (odd, so
//    32 distinct banks) into six row stores of 128 floats, each a lane's
//    float at a time: coalesced 128-byte segments;
//  * rows16: a block of 256 threads takes 16 rows x 256 columns, reads
//    them as 1024 float4 (a row's 64 float4 are contiguous), keeps them
//    in a [16][256] tile whose float4 columns are XOR-swizzled by row,
//    and writes the 256 rays x 16 features -- one contiguous 16 KB span
//    -- as 1024 float4 (float4 q: ray q / 4, features 4 (q % 4) .. +3).
//    The swizzle (float4 column c of row r stored at c ^ 2 (r / 4)) keeps
//    the tile's float4 stores and its scalar reads conflict-free.
// Where a span is not 16-byte aligned (a width that is not a multiple of
// 4, an offset view) or is the ragged last one, the same pattern runs on
// scalar accesses.  No arithmetic: both are bit-identical to
// .t().contiguous().

#include "s3_common.cuh"

namespace {

constexpr int kAosRays = 128;         // rays per warp
constexpr int kAosWarps = 8;
constexpr int kAosThreads = 32 * kAosWarps;

constexpr int kRows = 16;             // feature rows
constexpr int kCols = 256;            // columns (rays) per block
constexpr int kCols4 = kCols / 4;
constexpr int kRowsThreads = 256;

__global__ void __launch_bounds__(kAosThreads)
aos_rows_kernel(const float* __restrict__ o, const float* __restrict__ d,
                int64_t n, int vec, float* __restrict__ out) {
  __shared__ float s_buf[kAosWarps][2][3 * kAosRays];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * kAosWarps + warp) * kAosRays;
  if (r0 >= n) return;
  const int cnt = static_cast<int>(min(static_cast<int64_t>(kAosRays),
                                       n - r0));
  float* so = s_buf[warp][0];
  float* sd = s_buf[warp][1];
  const float* go = o + 3 * r0;
  const float* gd = d + 3 * r0;
  if (vec && cnt == kAosRays) {
    const float4* go4 = reinterpret_cast<const float4*>(go);
    const float4* gd4 = reinterpret_cast<const float4*>(gd);
    float4 a[3], b[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a[k] = go4[lane + 32 * k];
      b[k] = gd4[lane + 32 * k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      reinterpret_cast<float4*>(so)[lane + 32 * k] = a[k];
      reinterpret_cast<float4*>(sd)[lane + 32 * k] = b[k];
    }
  } else {
    for (int i = lane; i < 3 * cnt; i += 32) {
      so[i] = go[i];
      sd[i] = gd[i];
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    for (int i = lane; i < cnt; i += 32) {
      out[c * n + r0 + i] = so[3 * i + c];
      out[(3 + c) * n + r0 + i] = sd[3 * i + c];
    }
  }
}

// the tile's float index of (row r, column c)
__device__ __forceinline__ int tile_at(int r, int c) {
  return r * kCols + ((((c >> 2) ^ (2 * (r >> 2))) << 2) | (c & 3));
}

__global__ void __launch_bounds__(kRowsThreads)
rows16_kernel(const float* __restrict__ src, int64_t cols, int vec,
              float* __restrict__ dst) {
  __shared__ float4 tile4[kRows * kCols4];
  float* tile = reinterpret_cast<float*>(tile4);
  const int tid = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const int ncol = static_cast<int>(min(static_cast<int64_t>(kCols),
                                        cols - c0));
  const bool full = vec && ncol == kCols;
  if (full) {
#pragma unroll
    for (int k = 0; k < kRows * kCols4 / kRowsThreads; ++k) {
      const int i = tid + k * kRowsThreads;
      const int r = i / kCols4, c4 = i % kCols4;
      tile4[r * kCols4 + (c4 ^ (2 * (r >> 2)))] =
          reinterpret_cast<const float4*>(src + r * cols + c0)[c4];
    }
  } else {
    for (int i = tid; i < kRows * kCols; i += kRowsThreads) {
      const int r = i / kCols, c = i % kCols;
      if (c < ncol) tile[tile_at(r, c)] = src[r * cols + c0 + c];
    }
  }
  __syncthreads();
  if (full) {
    float4* d4 = reinterpret_cast<float4*>(dst + c0 * kRows);
#pragma unroll
    for (int k = 0; k < kRows * kCols4 / kRowsThreads; ++k) {
      const int q = tid + k * kRowsThreads;
      const int j = q >> 2, f = (q & 3) * 4;
      d4[q] = make_float4(tile[tile_at(f, j)], tile[tile_at(f + 1, j)],
                          tile[tile_at(f + 2, j)], tile[tile_at(f + 3, j)]);
    }
  } else {
    for (int i = tid; i < ncol * kRows; i += kRowsThreads) {
      const int j = i / kRows, f = i % kRows;
      dst[(c0 + j) * kRows + f] = tile[tile_at(f, j)];
    }
  }
}

}  // namespace

extern "C" {

// o, d: [n, 3] f32 row-major; out: [6, n] f32 (ox, oy, oz, dx, dy, dz).
// vec: o, d and out are 16-byte aligned.  Returns cudaGetLastError().
int rt_s3_aos_rows(const float* o, const float* d, int64_t n, float* out,
                   int vec, void* stream) {
  if (n <= 0) return 0;
  const int64_t per_block = static_cast<int64_t>(kAosRays) * kAosWarps;
  aos_rows_kernel<<<static_cast<unsigned>((n + per_block - 1) / per_block),
                    kAosThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, n, vec, out);
  return static_cast<int>(cudaGetLastError());
}

// src: [16, cols] f32 row-major; dst: [cols, 16] f32.  vec: cols is a
// multiple of 4 and src, dst are 16-byte aligned.  Returns
// cudaGetLastError().
int rt_s3_rows16_major(const float* src, int64_t cols, float* dst, int vec,
                       void* stream) {
  if (cols <= 0) return 0;
  rows16_kernel<<<static_cast<unsigned>((cols + kCols - 1) / kCols),
                  kRowsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, cols, vec, dst);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
