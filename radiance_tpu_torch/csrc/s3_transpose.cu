// Kernel A of the stream3 pipeline: a tiled f32 transpose for Hopper.
//
// Replaces two TPU kernels of radiance_tpu/ops/stream3.py, both plain
// layout changes:
//  * _aos2rows_kernel (:1595, launched by rows_from_aos_fast :1619):
//    [n, 3] origins and directions -> six [n] component rows;
//  * _transpose_kernel (:1575, launched by feats_rows_to_major :1584):
//    the phase-2 features [16, npad] -> ray-major [npad, 16].
// One kernel serves both: dst[c * dst_ld + r] = src[r * cols + c], the
// wrapper giving dst_ld = rows (the [6, n] buffer takes two launches).
//
// What bounds it: bytes.  Each element is read once and written once, so
// the least time is 2 * 4 * rows * cols B over 3.35 TB/s.  A 32 x 32 tile
// is staged through shared memory (33 columns: the padding puts a tile
// column in 32 distinct banks) so that both the read and the write of a
// warp touch 32 consecutive floats.  Narrow sources ([n, 3]) fill only 3
// of a tile's 32 columns; the reads stay contiguous (96 floats a tile)
// but most threads of a block idle -- acceptable for a first version.
// The copy is exact (no arithmetic): bit-identical to .t().contiguous().

#include "s3_common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;

__global__ void __launch_bounds__(kTile * kRowsPerPass)
transpose_kernel(const float* __restrict__ src, int64_t rows, int64_t cols,
                 float* __restrict__ dst, int64_t dst_ld,
                 int64_t col_tiles) {
  __shared__ float tile[kTile][kTile + 1];
  // a 1-D grid of tiles: either side may exceed gridDim.y's 65535 tiles
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) % col_tiles) * kTile;
  const int64_t r0 = (static_cast<int64_t>(blockIdx.x) / col_tiles) * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int k = ty; k < kTile; k += kRowsPerPass) {
    const int64_t r = r0 + k, c = c0 + tx;
    if (r < rows && c < cols) tile[k][tx] = src[r * cols + c];
  }
  __syncthreads();
  for (int k = ty; k < kTile; k += kRowsPerPass) {
    const int64_t c = c0 + k, r = r0 + tx;
    if (r < rows && c < cols) dst[c * dst_ld + r] = tile[tx][k];
  }
}

}  // namespace

extern "C" {

// src: [rows, cols] f32 row-major; dst: cols rows of dst_ld floats, of
// which the first `rows` are written.  Returns cudaGetLastError().
int rt_s3_transpose(const float* src, int64_t rows, int64_t cols, float* dst,
                    int64_t dst_ld, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const int64_t col_tiles = (cols + kTile - 1) / kTile;
  const int64_t tiles = col_tiles * ((rows + kTile - 1) / kTile);
  transpose_kernel<<<static_cast<unsigned>(tiles),
                     dim3(kTile, kRowsPerPass), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      src, rows, cols, dst, dst_ld, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
