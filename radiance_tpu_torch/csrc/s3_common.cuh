// Shared by the stream3 kernels (s3_*.cu): the word format and the float
// helpers whose semantics the plain PyTorch versions fix.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace s3 {

constexpr float kFltMax = 3.402823466e38f;
constexpr int kPkt = 1024;      // rays per packet
constexpr int kBlk = 128;       // rays per phase-2 block
constexpr int kNLanes = 32;     // 32-ray sub-frusta per packet

// Word: (leaf + 1) << kLeafShift | keepmask << kKeepShift | tq.  The tq
// width is a build define (ops/stream3_stages.WordFormat; 9 by default, the
// JAX package's RADIANCE_TQ_BITS): a library is built for each width a
// process uses.  Each bit given up doubles the leaf ids a word can address.
#ifndef RT_TQ_BITS
#define RT_TQ_BITS 9
#endif
constexpr int kTqBits = RT_TQ_BITS;
static_assert(kTqBits >= 5 && kTqBits <= 9, "RT_TQ_BITS must be in [5, 9]");
constexpr int kKeepShift = kTqBits;
constexpr int kLeafShift = kTqBits + 8;
constexpr int kTqMask = (1 << kTqBits) - 1;
constexpr int kTqShift = 27 - kTqBits;
constexpr int kTqBias3 = 125 << (kTqBits - 4);
constexpr int kTqBucketShift = kTqBits - 5;   // 32 tq counting-sort buckets

// The quantised lower bound of a word's leaf entry distance as f32 bits
// (0 where tq is 0): the temporal and occlusion culls compare it with
// the bits of a positive t.
__device__ __forceinline__ int word_lb_bits(int w) {
  const int tq = w & kTqMask;
  return tq == 0 ? 0 : (tq + kTqBias3) << kTqShift;
}

// torch.minimum / torch.maximum (and jnp.minimum / maximum): NaN in, NaN
// out.  fminf / fmaxf would drop the NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ int word_leaf(int w) {
  return max((w >> kLeafShift) - 1, 0);
}

}  // namespace s3
