// Shared device code of the block kernels: the constants and to_f32 of
// block_vec.cuh (B1, B2, B3, B4, B7, B8) and spmv_block.cu (B5, B6), and
// the tile flush of B5 (spmv_block.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hispmv {

constexpr int kLanes = 128;  // block width == threads per CTA
constexpr int kWarps = kLanes / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Adds the row sums of the (BH, 128) accumulator tile into y_rb[0:BH]
// (stores them with ASSIGN) and zeroes the tile.  All 128 threads of the CTA
// must call it together.
template <int BH, bool ASSIGN = false>
__device__ __forceinline__ void flush_tile(float (&acc)[BH],
                                           float* __restrict__ y_rb,
                                           float (*red)[BH]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < BH; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[warp][r] = v;
    acc[r] = 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BH; r += kLanes) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][r];
    if constexpr (ASSIGN) {
      y_rb[r] = s;
    } else {
      atomicAdd(y_rb + r, s);
    }
  }
  __syncthreads();  // red is reused by the next flush
}

}  // namespace hispmv
