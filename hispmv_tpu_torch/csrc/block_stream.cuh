// Shared device code of the one-CTA-a-chunk block stream of
// spmv_chunked_tiled.cu (B4) and the tile flush of spmv_block.cu (B5); its
// constants and to_f32 also serve block_vec.cuh (B1, B2, B3, B7, B8) and
// block_stream_batched.cuh (B6).
//
// B4 consumes the packed arrays of the JAX package unchanged:
//   data       [nchunks, chunk*BH, 128] f32 or bf16 block payloads
//   meta       [nchunks, 2, chunk]      i32: meta[c,0,j] = row_block*2 +
//                                           last, local to the y panel;
//                                           meta[c,1,j] = col block local
//                                           to the x panel
//   xpanel_ids [nchunks]                i32 x panel of each chunk
//   ypanel_ids [nchunks]                i32 y panel of each chunk
//   x2d        [npanels_x*panel_ncb, 128] f32
//   y          [npanels_y*panel_nrb, BH] f32, zeroed by the caller; the
//              kernel only adds to it.
//
// Design.  One CTA per chunk, one thread per lane (128 threads), BH fp32
// accumulators in registers per thread: thread l holds column l of the
// (BH, 128) accumulator tile.  Per block, each warp reads BH rows of 32
// consecutive values (128 B for f32), so the A stream is read coalesced and
// exactly once.  On a last-flagged block the tile's row sums are formed by a
// warp shuffle tree plus a 4-warp combine in shared memory, and added into y
// with atomicAdd.
//
// The TPU kernel runs its grid in order and carries the accumulator from one
// chunk to the next, so a row-block may span chunks.  Here chunks run in
// parallel: the partial sum still open at the end of a chunk is added into
// the row-block of the chunk's last block (blocks are sorted by row-block,
// and every row-block ends with a last-flagged block, plan/blocks.py), and
// the later chunk adds the rest.  Padding blocks carry a zero payload, so
// they only ever add zeros.  The order of the atomic additions varies from
// run to run, so results agree with the TPU kernel to fp32 rounding, not
// bit for bit.

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

// One CTA streams one chunk of `chunk` blocks: lane l of block j reads
// x2d[cb, l] of chunk c's x panel, from row xpanel_ids[c] * panel_ncb of
// x2d on, and chunk c adds into y from row-block ypanel_ids[c] * panel_nrb
// on.
template <typename T, int BH>
__global__ void __launch_bounds__(kLanes)
    block_stream_kernel(const T* __restrict__ data,
                        const int* __restrict__ meta,
                        const int* __restrict__ xpanel_ids,
                        const int* __restrict__ ypanel_ids,
                        const float* __restrict__ x2d,
                        float* __restrict__ y, int chunk, int panel_ncb,
                        int panel_nrb) {
  __shared__ float red[kWarps][BH];
  const int l = threadIdx.x;
  const size_t c = blockIdx.x;
  const int* rows = meta + c * 2 * chunk;  // row_block*2 + last
  const int* cols = rows + chunk;          // col block in the panel
  const T* a = data + c * chunk * BH * kLanes + l;
  x2d += static_cast<size_t>(xpanel_ids[c]) * panel_ncb * kLanes;
  y += static_cast<size_t>(ypanel_ids[c]) * panel_nrb * BH;

  float acc[BH];
#pragma unroll
  for (int r = 0; r < BH; ++r) acc[r] = 0.f;

  bool open = false;  // the tile holds blocks not yet flushed
  for (int j = 0; j < chunk; ++j) {
    const int rb2 = rows[j];
    const float xv = x2d[static_cast<size_t>(cols[j]) * kLanes + l];
    const T* ab = a + static_cast<size_t>(j) * BH * kLanes;
#pragma unroll
    for (int r = 0; r < BH; ++r) {
      acc[r] = fmaf(to_f32(ab[r * kLanes]), xv, acc[r]);
    }
    open = true;
    if (rb2 & 1) {  // uniform across the CTA: meta is per block
      flush_tile<BH>(acc, y + static_cast<size_t>(rb2 >> 1) * BH, red);
      open = false;
    }
  }
  if (open) {  // row-block continues in the next chunk
    flush_tile<BH>(acc, y + static_cast<size_t>(rows[chunk - 1] >> 1) * BH,
                   red);
  }
}

template <typename T>
int launch_block_stream(const void* data, const int* meta,
                        const int* xpanel_ids, const int* ypanel_ids,
                        const float* x2d, float* y, int nchunks, int chunk,
                        int bh, int panel_ncb, int panel_nrb,
                        cudaStream_t stream) {
  if (nchunks <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* d = static_cast<const T*>(data);
  const dim3 grid(nchunks), block(kLanes);
#define HISPMV_LAUNCH(BHV)                                                 \
  case BHV:                                                                \
    block_stream_kernel<T, BHV><<<grid, block, 0, stream>>>(               \
        d, meta, xpanel_ids, ypanel_ids, x2d, y, chunk, panel_ncb,         \
        panel_nrb);                                                        \
    break;
  switch (bh) {
    HISPMV_LAUNCH(1)
    HISPMV_LAUNCH(2)
    HISPMV_LAUNCH(4)
    HISPMV_LAUNCH(8)
    HISPMV_LAUNCH(16)
    HISPMV_LAUNCH(32)
    HISPMV_LAUNCH(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HISPMV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hispmv
