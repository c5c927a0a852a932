// Shared device code of the block-stream SpMV kernels
// (spmv_chunked.cu: B1, spmv_chunked_paneled.cu: B3, spmv_chunked_tiled.cu:
// B4, spmv_windowed.cu: B7, and the tile flush of spmv_block.cu: B5; its
// constants and to_f32 also serve block_vec.cuh and block_stream_batched.cuh).
//
// They consume the packed arrays of the JAX package unchanged:
//   data      [nchunks, chunk*BH, 128] f32 or bf16 block payloads
//   meta      [nchunks, 2, chunk]      i32: meta[c,0,j] = row_block*2 + last,
//                                           meta[c,1,j] = col block (B1, B3;
//                                           local to the panel for B3) or
//                                           1024-column window (B7); B4's
//                                           rows are local to the y panel
//   subidx    [nchunks, chunk, 128]    i32 in [0, 8) (B7 only)
//   panel_ids [nchunks]                i32 x panel of each chunk (B3, B4)
//   ypanel_ids [nchunks]               i32 y panel of each chunk (B4 only)
//   x2d       [ncb, 128] (B1), [npanels*panel_ncb, 128] (B3, B4) or
//             [nwin*8, 128] (B7) f32
//   y         [nrb, BH] (B4: [npanels_y*panel_nrb, BH]) f32, zeroed by the
//             caller; the kernel only adds to it.
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
constexpr int kSegs = 8;  // column segments per 1024-column window (B7)

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

// One CTA streams one chunk of `chunk` blocks.  WINDOWED selects B7's x
// gather (lane l reads x2d[win*8 + subidx[j, l], l]) over B1's
// (lane l reads x2d[cb, l]).  PANELED (B3): chunk c reads x from row
// panel_ids[c] * panel_ncb of x2d on.  TILED (B4, with PANELED): chunk c
// also adds into y from row-block ypanel_ids[c] * panel_nrb on.  Each is a
// template flag: a runtime branch on the panel offset slowed B1 by 65%.
template <typename T, int BH, bool WINDOWED, bool PANELED, bool TILED>
__global__ void __launch_bounds__(kLanes)
    block_stream_kernel(const T* __restrict__ data,
                        const int* __restrict__ subidx,
                        const int* __restrict__ meta,
                        const int* __restrict__ panel_ids,
                        const int* __restrict__ ypanel_ids,
                        const float* __restrict__ x2d,
                        float* __restrict__ y, int chunk, int panel_ncb,
                        int panel_nrb) {
  __shared__ float red[kWarps][BH];
  const int l = threadIdx.x;
  const size_t c = blockIdx.x;
  const int* rows = meta + c * 2 * chunk;  // row_block*2 + last
  const int* cols = rows + chunk;          // col block or window
  const T* a = data + c * chunk * BH * kLanes + l;
  if constexpr (PANELED) {
    x2d += static_cast<size_t>(panel_ids[c]) * panel_ncb * kLanes;
  }
  if constexpr (TILED) {
    y += static_cast<size_t>(ypanel_ids[c]) * panel_nrb * BH;
  }

  float acc[BH];
#pragma unroll
  for (int r = 0; r < BH; ++r) acc[r] = 0.f;

  bool open = false;  // the tile holds blocks not yet flushed
  for (int j = 0; j < chunk; ++j) {
    const int rb2 = rows[j];
    float xv;
    if constexpr (WINDOWED) {
      const int sub = subidx[(c * chunk + j) * kLanes + l];
      xv = x2d[(static_cast<size_t>(cols[j]) * kSegs + sub) * kLanes + l];
    } else {
      xv = x2d[static_cast<size_t>(cols[j]) * kLanes + l];
    }
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

template <typename T, bool WINDOWED, bool PANELED = false, bool TILED = false>
int launch_block_stream(const void* data, const int* subidx, const int* meta,
                        const int* panel_ids, const float* x2d, float* y,
                        int nchunks, int chunk, int bh, int panel_ncb,
                        cudaStream_t stream, const int* ypanel_ids = nullptr,
                        int panel_nrb = 0) {
  static_assert(!TILED || PANELED, "TILED streams x in panels too");
  if (nchunks <= 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const T* d = static_cast<const T*>(data);
  const dim3 grid(nchunks), block(kLanes);
#define HISPMV_LAUNCH(BHV)                                                 \
  case BHV:                                                                \
    block_stream_kernel<T, BHV, WINDOWED, PANELED, TILED>                  \
        <<<grid, block, 0, stream>>>(d, subidx, meta, panel_ids,           \
                                     ypanel_ids, x2d, y, chunk, panel_ncb, \
                                     panel_nrb);                           \
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
