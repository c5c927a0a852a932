// Shared device code of the batched block-stream kernels
// (spmv_windowed_batched.cu: B8, and the block step of spmv_block.cu: B6;
// B2 has a kernel of its own in spmv_chunked_batched.cu).
//
// They consume the packed arrays of the single-vector kernels
// (block_stream.cuh) unchanged, against B vectors:
//   x  [ncb, 128, B] f32 with x[cb, l, b] (unwindowed, as B2's), or
//      [nwin*8, B*128] f32 with x[win*8 + s, b*128 + l] (B8, pack_batch_x)
//   y  [nrb, BH, B] f32, zeroed by the caller; the kernel only adds to it.
//
// Why not B1's design.  B1 keeps one lane's partial for BH rows in each
// thread and reduces the 128 lanes at a flush; with B vectors that is BH*B
// registers a thread (512 at bh 8, B 64).  Here the reduction over the 128
// lanes happens per block instead, as the (BH, 128) x (128, P) product the
// TPU kernel hands to its MXU, and each thread keeps finished outputs.
//
// Design.  One CTA of 256 threads per (range of blocks of a chunk, panel of
// at most 64 vectors).  Per block, the (BH, 128) A tile (rows padded to 129
// floats) and the block's x rows (128, PP) (PP = panel rounded up to a
// power of two, rows padded to PP+1 floats, dead columns zero) are staged
// in shared memory; for B8 the x rows are gathered through subidx.  The
// BH*PP outputs are spread over the threads: when there are at least 256,
// thread t owns column t % PP of rows t/PP + i*(256/PP), each a 128-long
// fp32 FMA chain that reuses one x value across its rows; when there are
// fewer, S = min(32, 256/(BH*PP)) consecutive threads split one output's
// 128 lanes and reduce by warp shuffles at the flush.  On a last-flagged
// block the outputs are added into y with atomicAdd.
//
// Chunks are cut into ranges of blocks so that the grid holds about four
// CTAs per SM even when a matrix has few chunks.  Blocks are sorted by
// row-block and every row-block ends with a last-flagged block, so a range
// may start inside a row-block: the partial still open at a range's end is
// added into the row-block of its last block, and the next range adds the
// rest (B1's chunk-boundary rule).  Padding blocks add zeros only.
//
// All arithmetic is fp32 FMA (the TPU kernels run at Precision.HIGHEST), no
// TF32 or bf16 tensor-core path; a bf16 payload is widened on load.  The
// order of the atomic additions varies from run to run, so results agree
// with the plain version to fp32 rounding, not bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_stream.cuh"

namespace hispmv {

constexpr int kBatchThreads = 256;
constexpr int kPanel = 64;  // vectors per CTA at most
constexpr int kAStride = kLanes + 1;
constexpr int kCtasPerSm = 4;

// Outputs a thread may own: BH*64/256 at most, and at least one.
template <int BH>
__host__ __device__ constexpr int max_outputs() {
  return BH * kPanel >= kBatchThreads ? BH * kPanel / kBatchThreads : 1;
}

// Which outputs of the (BH, PP) tile this thread forms.
struct OutputMap {
  int split;  // S: threads sharing one output (1 = a thread owns whole ones)
  int lane0;  // first of the 128 lanes this thread sums (strided by split)
  int col;    // vector column in the panel
  int row0;   // first row
  int rstep;  // row stride between the thread's outputs
  int count;  // outputs owned (0 for an idle thread)
};

template <int BH>
__device__ __forceinline__ OutputMap map_outputs(int pp) {
  OutputMap m;
  const int t = threadIdx.x;
  const int nout = BH * pp;
  if (nout >= kBatchThreads) {
    m.split = 1;
    m.lane0 = 0;
    m.col = t % pp;
    m.row0 = t / pp;
    m.rstep = kBatchThreads / pp;
    m.count = nout / kBatchThreads;
  } else {
    m.split = min(32, kBatchThreads / nout);
    const int g = t / m.split;
    m.lane0 = t % m.split;
    m.col = g % pp;
    m.row0 = g / pp;
    m.rstep = 0;
    m.count = g < nout ? 1 : 0;
  }
  return m;
}

// Adds the thread's outputs into y_rb [BH, batch] (columns b0 + col, only
// those below `live`; stores them with ASSIGN) and zeroes them.  All threads
// of the CTA call it together: the shuffles need every lane of each warp.
template <int BH, bool ASSIGN = false>
__device__ __forceinline__ void flush_outputs(float (&acc)[max_outputs<BH>()],
                                              const OutputMap& m,
                                              float* __restrict__ y_rb,
                                              int batch, int b0, int live) {
  constexpr int kMax = max_outputs<BH>();
  if (m.split == 1) {
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i < m.count && m.col < live) {
        float* out = y_rb + static_cast<size_t>(m.row0 + i * m.rstep) * batch +
                     b0 + m.col;
        if constexpr (ASSIGN) {
          *out = acc[i];
        } else {
          atomicAdd(out, acc[i]);
        }
      }
      acc[i] = 0.f;
    }
  } else {
    float v = acc[0];
    for (int off = m.split >> 1; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (m.count && m.lane0 == 0 && m.col < live) {
      float* out = y_rb + static_cast<size_t>(m.row0) * batch + b0 + m.col;
      if constexpr (ASSIGN) {
        *out = v;
      } else {
        atomicAdd(out, v);
      }
    }
    acc[0] = 0.f;
  }
}

// Stages block `blk`'s (BH, 128) A tile and its x rows for the panel
// (columns b0 .. b0+live of col block / window `col`) in shared memory
// `smem` ((BH*kAStride + 128*(pp+1)) floats) and adds the tile's product
// into the thread's outputs.  All threads of the CTA call it together.
template <typename T, int BH, bool WINDOWED>
__device__ __forceinline__ void accumulate_block(
    const T* __restrict__ data, const int* __restrict__ subidx,
    const float* __restrict__ x, size_t blk, int col, int batch, int b0,
    int live, int pp, const OutputMap& m, float* smem,
    float (&acc)[max_outputs<BH>()]) {
  constexpr int kMax = max_outputs<BH>();
  float* s_a = smem;                  // [BH][kAStride]
  float* s_x = smem + BH * kAStride;  // [128][pp + 1]
  const int xs = pp + 1;
  const int t = threadIdx.x;
  __syncthreads();  // every thread is done with the previous tiles
  const T* ab = data + blk * BH * kLanes;
  for (int i = t; i < BH * kLanes; i += kBatchThreads) {
    s_a[(i >> 7) * kAStride + (i & (kLanes - 1))] = to_f32(ab[i]);
  }
  if constexpr (WINDOWED) {
    const int* sub = subidx + blk * kLanes;
    const size_t row_len = static_cast<size_t>(batch) * kLanes;
    for (int i = t; i < kLanes * pp; i += kBatchThreads) {
      const int l = i & (kLanes - 1);
      const int b = i >> 7;
      float v = 0.f;
      if (b < live) {
        v = x[(static_cast<size_t>(col) * kSegs + sub[l]) * row_len +
              static_cast<size_t>(b0 + b) * kLanes + l];
      }
      s_x[l * xs + b] = v;
    }
  } else {
    for (int i = t; i < kLanes * pp; i += kBatchThreads) {
      const int b = i % pp;
      const int l = i / pp;
      float v = 0.f;
      if (b < live) {
        v = x[(static_cast<size_t>(col) * kLanes + l) * batch + b0 + b];
      }
      s_x[l * xs + b] = v;
    }
  }
  __syncthreads();
  if (m.split == 1) {
    for (int l = 0; l < kLanes; ++l) {
      const float xv = s_x[l * xs + m.col];
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        if (i < m.count) {
          acc[i] = fmaf(s_a[(m.row0 + i * m.rstep) * kAStride + l], xv,
                        acc[i]);
        }
      }
    }
  } else if (m.count) {
    for (int l = m.lane0; l < kLanes; l += m.split) {
      acc[0] = fmaf(s_a[m.row0 * kAStride + l], s_x[l * xs + m.col], acc[0]);
    }
  }
}

// grid.x = nchunks * nsplit (range `span` blocks of chunk x / nsplit),
// grid.y = panels of kPanel vectors.  Dynamic shared memory:
// (BH*kAStride + 128*(pp+1)) floats.
template <typename T, int BH, bool WINDOWED>
__global__ void __launch_bounds__(kBatchThreads)
    block_stream_batched_kernel(const T* __restrict__ data,
                                const int* __restrict__ subidx,
                                const int* __restrict__ meta,
                                const float* __restrict__ x,
                                float* __restrict__ y, int chunk, int span,
                                int nsplit, int batch, int pp) {
  constexpr int kMax = max_outputs<BH>();
  extern __shared__ float smem[];
  const size_t c = blockIdx.x / nsplit;
  const int j0 = static_cast<int>(blockIdx.x % nsplit) * span;
  const int j1 = min(j0 + span, chunk);
  if (j0 >= j1) return;  // uniform across the CTA
  const int b0 = blockIdx.y * kPanel;
  const int live = min(kPanel, batch - b0);  // real columns of the panel
  const int* rows = meta + c * 2 * chunk;    // row_block*2 + last
  const int* cols = rows + chunk;            // col block or window
  const OutputMap m = map_outputs<BH>(pp);

  float acc[kMax];
#pragma unroll
  for (int i = 0; i < kMax; ++i) acc[i] = 0.f;

  bool open = false;  // outputs hold blocks not yet flushed
  for (int j = j0; j < j1; ++j) {
    const int rb2 = rows[j];
    accumulate_block<T, BH, WINDOWED>(data, subidx, x, c * chunk + j, cols[j],
                                      batch, b0, live, pp, m, smem, acc);
    open = true;
    if (rb2 & 1) {  // uniform across the CTA: meta is per block
      flush_outputs<BH>(acc, m,
                        y + static_cast<size_t>(rb2 >> 1) * BH * batch, batch,
                        b0, live);
      open = false;
    }
  }
  if (open) {  // the row-block continues in the next range
    flush_outputs<BH>(acc, m,
                      y + static_cast<size_t>(rows[j1 - 1] >> 1) * BH * batch,
                      batch, b0, live);
  }
}

template <typename T, int BH, bool WINDOWED>
cudaError_t launch_batched_bh(const T* data, const int* subidx,
                              const int* meta, const float* x, float* y,
                              dim3 grid, int chunk, int span, int nsplit,
                              int batch, int pp, cudaStream_t stream) {
  auto kernel = block_stream_batched_kernel<T, BH, WINDOWED>;
  const size_t smem =
      (static_cast<size_t>(BH) * kAStride + kLanes * (pp + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kBatchThreads, smem, stream>>>(data, subidx, meta, x, y,
                                                 chunk, span, nsplit, batch,
                                                 pp);
  return cudaGetLastError();
}

template <typename T, bool WINDOWED>
int launch_block_stream_batched(const void* data, const int* subidx,
                                const int* meta, const float* x, float* y,
                                int nchunks, int chunk, int bh, int batch,
                                cudaStream_t stream) {
  if (nchunks <= 0 || chunk <= 0 || batch <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int npanel = (batch + kPanel - 1) / kPanel;
  if (npanel > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int panel = batch < kPanel ? batch : kPanel;
  int pp = 1;
  while (pp < panel) pp <<= 1;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  // cut chunks into ranges until the grid holds ~kCtasPerSm CTAs per SM
  const long long have = static_cast<long long>(nchunks) * npanel;
  const long long want = static_cast<long long>(kCtasPerSm) * sms;
  long long nsplit = (want + have - 1) / have;
  nsplit = nsplit < 1 ? 1 : (nsplit > chunk ? chunk : nsplit);
  const int span = static_cast<int>((chunk + nsplit - 1) / nsplit);
  nsplit = (chunk + span - 1) / span;
  if (static_cast<long long>(nchunks) * nsplit > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(nchunks * nsplit), npanel);
  const T* d = static_cast<const T*>(data);
  const int ns = static_cast<int>(nsplit);
#define HISPMV_LAUNCH_BATCHED(BHV)                                         \
  case BHV:                                                                \
    e = launch_batched_bh<T, BHV, WINDOWED>(d, subidx, meta, x, y, grid,   \
                                            chunk, span, ns, batch, pp,    \
                                            stream);                       \
    break;
  switch (bh) {
    HISPMV_LAUNCH_BATCHED(1)
    HISPMV_LAUNCH_BATCHED(2)
    HISPMV_LAUNCH_BATCHED(4)
    HISPMV_LAUNCH_BATCHED(8)
    HISPMV_LAUNCH_BATCHED(16)
    HISPMV_LAUNCH_BATCHED(32)
    HISPMV_LAUNCH_BATCHED(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HISPMV_LAUNCH_BATCHED
  return static_cast<int>(e);
}

}  // namespace hispmv
