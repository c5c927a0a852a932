// The staged block step of B6, the per-block stream against B vectors
// (block_run_batched_kernel in spmv_block.cu).
//
// B6 walks one run of blocks a CTA (a row-block's blocks, first flag to
// last flag) against B vectors:
//   x  [ncb, 128, B] f32 with x[cb, l, b]
//   y  [nrb, BH, B] f32, zeroed by the caller; the run's last block stores
//      its row-block's outputs.
//
// Why not block_stream.cuh's design.  It keeps one lane's partial for BH
// rows in each thread and reduces the 128 lanes at a flush; with B vectors
// that is BH*B registers a thread (512 at bh 8, B 64).  Here the reduction over the 128
// lanes happens per block instead, as the (BH, 128) x (128, P) product the
// TPU kernel hands to its MXU, and each thread keeps finished outputs.  (B2
// and B8 hold only R*V partials a thread, block_vec.cuh.)
//
// Design.  One CTA of 256 threads per (run, panel of at most 64 vectors).
// Per block, the (BH, 128) A tile (rows padded to 129 floats) and the
// block's x rows (128, PP) (PP = panel rounded up to a power of two, rows
// padded to PP+1 floats, dead columns zero) are staged in shared memory
// between two barriers.  The BH*PP outputs are spread over the threads:
// when there are at least 256, thread t owns column t % PP of rows t/PP +
// i*(256/PP), each a 128-long fp32 FMA chain that reuses one x value
// across its rows; when there are fewer, S = min(32, 256/(BH*PP))
// consecutive threads split one output's 128 lanes and reduce by warp
// shuffles at the flush.
//
// All arithmetic is fp32 FMA (the TPU kernel runs at Precision.HIGHEST),
// no TF32 or bf16 tensor-core path.

#pragma once

#include <cuda_runtime.h>

#include "block_stream.cuh"

namespace hispmv {

constexpr int kBatchThreads = 256;
constexpr int kPanel = 64;  // vectors per CTA at most
constexpr int kAStride = kLanes + 1;

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

// Stores the thread's outputs into y_rb [BH, batch] (columns b0 + col,
// only those below `live`) and zeroes them.  All threads of the CTA call it
// together: the shuffles need every lane of each warp.
template <int BH>
__device__ __forceinline__ void store_outputs(float (&acc)[max_outputs<BH>()],
                                              const OutputMap& m,
                                              float* __restrict__ y_rb,
                                              int batch, int b0, int live) {
  constexpr int kMax = max_outputs<BH>();
  if (m.split == 1) {
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i < m.count && m.col < live) {
        y_rb[static_cast<size_t>(m.row0 + i * m.rstep) * batch + b0 + m.col] =
            acc[i];
      }
      acc[i] = 0.f;
    }
  } else {
    float v = acc[0];
    for (int off = m.split >> 1; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (m.count && m.lane0 == 0 && m.col < live) {
      y_rb[static_cast<size_t>(m.row0) * batch + b0 + m.col] = v;
    }
    acc[0] = 0.f;
  }
}

// Stages block `blk`'s (BH, 128) A tile and its x rows for the panel
// (columns b0 .. b0+live of col block `col`) in shared memory `smem`
// ((BH*kAStride + 128*(pp+1)) floats) and adds the tile's product into the
// thread's outputs.  All threads of the CTA call it together.
template <int BH>
__device__ __forceinline__ void accumulate_block(
    const float* __restrict__ data, const float* __restrict__ x, size_t blk,
    int col, int batch, int b0, int live, int pp, const OutputMap& m,
    float* smem, float (&acc)[max_outputs<BH>()]) {
  constexpr int kMax = max_outputs<BH>();
  float* s_a = smem;                  // [BH][kAStride]
  float* s_x = smem + BH * kAStride;  // [128][pp + 1]
  const int xs = pp + 1;
  const int t = threadIdx.x;
  __syncthreads();  // every thread is done with the previous tiles
  const float* ab = data + blk * BH * kLanes;
  for (int i = t; i < BH * kLanes; i += kBatchThreads) {
    s_a[(i >> 7) * kAStride + (i & (kLanes - 1))] = ab[i];
  }
  for (int i = t; i < kLanes * pp; i += kBatchThreads) {
    const int b = i % pp;
    const int l = i / pp;
    float v = 0.f;
    if (b < live) {
      v = x[(static_cast<size_t>(col) * kLanes + l) * batch + b0 + b];
    }
    s_x[l * xs + b] = v;
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

}  // namespace hispmv
