// B5 and B6: the per-block block-ELL stream against one vector and against
// B vectors, on Hopper (sm_90a).
//
// Replace the TPU kernels hispmv_tpu/ops/spmv_block.py::_spmv_block_kernel
// (wrapper spmv_block_pallas) and ::_spmv_block_batched_kernel (wrapper
// spmv_block_batched_pallas).  They consume the plan's arrays unchanged:
//   data   [nblocks, BH, 128] f32 block payloads, sorted by row-block
//   rows, cols, firsts, lasts [nblocks] i32 (BlockPlan / sharded plans)
//   x      [ncb, 128] (B5) or [ncb, 128, batch] (B6) f32
//   y      [nrb, BH] (B5) or [nrb, BH, batch] (B6) f32
// They run each shard of the sharded block executor (dist/shard.py) and the
// one-shot spmv_block of ops/.
//
// The TPU grid runs one step per block, in order: it zeroes its accumulator
// on a first-flagged block, adds A_blk * x[cb] (B6: A_blk @ X[cb]), and on a
// last-flagged block ASSIGNS y[rows[i]] from it.  The parallel form keeps
// that assign: one CTA per run of blocks that starts at a first flag (the
// run starts are found on the host once per plan upload), walking the run in
// order until its last flag, and storing the row-block's outputs once with
// a plain store.  There are no atomics, so the result does not change from
// run to run, and y rows of no run keep the caller's zeros.  The sharded
// plans pad a shard with zero blocks on its last row-block with
// first = last = 0: they lie after the last flag of the last run and no CTA
// reads them.  An empty shard's one zero block (first = last = 1) stores
// y[0] = 0.  A run that meets the next first flag before a last flag stores
// nothing, as the TPU grid re-zeroes its accumulator there.  A stream whose
// row-block recurs in two runs (no planner emits one) would race where the
// TPU keeps the later run.
//
// Bound: B5 reads each payload byte once for one multiply-add, so it is
// bound by the bytes of the A stream, as B1 (as block_stream.cuh's
// kernel: a warp reads 128 B of a block row, BH accumulators a thread in
// registers, one shuffle reduction a run).  B6 stages each block's A tile and x rows in
// shared memory (block_stream_batched.cuh; fp32 FMA, no TF32, as the TPU
// kernel's Precision.HIGHEST) over a run.  One CTA per run leaves a long run
// on one SM; making it fast is later work.

#include "block_stream.cuh"
#include "block_stream_batched.cuh"

namespace hispmv {

template <int BH>
__global__ void __launch_bounds__(kLanes)
    block_run_kernel(const float* __restrict__ data,
                     const int* __restrict__ rows,
                     const int* __restrict__ cols,
                     const int* __restrict__ firsts,
                     const int* __restrict__ lasts,
                     const int* __restrict__ starts,
                     const float* __restrict__ x, float* __restrict__ y,
                     int nblocks) {
  __shared__ float red[kWarps][BH];
  const int l = threadIdx.x;
  const int j0 = starts[blockIdx.x];
  float acc[BH];
#pragma unroll
  for (int r = 0; r < BH; ++r) acc[r] = 0.f;
  for (int j = j0; j < nblocks; ++j) {
    if (j != j0 && firsts[j]) return;  // uniform: flags are per block
    const float xv = x[static_cast<size_t>(cols[j]) * kLanes + l];
    const float* ab = data + static_cast<size_t>(j) * BH * kLanes + l;
#pragma unroll
    for (int r = 0; r < BH; ++r) acc[r] = fmaf(ab[r * kLanes], xv, acc[r]);
    if (lasts[j]) {
      flush_tile<BH, true>(acc, y + static_cast<size_t>(rows[j]) * BH, red);
      return;
    }
  }
}

// grid.x = runs, grid.y = panels of kPanel vectors.  Dynamic shared memory:
// (BH*kAStride + 128*(pp+1)) floats.
template <int BH>
__global__ void __launch_bounds__(kBatchThreads)
    block_run_batched_kernel(const float* __restrict__ data,
                             const int* __restrict__ rows,
                             const int* __restrict__ cols,
                             const int* __restrict__ firsts,
                             const int* __restrict__ lasts,
                             const int* __restrict__ starts,
                             const float* __restrict__ x,
                             float* __restrict__ y, int nblocks, int batch,
                             int pp) {
  constexpr int kMax = max_outputs<BH>();
  extern __shared__ float smem[];
  const int j0 = starts[blockIdx.x];
  const int b0 = blockIdx.y * kPanel;
  const int live = min(kPanel, batch - b0);  // real columns of the panel
  const OutputMap m = map_outputs<BH>(pp);
  float acc[kMax];
#pragma unroll
  for (int i = 0; i < kMax; ++i) acc[i] = 0.f;
  for (int j = j0; j < nblocks; ++j) {
    if (j != j0 && firsts[j]) return;  // uniform: flags are per block
    accumulate_block<BH>(data, x, j, cols[j], batch, b0, live, pp, m, smem,
                         acc);
    if (lasts[j]) {
      store_outputs<BH>(acc, m, y + static_cast<size_t>(rows[j]) * BH * batch,
                        batch, b0, live);
      return;
    }
  }
}

template <int BH>
cudaError_t launch_run_batched_bh(const float* data, const int* rows,
                                  const int* cols, const int* firsts,
                                  const int* lasts, const int* starts,
                                  const float* x, float* y, dim3 grid,
                                  int nblocks, int batch, int pp,
                                  cudaStream_t stream) {
  auto kernel = block_run_batched_kernel<BH>;
  const size_t smem =
      (static_cast<size_t>(BH) * kAStride + kLanes * (pp + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kBatchThreads, smem, stream>>>(
      data, rows, cols, firsts, lasts, starts, x, y, nblocks, batch, pp);
  return cudaGetLastError();
}

}  // namespace hispmv

extern "C" {

// data f32 [nblocks, bh, 128]; rows/cols/firsts/lasts i32 [nblocks];
// starts i32 [nruns] (the indices j with firsts[j] == 1); x f32 [ncb, 128];
// y f32 [nrb, bh] zeroed.  Returns a cudaError_t code (0 on success).
int hispmv_spmv_block(const float* data, const int* rows, const int* cols,
                      const int* firsts, const int* lasts, const int* starts,
                      const float* x, float* y, int nblocks, int nruns,
                      int bh, cudaStream_t stream) {
  if (nblocks <= 0 || nruns <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(nruns), block(hispmv::kLanes);
#define HISPMV_LAUNCH_RUN(BHV)                                           \
  case BHV:                                                              \
    hispmv::block_run_kernel<BHV><<<grid, block, 0, stream>>>(           \
        data, rows, cols, firsts, lasts, starts, x, y, nblocks);         \
    break;
  switch (bh) {
    HISPMV_LAUNCH_RUN(1)
    HISPMV_LAUNCH_RUN(2)
    HISPMV_LAUNCH_RUN(4)
    HISPMV_LAUNCH_RUN(8)
    HISPMV_LAUNCH_RUN(16)
    HISPMV_LAUNCH_RUN(32)
    HISPMV_LAUNCH_RUN(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HISPMV_LAUNCH_RUN
  return static_cast<int>(cudaGetLastError());
}

// As hispmv_spmv_block against `batch` vectors: x f32 [ncb, 128, batch],
// y f32 [nrb, bh, batch] zeroed.
int hispmv_spmv_block_batched(const float* data, const int* rows,
                              const int* cols, const int* firsts,
                              const int* lasts, const int* starts,
                              const float* x, float* y, int nblocks,
                              int nruns, int bh, int batch,
                              cudaStream_t stream) {
  if (nblocks <= 0 || nruns <= 0 || batch <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int npanel = (batch + hispmv::kPanel - 1) / hispmv::kPanel;
  if (npanel > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int panel = batch < hispmv::kPanel ? batch : hispmv::kPanel;
  int pp = 1;
  while (pp < panel) pp <<= 1;
  const dim3 grid(nruns, npanel);
  cudaError_t e;
#define HISPMV_LAUNCH_RUN_BATCHED(BHV)                                     \
  case BHV:                                                                \
    e = hispmv::launch_run_batched_bh<BHV>(data, rows, cols, firsts, lasts, \
                                           starts, x, y, grid, nblocks,    \
                                           batch, pp, stream);             \
    break;
  switch (bh) {
    HISPMV_LAUNCH_RUN_BATCHED(1)
    HISPMV_LAUNCH_RUN_BATCHED(2)
    HISPMV_LAUNCH_RUN_BATCHED(4)
    HISPMV_LAUNCH_RUN_BATCHED(8)
    HISPMV_LAUNCH_RUN_BATCHED(16)
    HISPMV_LAUNCH_RUN_BATCHED(32)
    HISPMV_LAUNCH_RUN_BATCHED(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HISPMV_LAUNCH_RUN_BATCHED
  return static_cast<int>(e);
}

}  // extern "C"
