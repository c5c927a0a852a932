// B7: windowed block-ELL SpMV stream on Hopper (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_windowed.py::_windowed_kernel
// (wrapper spmv_windowed_pallas): B1, except that lane l of a block's x row
// is x2d[win*8 + subidx[j, l], l], one of the 8 column segments of the
// block's 1024-column window (plan/windows.py).  It runs the window format
// and each shard of the sharded window executor.
//
// Design: B8 at one vector, as B1 is B2 at one vector.  x2d [nwin*8, 128]
// is B8's xt [nwin*8, 128, 1], so B7 launches block_vec.cuh's
// chunked_vec_kernel in x-row mode kWindow at batch 1 and V 1: a grid of
// equal block ranges filling one wave, block k+2's subidx word fetched
// with its meta words before block k's FMAs, and a flush of R values by
// recursive halving across the warp.  The design it replaces ran one CTA a
// chunk.  A window plan of a banded matrix flushes often (crystk03 every
// 2.1 blocks at bh 8), so the flush's cost at R values sets much of the
// time.
//
// Bound: bytes of the A stream plus its sub-index sideband (bh*512 + 512 B
// per block at fp32, so the sideband adds 1/bh; each of bh/8 row slices
// re-reads it).  The x gather touches one 4 KiB window per block and stays
// in L1/L2.

#include "block_vec.cuh"

extern "C" {

// data: f32 (data_is_bf16 == 0) or bf16 [nchunks, chunk*bh, 128];
// subidx i32 [nchunks, chunk, 128]; meta i32 [nchunks, 2, chunk];
// x2d f32 [nwin*8, 128]; y f32 [nrb, bh] zeroed; vpt 0 lets the launcher
// pick V (pick_v), 1, 4 or 8 names it.  Returns a cudaError_t code (0 on
// success).
int hispmv_spmv_windowed(const void* data, int data_is_bf16,
                         const int* subidx, const int* meta,
                         const float* x2d, float* y, int nchunks, int chunk,
                         int bh, int vpt, cudaStream_t stream) {
  if (data_is_bf16) {
    return hispmv::launch_vec_stream<__nv_bfloat16, hispmv::XRow::kWindow>(
        data, subidx, meta, x2d, y, nchunks, chunk, bh, 1, vpt, false,
        nullptr, stream);
  }
  return hispmv::launch_vec_stream<float, hispmv::XRow::kWindow>(
      data, subidx, meta, x2d, y, nchunks, chunk, bh, 1, vpt, false, nullptr,
      stream);
}

}  // extern "C"
