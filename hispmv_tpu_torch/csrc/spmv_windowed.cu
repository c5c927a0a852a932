// B7: windowed block-ELL SpMV stream on Hopper (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_windowed.py::_windowed_kernel
// (wrapper spmv_windowed_pallas): B1, except that lane l of a block's x row
// is x2d[win*8 + subidx[j, l], l], one of the 8 column segments of the
// block's 1024-column window (plan/windows.py).  It runs the window format.
//
// Bound: bytes of the A stream plus its sub-index sideband (bh*512 + 512 B
// per block at fp32, so the sideband adds 1/bh).  The x gather touches one
// 4 KiB window per block and stays in L1/L2.  Same design as B1 (see
// block_stream.cuh): coalesced payload and sub-index reads, accumulator in
// registers, atomic flushes.

#include "block_stream.cuh"

extern "C" {

// data: f32 (data_is_bf16 == 0) or bf16 [nchunks, chunk*bh, 128];
// subidx i32 [nchunks, chunk, 128]; meta i32 [nchunks, 2, chunk];
// x2d f32 [nwin*8, 128]; y f32 [nrb, bh] zeroed.
// Returns a cudaError_t code (0 on success).
int hispmv_spmv_windowed(const void* data, int data_is_bf16,
                         const int* subidx, const int* meta,
                         const float* x2d, float* y, int nchunks, int chunk,
                         int bh, cudaStream_t stream) {
  if (data_is_bf16) {
    return hispmv::launch_block_stream<__nv_bfloat16, true>(
        data, subidx, meta, nullptr, x2d, y, nchunks, chunk, bh, 0, stream);
  }
  return hispmv::launch_block_stream<float, true>(
      data, subidx, meta, nullptr, x2d, y, nchunks, chunk, bh, 0, stream);
}

}  // extern "C"
