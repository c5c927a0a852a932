// B1: chunked block-ELL SpMV stream on Hopper (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_chunked.py::_chunked_kernel
// (wrapper spmv_chunked_pallas): a stream of (bh, 128) blocks sorted by
// row-block; per block acc += A_blk * x2d[cb]; on a last-flagged block
// y[rb] = rowsum(acc).  It runs the block format and the ELLX overflow
// stream.
//
// Bound: bytes of the A stream.  Every payload byte is read once and used
// for one multiply-add, so at fp32 the kernel does 0.5 flop per byte, far
// below the card's balance point; x2d (ncb*512 B) is re-read per block but
// stays in L2 for the matrices of the suite.  The design reads the stream
// coalesced (a warp reads 128 B per block row) and keeps the accumulator
// in registers; see block_stream.cuh.  Making it fast (wide loads, TMA,
// more CTAs than chunks) is later work.

#include "block_stream.cuh"

extern "C" {

// data: f32 (data_is_bf16 == 0) or bf16 [nchunks, chunk*bh, 128];
// meta i32 [nchunks, 2, chunk]; x2d f32 [ncb, 128]; y f32 [nrb, bh] zeroed.
// Returns a cudaError_t code (0 on success).
int hispmv_spmv_chunked(const void* data, int data_is_bf16, const int* meta,
                        const float* x2d, float* y, int nchunks, int chunk,
                        int bh, cudaStream_t stream) {
  if (data_is_bf16) {
    return hispmv::launch_block_stream<__nv_bfloat16, false>(
        data, nullptr, meta, nullptr, x2d, y, nchunks, chunk, bh, 0, stream);
  }
  return hispmv::launch_block_stream<float, false>(
      data, nullptr, meta, nullptr, x2d, y, nchunks, chunk, bh, 0, stream);
}

const char* hispmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
