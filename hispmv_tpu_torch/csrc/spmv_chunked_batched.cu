// B2: chunked block-ELL stream against B vectors on Hopper (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_chunked.py::
// _chunked_batched_kernel (wrapper spmv_chunked_batched_pallas): B1's
// block stream, with acc[bh, B] += A_blk(bh, 128) @ X[cb](128, B) per block
// at fp32.  It runs the block format's linear(), the ELLX overflow of
// linear() and the row-granular ELLX residual of a routed linear().
//
// Bound: at B = 64 each A value feeds 64 FMAs (16 per payload byte at
// fp32), so fp32 FMA throughput and shared-memory traffic set the pace, not
// HBM.  The design (block_stream_batched.cuh) stages each block's A tile
// and x rows in shared memory once per panel of 64 vectors, reuses each
// staged x value across a thread's rows, and cuts chunks into ranges so
// that every SM holds several CTAs.  Double-buffered tiles (cp.async or
// TMA) and a register-tiled product are later work.

#include "block_stream_batched.cuh"

extern "C" {

// data: f32 (data_is_bf16 == 0) or bf16 [nchunks, chunk*bh, 128];
// meta i32 [nchunks, 2, chunk]; xb f32 [ncb, 128, batch];
// y f32 [nrb, bh, batch] zeroed.  Returns a cudaError_t code.
int hispmv_spmv_chunked_batched(const void* data, int data_is_bf16,
                                const int* meta, const float* xb, float* y,
                                int nchunks, int chunk, int bh, int batch,
                                cudaStream_t stream) {
  if (data_is_bf16) {
    return hispmv::launch_block_stream_batched<__nv_bfloat16, false>(
        data, nullptr, meta, xb, y, nchunks, chunk, bh, batch, stream);
  }
  return hispmv::launch_block_stream_batched<float, false>(
      data, nullptr, meta, xb, y, nchunks, chunk, bh, batch, stream);
}

}  // extern "C"
