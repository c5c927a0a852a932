// B8: windowed block-ELL stream against B vectors on Hopper (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_windowed.py::
// _windowed_batched_kernel (wrapper spmv_windowed_batched_pallas): B7's
// gather per batch column, x_b[win*1024 + subidx[j, l]*128 + l] read from
// the packed [nwin*8, B*128] layout (pack_batch_x), then
// (bh, 128) x (B, 128)^T at fp32.  It runs the window format's linear(),
// which is the MLP's fc3 at full width.
//
// Bound: as B2, fp32 FMA throughput and shared-memory traffic at B = 64
// (16 FMAs per payload byte); the sub-index sideband adds 1/bh to the
// stream.  The x gather reads, per block and vector, one lane from each of up to 8 rows
// of the window's 1024 columns, which stay in L1/L2.  Design as B2
// (block_stream_batched.cuh): the gathered x rows are staged in shared
// memory once per panel of 64 vectors.

#include "block_stream_batched.cuh"

extern "C" {

// data: f32 (data_is_bf16 == 0) or bf16 [nchunks, chunk*bh, 128];
// subidx i32 [nchunks, chunk, 128]; meta i32 [nchunks, 2, chunk];
// x_packed f32 [nwin*8, batch*128]; y f32 [nrb, bh, batch] zeroed.
// Returns a cudaError_t code.
int hispmv_spmv_windowed_batched(const void* data, int data_is_bf16,
                                 const int* subidx, const int* meta,
                                 const float* x_packed, float* y,
                                 int nchunks, int chunk, int bh, int batch,
                                 cudaStream_t stream) {
  if (data_is_bf16) {
    return hispmv::launch_block_stream_batched<__nv_bfloat16, true>(
        data, subidx, meta, x_packed, y, nchunks, chunk, bh, batch, stream);
  }
  return hispmv::launch_block_stream_batched<float, true>(
      data, subidx, meta, x_packed, y, nchunks, chunk, bh, batch, stream);
}

}  // extern "C"
