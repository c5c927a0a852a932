// B1: chunked block-ELL SpMV stream on Hopper (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_chunked.py::_chunked_kernel
// (wrapper spmv_chunked_pallas): a stream of (bh, 128) blocks sorted by
// row-block; per block acc += A_blk * x2d[cb]; on a last-flagged block
// y[rb] = rowsum(acc).  It runs the block format and the ELLX overflow
// stream.
//
// Design: B2 at one vector.  x2d [ncb, 128] is B2's xb [ncb, 128, 1] and y
// [nrb, bh] is its y [nrb, bh, 1], so B1 launches block_vec.cuh's
// chunked_vec_kernel in x-row mode kCol at batch 1 and V 1 (acc[R][1]):
// a thread owns a lane and R = min(bh, 8) rows of each block, the stream
// is cut into equal ranges of blocks (crossing chunks) until the grid
// holds one wave of resident CTAs, and a flush reduces R values across the
// warp by recursive halving.  The design it replaces ran one CTA a chunk,
// 107-181 CTAs on 132 SMs for the suite's matrices.
//
// Bound: bytes of the A stream.  Every payload byte is read once and used
// for one multiply-add, so at fp32 the kernel does 0.5 flop per byte, far
// below the card's balance point; x2d (ncb*512 B) is re-read per block but
// stays in L2 for the matrices of the suite.  The payload is read
// coalesced (a warp reads 128 B a block row) and the accumulator stays in
// registers, with the next block's loads issued before the current
// block's FMAs.

#include "block_vec.cuh"

extern "C" {

// data: f32 (data_is_bf16 == 0) or bf16 [nchunks, chunk*bh, 128];
// meta i32 [nchunks, 2, chunk]; x2d f32 [ncb, 128]; y f32 [nrb, bh] zeroed;
// vpt 0 lets the launcher pick V (pick_v), 1, 4 or 8 names it.  Returns a
// cudaError_t code (0 on success).
int hispmv_spmv_chunked(const void* data, int data_is_bf16, const int* meta,
                        const float* x2d, float* y, int nchunks, int chunk,
                        int bh, int vpt, cudaStream_t stream) {
  if (data_is_bf16) {
    return hispmv::launch_vec_stream<__nv_bfloat16, hispmv::XRow::kCol>(
        data, nullptr, meta, x2d, y, nchunks, chunk, bh, 1, vpt, false,
        nullptr, stream);
  }
  return hispmv::launch_vec_stream<float, hispmv::XRow::kCol>(
      data, nullptr, meta, x2d, y, nchunks, chunk, bh, 1, vpt, false,
      nullptr, stream);
}

const char* hispmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
