// B2: chunked block-ELL stream against B vectors on Hopper (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_chunked.py::
// _chunked_batched_kernel (wrapper spmv_chunked_batched_pallas): B1's
// block stream with acc[bh, B] += A_blk(bh, 128) @ X[cb](128, B) per block
// at fp32, on the same packed arrays:
//   data [nchunks, chunk*bh, 128] f32 or bf16, meta [nchunks, 2, chunk] i32
//   (row_block*2 + last, col block), xb [ncb, 128, B] f32 (x[cb*128 + l] of
//   vector b at xb[cb, l, b]), y [nrb, bh, B] f32 zeroed by the caller.
// It runs the block format's linear() within the budget, the ELLX overflow
// of linear() and the row-granular ELLX residual of a routed linear().
//
// Design: block_vec.cuh's chunked_vec_kernel in x-row mode kCol (lane l
// of block k reads x row cb), which B1 runs at one vector: V vectors a
// thread, acc[R][V] in registers, no shared-memory staging, a grid of equal
// block ranges x row slices x vector groups filling one wave, and a flush
// by recursive halving across the warp.  __launch_bounds__(128, 4) caps a
// thread at 128 registers: R 8, V 8 takes 123-128 (4 CTAs an SM, 528 on an
// H100 SXM), R 8, V 4 88-96 (5), without spills.  Issuing the next block's
// loads before the current block's FMAs was faster on an H100 SXM than
// loading each block where it is used.
//
// Bound: at small B the payload bytes (HBM, read once by the one vector
// group); at large B the re-reads of A by ceil(B/V) groups (from L2) and
// the FMAs (R*V a payload value).  V is 8, so a payload value read feeds 8
// FMAs and a trans5-like stream at B 8 reads its payload once (V 8 beat V 4
// at B 8 and 64 on an H100 SXM); 1 at B 1 (as B1), 4 at B 2-4, and when
// V 8 would leave SMs without a CTA (pick_v).

#include <cstdint>

#include "block_vec.cuh"

extern "C" {

// data: f32 (data_is_bf16 == 0) or bf16 [nchunks, chunk*bh, 128];
// meta i32 [nchunks, 2, chunk]; xb f32 [ncb, 128, batch];
// y f32 [nrb, bh, batch] zeroed; vpt 0 lets the launcher pick V (pick_v),
// 1, 4 or 8 names it.  Returns a cudaError_t code.
int hispmv_spmv_chunked_batched(const void* data, int data_is_bf16,
                                const int* meta, const float* xb, float* y,
                                int nchunks, int chunk, int bh, int batch,
                                int vpt, cudaStream_t stream) {
  const bool vec4 =
      batch % 4 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0;
  if (data_is_bf16) {
    return hispmv::launch_vec_stream<__nv_bfloat16, hispmv::XRow::kCol>(
        data, nullptr, meta, xb, y, nchunks, chunk, bh, batch, vpt, vec4,
        nullptr, stream);
  }
  return hispmv::launch_vec_stream<float, hispmv::XRow::kCol>(
      data, nullptr, meta, xb, y, nchunks, chunk, bh, batch, vpt, vec4,
      nullptr, stream);
}

// The launch shape of hispmv_spmv_chunked_batched for these sizes (f32
// payload, 16-byte x loads when batch % 4 == 0): out = {V, row slices,
// CTAs}.  Returns a cudaError_t code (cudaErrorInvalidValue for what the
// launcher refuses).
int hispmv_spmv_chunked_batched_grid(int nchunks, int chunk, int bh,
                                     int batch, int vpt, int* out) {
  return hispmv::vec_stream_grid<hispmv::XRow::kCol>(nchunks, chunk, bh,
      batch, vpt, out);
}

}  // extern "C"
