// B8: windowed block-ELL stream against B vectors on Hopper (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_windowed.py::
// _windowed_batched_kernel (wrapper spmv_windowed_batched_pallas): B7's
// gather per vector, lane l of block k reading x row win*8 + subidx[k, l]
// of the block's window, then acc[bh, B] += A_blk(bh, 128) @ Xg(128, B) at
// fp32, on the packed arrays of B7:
//   data [nchunks, chunk*bh, 128] f32 or bf16, subidx [nchunks, chunk, 128]
//   i32, meta [nchunks, 2, chunk] i32 (row_block*2 + last, window), xt
//   [nwin*8, 128, B] f32 (x[s*128 + l] of vector b at xt[s, l, b]: vector
//   minor, as B2's and B10's x), y [nrb, bh, B] f32 zeroed by the caller.
// It runs the window format's linear(), which is the MLP's fc3 at full
// width.
//
// Design: B2's kernel, block_vec.cuh's chunked_vec_kernel with kWindowed
// true: the same stream, grid and flush, with lane l's x row taken from
// its subidx word.  The word of block k+2 is loaded with block k+2's meta
// words, before block k's FMAs, so block k+1's x loads never wait on it.
// A lane reads V contiguous floats of its row (16-byte loads at B % 4 ==
// 0), where the staged design it replaces read one float per (lane,
// vector) from x packed [nwin*8, B*128].
//
// Bound: as B2, plus the subidx sideband (128 ints a block: 1/bh of the
// payload words), which every row slice and vector group re-reads.  The x
// rows of a window (8 x 128 x B floats) stay in L1/L2 while its blocks
// stream.  A window plan with few blocks a row-block flushes often: at
// crystk03's 2.1 (a banded matrix, bh 8) each block's 64 FMAs a thread
// meet a flush's 62 shuffles, barrier and atomics every other block, and
// a block took about 1.7x as long as on the MLP's fc3 (63 blocks a
// row-block) on an H100 SXM.

#include <cstdint>

#include "block_vec.cuh"

extern "C" {

// data: f32 (data_is_bf16 == 0) or bf16 [nchunks, chunk*bh, 128];
// subidx i32 [nchunks, chunk, 128]; meta i32 [nchunks, 2, chunk];
// xt f32 [nwin*8, 128, batch]; y f32 [nrb, bh, batch] zeroed; vpt 0 lets
// the launcher pick V (pick_v), 4 or 8 names it.  Returns a cudaError_t
// code.
int hispmv_spmv_windowed_batched(const void* data, int data_is_bf16,
                                 const int* subidx, const int* meta,
                                 const float* xt, float* y, int nchunks,
                                 int chunk, int bh, int batch, int vpt,
                                 cudaStream_t stream) {
  const bool vec4 =
      batch % 4 == 0 && reinterpret_cast<uintptr_t>(xt) % 16 == 0;
  if (data_is_bf16) {
    return hispmv::launch_vec_stream<__nv_bfloat16, true>(
        data, subidx, meta, xt, y, nchunks, chunk, bh, batch, vpt, vec4,
        nullptr, stream);
  }
  return hispmv::launch_vec_stream<float, true>(
      data, subidx, meta, xt, y, nchunks, chunk, bh, batch, vpt, vec4,
      nullptr, stream);
}

// The launch shape of hispmv_spmv_windowed_batched for these sizes (f32
// payload, 16-byte x loads when batch % 4 == 0): out = {V, row slices,
// CTAs}.  Returns a cudaError_t code (cudaErrorInvalidValue for what the
// launcher refuses).
int hispmv_spmv_windowed_batched_grid(int nchunks, int chunk, int bh,
                                      int batch, int vpt, int* out) {
  return hispmv::vec_stream_grid<true>(nchunks, chunk, bh, batch, vpt, out);
}

}  // extern "C"
