// B3: x-paneled chunked block-ELL SpMV stream on Hopper (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_chunked.py::
// _chunked_paneled_kernel (wrapper spmv_chunked_paneled_pallas): B1 with x
// cut into column panels of panel_ncb col blocks, chunk c reading panel
// panel_ids[c] (its col ids are local to the panel), and y resident across
// panels, every flush adding into it.  Chunks never straddle a panel; each
// panel's segment is padded to whole chunks with zero blocks that carry its
// last row-block and no last flag.  It runs the x-paneled block layout's
// run() and each ring step of the sharded chunked executor (dist/shard.py:
// all panel ids zero, x the shard the device holds, y holding the earlier
// steps).
//
// The TPU kernel needs panels because x must fit in VMEM; on the card x is
// read from device memory, so a panel is only an offset of the x row.
// Design: B1 with that offset, block_vec.cuh's chunked_vec_kernel in x-row
// mode kPanel at batch 1 and V 1: block k reads x row panel_ids[k / chunk]
// * panel_ncb + col, the panel offset held by the meta cursor (two blocks
// ahead of the FMAs) and reloaded at each chunk it enters.  A thread owns
// a lane and R = min(bh, 8) rows of each block, the stream is cut into
// equal ranges of blocks (crossing chunks and panels) until the grid holds
// one wave of resident CTAs, and a flush reduces R values across the warp
// by recursive halving.  Every (panel, row-block) run ends last-flagged, so
// nothing stays open where the stream enters a new panel.  The kernel only
// adds into y, which is B3's contract.  A grid of one CTA a chunk left
// most of the card idle: a ring step at D 4 is a few dozen chunks.
//
// Bound: bytes of the A stream, as for B1 (0.5 flop a payload byte at
// fp32); x is re-read per block and mostly hits L2.

#include "block_vec.cuh"

extern "C" {

// data: f32 (data_is_bf16 == 0) or bf16 [nchunks, chunk*bh, 128];
// meta i32 [nchunks, 2, chunk]; panel_ids i32 [nchunks];
// x2d f32 [npanels*panel_ncb, 128]; y f32 [nrb, bh], added into.
// Returns a cudaError_t code (0 on success).
int hispmv_spmv_chunked_paneled(const void* data, int data_is_bf16,
                                const int* meta, const int* panel_ids,
                                const float* x2d, float* y, int nchunks,
                                int chunk, int bh, int panel_ncb,
                                cudaStream_t stream) {
  if (panel_ids == nullptr || panel_ncb <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using hispmv::XRow;
  if (data_is_bf16) {
    return hispmv::launch_vec_stream<__nv_bfloat16, XRow::kPanel>(
        data, nullptr, meta, x2d, y, nchunks, chunk, bh, 1, 1, false,
        nullptr, stream, panel_ids, panel_ncb);
  }
  return hispmv::launch_vec_stream<float, XRow::kPanel>(
      data, nullptr, meta, x2d, y, nchunks, chunk, bh, 1, 1, false, nullptr,
      stream, panel_ids, panel_ncb);
}

// The launch shape of hispmv_spmv_chunked_paneled for these sizes (f32
// payload): out = {V, row slices, CTAs}.  Returns a cudaError_t code
// (cudaErrorInvalidValue for what the launcher refuses).
int hispmv_spmv_chunked_paneled_grid(int nchunks, int chunk, int bh,
                                     int* out) {
  return hispmv::vec_stream_grid<hispmv::XRow::kPanel>(nchunks, chunk, bh, 1,
                                                       1, out);
}

}  // extern "C"
