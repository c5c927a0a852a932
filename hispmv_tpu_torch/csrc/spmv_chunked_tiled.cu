// B4: x- and y-paneled ("tiled") chunked block-ELL SpMV stream on Hopper
// (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_chunked.py::
// _chunked_tiled_kernel (wrapper spmv_chunked_tiled_pallas): blocks sorted
// by (row panel, col panel, row block) in chunks that never straddle a
// (row panel, col panel) pair; chunk c reads x panel xpanel_ids[c] (its col
// ids local to the x panel) and adds into y panel ypanel_ids[c] (its row
// ids local to the y panel).  The handle runs it for a block matrix whose x
// and y both exceed the TPU's VMEM budget (api/handle.py): every square
// block matrix past about 1.05 M rows.
//
// The TPU needs the panels because neither vector fits in VMEM; on the card
// both are read from device memory, so each panel is only an offset.
// Design: B3 with a row panel too, block_vec.cuh's chunked_vec_kernel in
// x-row mode kTile at batch 1 and V 1: the meta cursor (two blocks ahead of
// the FMAs) holds both offsets of its chunk, xpanel_ids[c] * panel_ncb for
// the x row and ypanel_ids[c] * panel_nrb for the row block, reloaded at
// each chunk it enters.  A thread owns a lane and R = min(bh, 8) rows of
// each block, the stream is cut into equal ranges of blocks (crossing
// chunks and panels) until the grid holds one wave of resident CTAs, and a
// flush reduces R values across the warp by recursive halving.  The TPU
// zeroes a y panel at its first chunk (yfirst) because its grid runs in
// order; here ranges of one row panel run in parallel, so the caller zeroes
// the whole y once before the launch and the kernel never reads yfirst.
// Row panels with no chunk stay zero (the TPU leaves them unwritten).
// Padding blocks carry a zero payload, sector mask 0, last = 0 and the
// segment's last local row, so they read no payload and add zeros.
//
// Bound: bytes.  The planner's (8, 128) tiles of a matrix like Flan_1565
// are about 22% full and the kernel does 0.5 flop a payload byte at fp32,
// so the payload as packed would bound it above cuSPARSE's CSR product.
// The zeros lie in whole 32-byte sectors (46% of the sectors hold a
// nonzero there), so in mode kTile a thread loads its payload value only
// when its 8-lane granule's bit in the row's sector mask (made once at
// upload, one 16-bit word a payload row) is set: a warp asks only for the
// live sectors, and the kernel reads about half the packed payload.  x is
// re-read per block and mostly hits L2.

#include "block_vec.cuh"

extern "C" {

// data: f32 (data_is_bf16 == 0) or bf16 [nchunks, chunk*bh, 128];
// sector_mask u16 [nchunks, chunk*bh] (16-byte aligned); meta i32
// [nchunks, 2, chunk]; xpanel_ids / ypanel_ids i32 [nchunks];
// x2d f32 [npanels_x*panel_ncb, 128]; y f32 [npanels_y*panel_nrb, bh],
// zeroed.  Returns a cudaError_t code (0 on success).
int hispmv_spmv_chunked_tiled(const void* data, int data_is_bf16,
                              const unsigned short* sector_mask,
                              const int* meta, const int* xpanel_ids,
                              const int* ypanel_ids, const float* x2d,
                              float* y, int nchunks, int chunk, int bh,
                              int panel_ncb, int panel_nrb,
                              cudaStream_t stream) {
  if (sector_mask == nullptr || xpanel_ids == nullptr ||
      ypanel_ids == nullptr || panel_ncb <= 0 || panel_nrb <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using hispmv::XRow;
  if (data_is_bf16) {
    return hispmv::launch_vec_stream<__nv_bfloat16, XRow::kTile>(
        data, nullptr, meta, x2d, y, nchunks, chunk, bh, 1, 1, false,
        nullptr, stream, xpanel_ids, panel_ncb, ypanel_ids, panel_nrb,
        sector_mask);
  }
  return hispmv::launch_vec_stream<float, XRow::kTile>(
      data, nullptr, meta, x2d, y, nchunks, chunk, bh, 1, 1, false, nullptr,
      stream, xpanel_ids, panel_ncb, ypanel_ids, panel_nrb, sector_mask);
}

// The launch shape of hispmv_spmv_chunked_tiled for these sizes (f32
// payload): out = {V, row slices, CTAs}.  Returns a cudaError_t code
// (cudaErrorInvalidValue for what the launcher refuses).
int hispmv_spmv_chunked_tiled_grid(int nchunks, int chunk, int bh,
                                   int* out) {
  return hispmv::vec_stream_grid<hispmv::XRow::kTile>(nchunks, chunk, bh, 1,
                                                      1, out);
}

}  // extern "C"
