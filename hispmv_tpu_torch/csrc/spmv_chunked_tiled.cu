// B4: x- and y-paneled ("tiled") chunked block-ELL SpMV stream on Hopper
// (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_chunked.py::
// _chunked_tiled_kernel (wrapper spmv_chunked_tiled_pallas): blocks sorted
// by (row panel, col panel, row block) in chunks that never straddle a
// (row panel, col panel) pair; chunk c reads x panel xpanel_ids[c] (its col
// ids local to the x panel) and adds into y panel ypanel_ids[c] (its row
// ids local to the y panel).  The handle runs it for a block matrix whose x
// and y both exceed the TPU's VMEM budget (api/handle.py).
//
// The TPU needs the panels because neither vector fits in VMEM; on the card
// both are read from device memory, so each panel is only an offset:
// block_stream.cuh's one-CTA-a-chunk kernel, which serves B4 alone, with
// x2d moved by xpanel_ids[c] * panel_ncb rows and y by ypanel_ids[c] *
// panel_nrb row-blocks.  B1, B2, B3, B7 and B8 run block_vec.cuh's
// lane-per-thread grid instead; B4, already near its byte bound on an H100
// SXM with one CTA a chunk, stays here.
// The TPU zeroes a y panel at its first chunk (yfirst) because its grid
// runs in order; here chunks of one row panel run in parallel, so zeroing
// inside the kernel would race with other CTAs' adds.  The caller zeroes
// the whole y once before the launch and the kernel never reads yfirst.
// Row panels with no chunk stay zero (the TPU leaves them unwritten).
// Padding blocks carry a zero payload, last = 0 and the segment's last
// local row, so they only add zeros.
//
// Bound: bytes of the A stream, as for B1.

#include "block_stream.cuh"

extern "C" {

// data: f32 (data_is_bf16 == 0) or bf16 [nchunks, chunk*bh, 128];
// meta i32 [nchunks, 2, chunk]; xpanel_ids / ypanel_ids i32 [nchunks];
// x2d f32 [npanels_x*panel_ncb, 128]; y f32 [npanels_y*panel_nrb, bh],
// zeroed.  Returns a cudaError_t code (0 on success).
int hispmv_spmv_chunked_tiled(const void* data, int data_is_bf16,
                              const int* meta, const int* xpanel_ids,
                              const int* ypanel_ids, const float* x2d,
                              float* y, int nchunks, int chunk, int bh,
                              int panel_ncb, int panel_nrb,
                              cudaStream_t stream) {
  if (xpanel_ids == nullptr || ypanel_ids == nullptr || panel_ncb <= 0 ||
      panel_nrb <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (data_is_bf16) {
    return hispmv::launch_block_stream<__nv_bfloat16>(
        data, meta, xpanel_ids, ypanel_ids, x2d, y, nchunks, chunk, bh,
        panel_ncb, panel_nrb, stream);
  }
  return hispmv::launch_block_stream<float>(
      data, meta, xpanel_ids, ypanel_ids, x2d, y, nchunks, chunk, bh,
      panel_ncb, panel_nrb, stream);
}

}  // extern "C"
