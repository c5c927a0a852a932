// B3: x-paneled chunked block-ELL SpMV stream on Hopper (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/spmv_chunked.py::
// _chunked_paneled_kernel (wrapper spmv_chunked_paneled_pallas): B1 with x
// cut into column panels of panel_ncb col blocks, chunk c reading panel
// panel_ids[c] (its col ids are local to the panel), and y resident across
// panels, every flush adding into it.  It runs each ring step of the
// sharded chunked executor (dist/shard.py, all panel ids zero, x = the x
// shard the device holds).
//
// The TPU kernel needs panels because x must fit in VMEM; on the card x is
// read from device memory, so a panel is only an offset: B1's kernel
// (block_stream.cuh) with x2d moved by panel_ids[c] * panel_ncb rows per
// chunk.  B1 already flushes by adding into a y the caller zeroed, which is
// B3's contract; the caller may pass a y that holds earlier ring steps.
//
// Bound: bytes of the A stream, as for B1.

#include "block_stream.cuh"

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
  if (data_is_bf16) {
    return hispmv::launch_block_stream<__nv_bfloat16, false, true>(
        data, nullptr, meta, panel_ids, x2d, y, nchunks, chunk, bh, panel_ncb,
        stream);
  }
  return hispmv::launch_block_stream<float, false, true>(
      data, nullptr, meta, panel_ids, x2d, y, nchunks, chunk, bh, panel_ncb,
      stream);
}

}  // extern "C"
