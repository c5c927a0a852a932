// B11: one within-window permutation stage on Hopper (sm_90a).
//
// Replaces the TPU kernel hispmv_tpu/ops/permute.py::_permute_kernel
// (wrapper permute_stage_pallas).  Input, output and the route word are
// [nwin, 8, 128] (one (8,128) window = 1024 elements each); the route word
// of cell (s, j) is subA | laneB<<3 | subC<<10 (plan/permute.py
// WindowStage).  The TPU applies three gathers in turn: a[r][j] =
// in[subA[r][j]][j], b[r][j] = a[r][laneB[r][j]], out[s][j] =
// b[subC[s][j]][j].  Composed, each output element is ONE read:
//   c = subC[s][j], L = laneB[c][j], r = subA[c][L], out[s][j] = in[r][L].
// A permutation does no arithmetic, so the result equals the plain version
// bit for bit.
//
// Design.  One CTA of 1024 threads per window: the window's route words and
// values are loaded coalesced into shared memory, each thread resolves its
// composed index there and writes its element coalesced.  Bound: bytes, 12
// per element (route, in, out), all streamed once.  The full permutation is
// S1 -> transpose -> S2 -> transpose -> S3 (ops/permute.py); the
// transposes stay plain torch, as the JAX package leaves them to XLA.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWindow = 1024;  // elements per window == threads per CTA

__global__ void __launch_bounds__(kWindow)
    permute_window_kernel(const int* __restrict__ route,
                          const float* __restrict__ in,
                          float* __restrict__ out) {
  __shared__ unsigned s_route[kWindow];
  __shared__ float s_in[kWindow];
  const int i = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * kWindow + i;
  s_route[i] = static_cast<unsigned>(route[off]);
  s_in[i] = in[off];
  __syncthreads();
  const int j = i & 127;
  const int c = (s_route[i] >> 10) & 7;
  const int L = (s_route[(c << 7) + j] >> 3) & 127;
  const int r = s_route[(c << 7) + L] & 7;
  out[off] = s_in[(r << 7) + L];
}

}  // namespace

extern "C" {

// route i32, in / out f32, each [nwin, 8, 128].  Returns a cudaError_t code.
int hispmv_permute_stage(const int* route, const float* in, float* out,
                         int nwin, cudaStream_t stream) {
  if (nwin <= 0) return static_cast<int>(cudaErrorInvalidValue);
  permute_window_kernel<<<nwin, kWindow, 0, stream>>>(route, in, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
