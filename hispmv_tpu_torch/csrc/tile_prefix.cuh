// Shared device code of the tile kernels that take run sums as prefix
// differences (spmv_routed.cu: B9 in fp64, B10 in fp32; B13 in
// spmv_gathered.cu scans four slots a thread with its own code): the
// inclusive prefix of one value per thread over a CTA of 1024 threads, in
// thread order (the tile's flat slot order s*128 + j).
//
// The TPU builds this prefix from triangular MXU matmuls (in a bf16x3
// split); here it is a warp-shuffle scan plus a scan of the 32 warp totals.

#pragma once

#include <cuda_runtime.h>

namespace hispmv {

// Inclusive prefix of p over the CTA's threads, stored to s_pf[threadIdx.x]
// (s_warp holds 32 values).  All 1024 threads call it together; the caller
// syncs before reading another thread's s_pf entry.
template <typename T>
__device__ __forceinline__ void tile_prefix(T p, T* s_warp, T* s_pf) {
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, p, d);
    if (lane >= d) p += n;
  }
  if (lane == 31) s_warp[warp] = p;
  __syncthreads();
  if (warp == 0) {
    T w = s_warp[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T n = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += n;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  if (warp > 0) p += s_warp[warp - 1];
  s_pf[i] = p;
}

}  // namespace hispmv
