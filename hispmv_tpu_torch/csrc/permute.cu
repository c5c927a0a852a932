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
// Design.  The composed read crosses rows, so a window's route words and
// values sit in shared memory (8 KB a window).  256 threads a window, each
// loading its four consecutive route words as one int4 and its four values
// as one float4, then (after one barrier) resolving its four composed
// reads there (subC from its own words, in registers) and writing one
// float4.  A CTA takes kWindows windows (a template parameter;
// HISPMV_PERMUTE_WINDOWS picks the instance that is built), the last CTA
// masking windows past nwin.  At 256 threads and 8 KB a window, eight
// windows are resident an SM (the 2,048-thread cap), so 1,024 windows run
// in one wave.  route and in must be 16-byte aligned (the wrapper checks).
// Bound: bytes, 12 per element (route, in, out), all streamed once.  The
// full permutation is S1 -> transpose -> S2 -> transpose -> S3
// (ops/permute.py); the transposes stay plain torch, as the JAX package
// leaves them to XLA.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#ifndef HISPMV_PERMUTE_WINDOWS
#define HISPMV_PERMUTE_WINDOWS 1
#endif

namespace {

constexpr int kWindow = 1024;          // elements per window
constexpr int kQuads = kWindow / 4;    // threads per window
constexpr int kWindows = HISPMV_PERMUTE_WINDOWS;  // windows a CTA
static_assert(kWindows >= 1 && kWindows <= 4, "1 to 4 windows a CTA");

// The composed read of element e (= s*128 + j) whose own route word is wd.
__device__ __forceinline__ float composed(const unsigned* s_route,
                                          const float* s_in, int e, int wd) {
  const int j = e & 127;
  const int c = (static_cast<unsigned>(wd) >> 10) & 7;
  const int L = (s_route[(c << 7) + j] >> 3) & 127;
  const int r = s_route[(c << 7) + L] & 7;
  return s_in[(r << 7) + L];
}

template <int kWin>
__global__ void __launch_bounds__(kQuads * kWin)
    permute_window_kernel(const int4* __restrict__ route,
                          const float4* __restrict__ in,
                          float4* __restrict__ out, int nwin) {
  __shared__ __align__(16) unsigned s_route[kWin][kWindow];
  __shared__ __align__(16) float s_in[kWin][kWindow];
  const int w = threadIdx.x / kQuads;
  const int i = threadIdx.x % kQuads;
  const long long win = static_cast<long long>(blockIdx.x) * kWin + w;
  const bool live = win < nwin;
  const size_t off = static_cast<size_t>(win) * kQuads + i;
  int4 wd = make_int4(0, 0, 0, 0);
  if (live) {
    wd = route[off];
    reinterpret_cast<int4*>(s_route[w])[i] = wd;
    reinterpret_cast<float4*>(s_in[w])[i] = in[off];
  }
  __syncthreads();
  if (!live) return;
  const unsigned* sr = s_route[w];
  const float* sv = s_in[w];
  const int e = 4 * i;
  float4 o;
  o.x = composed(sr, sv, e, wd.x);
  o.y = composed(sr, sv, e + 1, wd.y);
  o.z = composed(sr, sv, e + 2, wd.z);
  o.w = composed(sr, sv, e + 3, wd.w);
  out[off] = o;
}

int ctas_for(int nwin) { return (nwin + kWindows - 1) / kWindows; }

}  // namespace

extern "C" {

// route i32, in / out f32, each [nwin, 8, 128]; route and in 16-byte
// aligned.  Returns a cudaError_t code.
int hispmv_permute_stage(const int* route, const float* in, float* out,
                         int nwin, cudaStream_t stream) {
  if (nwin <= 0 || reinterpret_cast<uintptr_t>(route) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(in) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  permute_window_kernel<kWindows><<<ctas_for(nwin), kQuads * kWindows, 0,
                                    stream>>>(
      reinterpret_cast<const int4*>(route),
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
      nwin);
  return static_cast<int>(cudaGetLastError());
}

// B11's launch shape for nwin windows into out[3]: (windows a CTA, threads
// a CTA, CTAs).  Returns a cudaError_t code.
int hispmv_permute_stage_grid(int nwin, int* out) {
  if (nwin <= 0) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = kWindows;
  out[1] = kQuads * kWindows;
  out[2] = ctas_for(nwin);
  return 0;
}

}  // extern "C"
