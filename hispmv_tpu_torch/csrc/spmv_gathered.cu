// B12 and B13: the gathered executor of the routed format's side-plan on
// Hopper (sm_90a): the S1 x gather (B12) and the tile kernel (B13).  S2
// and S3 of the gather are B11 (permute.cu); ops/spmv_gathered.py strings
// the four launches together.
//
// B12 replaces the TPU kernel hispmv_tpu/ops/spmv_gathered.py::_s1_kernel
// (wrapper s1_gather_pallas).  Arrays: words i32 [P*K, 8, 128] (window
// p*K + k of panel p), x2d f32 [K*8, 128], out f32 [P*K, 8, 128].  Window
// p*K + k reads x window k.  Per cell (s, j) of a window, all shifts
// logical: L = word[s][j] & 127, rank = (word[s][j] >> 7) & 3, sub =
// (word[s][L] >> (16 + 3*rank)) & 7, out[s][j] = x window k [sub][L].  The
// sub field is read at the GATHERED lane L, as the TPU's two composed
// take_along_axis calls read it; the TPU selects among S1_CAP = 4 layers by
// rank, a GPU thread reads its own layer's field directly.  A gather does
// no arithmetic, so the result equals the plain version bit for bit.
// Design: one CTA of 1024 threads per window; the window's words go to
// shared memory (each thread reads one other cell there), the x read is
// one scattered 4-byte load that mostly hits L2 (the K x windows are
// re-read by every panel).  Bound: bytes, 12 per slot (word, x, out).
//
// B13 replaces the TPU kernel hispmv_tpu/ops/spmv_gathered.py::
// _gathered_kernel (wrapper spmv_gathered_tiles_pallas).  Arrays: vals f32
// and word i32 [Tp, 8, 128], byt i32 [Tp], xg f32 [xg_rows, 128] (rows
// past xg_rows read as 0: the TPU pads xg to whole chunks), y f32
// [y_tiles*8, 128] zeroed by the caller.  Per tile t: p = vals * xg; P =
// inclusive prefix over the 1024 slots in flat order s*128 + j; out
// = clos(route1, P) - clos(route2, P), with route1 = word & 0x1FFF and
// route2 = (word >> 13) & 0x1FFF; cell (0, 0) is the trash cell (it takes
// the permutation-counting imbalance) and is dropped; y tile byt[t] +=
// out.  clos(route, a)[s][j] composes the TPU's three gathers (sublane,
// lane, sublane) into one read: c = subC(s, j), L = laneB(c, j), r =
// subA(c, L), a[r][L], each field read from the route word at the cell
// named.
// Design: one CTA of 1024 threads per tile, one thread per slot.  The route
// words go to shared memory (the composition reads them at other cells),
// and the prefix is tile_prefix.cuh's block scan into shared memory, in
// fp64: a row's sum is the difference of two prefixes of the whole tile,
// so an fp32 prefix errs by ~1e-5 of the tile's running sum and cancels a
// small row's sum away (one y of the analytics stand-in, 303,813 rows,
// was off the float64 golden by 25% on an H100); products of two floats
// are exact in fp64, and the difference is rounded to fp32 once.  Each
// nonzero output is an atomicAdd, since many tiles add into one y tile.
// Padding tiles (route 0 both ways, byt 0) give exact zeros and add
// nothing.  Bound: bytes of vals, word and xg (12 per slot) read once; y
// tiles are touched by atomics that mostly hit L2.

#include <cuda_runtime.h>

#include <cstddef>

#include "tile_prefix.cuh"

namespace {

constexpr int kTile = 1024;  // slots per window or tile == threads per CTA
constexpr int kLanes = 128;

__global__ void __launch_bounds__(kTile)
    s1_gather_kernel(const int* __restrict__ words,
                     const float* __restrict__ x2d, float* __restrict__ out,
                     int K) {
  __shared__ unsigned s_w[kTile];
  const int i = threadIdx.x;
  const size_t w = blockIdx.x;
  const size_t off = w * kTile + i;
  const unsigned wd = static_cast<unsigned>(words[off]);
  s_w[i] = wd;
  __syncthreads();
  const int L = wd & 127;
  const int rank = (wd >> 7) & 3;
  const int sub = (s_w[((i >> 7) << 7) + L] >> (16 + 3 * rank)) & 7;
  const size_t k = w % K;
  out[off] = x2d[(k * 8 + sub) * kLanes + L];
}

// The flat slot that clos(route, .) brings to slot i, for the route held
// in bits shift .. shift+12 of the words in s_w.
__device__ __forceinline__ int clos_source(const unsigned* s_w, int i,
                                           int shift) {
  const int j = i & 127;
  const int c = (s_w[i] >> (shift + 10)) & 7;
  const int L = (s_w[(c << 7) + j] >> (shift + 3)) & 127;
  const int r = (s_w[(c << 7) + L] >> shift) & 7;
  return (r << 7) + L;
}

__global__ void __launch_bounds__(kTile)
    gathered_tile_kernel(const float* __restrict__ vals,
                         const int* __restrict__ word,
                         const int* __restrict__ byt,
                         const float* __restrict__ xg, long long xg_rows,
                         float* __restrict__ y, int y_tiles) {
  __shared__ unsigned s_w[kTile];
  __shared__ double s_pf[kTile];
  __shared__ double s_warp[32];
  const int i = threadIdx.x;
  const size_t t = blockIdx.x;
  const size_t off = t * kTile + i;
  s_w[i] = static_cast<unsigned>(word[off]);
  const long long row = static_cast<long long>(t) * 8 + (i >> 7);
  const float x = row < xg_rows ? xg[off] : 0.f;
  hispmv::tile_prefix(static_cast<double>(vals[off]) * x, s_warp, s_pf);
  __syncthreads();  // s_pf and s_w complete
  const float diff = static_cast<float>(s_pf[clos_source(s_w, i, 0)] -
                                        s_pf[clos_source(s_w, i, 13)]);
  const int yt = byt[t];
  if (i != 0 && diff != 0.f && yt >= 0 && yt < y_tiles) {
    atomicAdd(y + static_cast<size_t>(yt) * kTile + i, diff);
  }
}

}  // namespace

extern "C" {

// B12: words i32 [num_windows, 8, 128] with num_windows = P*K, x2d f32
// [K*8, 128], out f32 [num_windows, 8, 128].  Returns a cudaError_t code.
int hispmv_s1_gather(const int* words, const float* x2d, float* out,
                     int num_windows, int K, cudaStream_t stream) {
  if (num_windows <= 0 || K <= 0 || num_windows % K != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  s1_gather_kernel<<<num_windows, kTile, 0, stream>>>(words, x2d, out, K);
  return static_cast<int>(cudaGetLastError());
}

// B13: see the file comment for the arrays.  Returns a cudaError_t code.
int hispmv_spmv_gathered(const float* vals, const int* word, const int* byt,
                         const float* xg, long long xg_rows, float* y,
                         int y_tiles, int num_tiles, cudaStream_t stream) {
  if (num_tiles <= 0 || y_tiles <= 0 || xg_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gathered_tile_kernel<<<num_tiles, kTile, 0, stream>>>(
      vals, word, byt, xg, xg_rows, y, y_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
