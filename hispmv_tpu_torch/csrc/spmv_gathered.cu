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
// Design: a cell reads the sub field only in its own row (s), so a row of
// 128 words is all that its cells need and no CTA-wide barrier is.  A
// warp takes a row, each lane four consecutive slots: one 16-byte load of
// its words, the row made visible to the warp through 512 bytes of shared
// memory between two __syncwarp, four scattered 4-byte x loads (the K x
// windows, re-read by every panel, stay in L2) and one 16-byte store.
// CTAs of 8 warps, one wave of them (the SM count times the resident CTAs
// an SM, asked of the card); each warp walks rows by grid stride and
// issues the next row's word load before the current row's x loads.  The
// words must be 16-byte aligned (the wrapper checks).  Bound: bytes, the
// words and out once (8 per slot) and x once.
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

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "tile_prefix.cuh"

namespace {

constexpr int kTile = 1024;  // slots per tile == threads per CTA (B13)
constexpr int kLanes = 128;
constexpr int kS1Warps = 8;  // B12: warps a CTA, a row each at a time
constexpr int kS1Threads = kS1Warps * 32;

// B12's cell of word wd in a row whose words are in row: x window xw's
// element [sub][L].
__device__ __forceinline__ float s1_cell(const unsigned* row, int wd,
                                         const float* __restrict__ xw) {
  const unsigned w = static_cast<unsigned>(wd);
  const int L = w & 127;
  const int rank = (w >> 7) & 3;
  const int sub = (row[L] >> (16 + 3 * rank)) & 7;
  return xw[sub * kLanes + L];
}

__global__ void __launch_bounds__(kS1Threads)
    s1_gather_kernel(const int4* __restrict__ words,
                     const float* __restrict__ x2d, float4* __restrict__ out,
                     long long rows, int K) {
  __shared__ __align__(16) unsigned s_row[kS1Warps][kLanes];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* row = s_row[warp];
  const long long stride = static_cast<long long>(gridDim.x) * kS1Warps;
  long long r = static_cast<long long>(blockIdx.x) * kS1Warps + warp;
  int4 cur = make_int4(0, 0, 0, 0);
  if (r < rows) cur = words[r * 32 + lane];
  for (; r < rows; r += stride) {  // r is the same across the warp
    int4 next = cur;
    if (r + stride < rows) next = words[(r + stride) * 32 + lane];
    __syncwarp();  // the warp's reads of the previous row are done
    reinterpret_cast<int4*>(row)[lane] = cur;
    __syncwarp();
    const float* xw = x2d + ((r >> 3) % K) * (8 * kLanes);
    float4 o;
    o.x = s1_cell(row, cur.x, xw);
    o.y = s1_cell(row, cur.y, xw);
    o.z = s1_cell(row, cur.z, xw);
    o.w = s1_cell(row, cur.w, xw);
    out[r * 32 + lane] = o;
    cur = next;
  }
}

// B12's CTAs for rows rows: one for every 8 rows, or one wave of
// resident CTAs, whichever is fewer.
cudaError_t s1_ctas(long long rows, int* ctas) {
  // resident CTAs an SM, asked once (the query costs host time)
  static std::atomic<int> resident{0};
  int occ = resident.load(std::memory_order_relaxed);
  if (occ == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, s1_gather_kernel, kS1Threads, 0);
    if (e != cudaSuccess) return e;
    occ = occ > 0 ? occ : 1;
    resident.store(occ, std::memory_order_relaxed);
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  const long long need = (rows + kS1Warps - 1) / kS1Warps;
  const long long wave = static_cast<long long>(occ) * sms;
  *ctas = static_cast<int>(need < wave ? need : wave);
  return cudaSuccess;
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
// words must be 16-byte aligned.  Returns a cudaError_t code.
int hispmv_s1_gather(const int* words, const float* x2d, float* out,
                     int num_windows, int K, cudaStream_t stream) {
  if (num_windows <= 0 || K <= 0 || num_windows % K != 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(num_windows) * 8;
  int ctas = 0;
  const cudaError_t e = s1_ctas(rows, &ctas);
  if (e != cudaSuccess) return static_cast<int>(e);
  s1_gather_kernel<<<ctas, kS1Threads, 0, stream>>>(
      reinterpret_cast<const int4*>(words), x2d,
      reinterpret_cast<float4*>(out), rows, K);
  return static_cast<int>(cudaGetLastError());
}

// B12's launch shape for num_windows windows into out[3]: (warps a CTA,
// rows, CTAs).  Returns a cudaError_t code.
int hispmv_s1_gather_grid(int num_windows, int* out) {
  if (num_windows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(num_windows) * 8;
  int ctas = 0;
  const cudaError_t e = s1_ctas(rows, &ctas);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = kS1Warps;
  out[1] = static_cast<int>(rows);
  out[2] = ctas;
  return 0;
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
