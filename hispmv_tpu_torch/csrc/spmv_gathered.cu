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
// Design: 256 threads a tile, warp w on row w.  Loads: lane l takes slots
// 4l..4l+3 of its row as one float4 of vals, one int4 of words and one
// float4 of xg (one xg_rows compare a thread, as the four slots share a
// row); the words go to shared memory by one int4 store (the composition
// reads them at other cells).  Prefix, in fp64: a serial prefix over the
// thread's four products, a warp-shuffle scan of the 32 lane totals (the
// row's prefix), the 8 row totals through shared memory behind one
// barrier (a warp adds those of the rows before its own in a loop of
// warp-uniform length), then four prefixes a thread into s_pf (8 KB) and
// a second barrier.  fp64 because a row's sum is the difference of two
// prefixes of the whole tile: an fp32 prefix errs by ~1e-5 of the tile's
// running sum and cancels a small row's sum away (one y of the analytics
// stand-in, 303,813 rows, was off the float64 golden by 25% on an H100);
// products of two floats are exact in fp64, and the difference is
// rounded to fp32 once.  Clos phase: lane l resolves cells j = l + 32q
// (q = 0..3) of its row, so that the reads of s_w[(c << 7) + j] of a warp
// fall on 32 distinct banks (four consecutive cells a lane would conflict
// 4 ways); its 8 source chains (4 cells x 2 routes) are independent and
// issued together; the atomics of a warp land on 32 consecutive cells.
// Each nonzero output is an atomicAdd, since many tiles add into one y
// tile; a byt outside [0, y_tiles) adds nothing.  Padding tiles (route 0
// both ways, byt 0) give exact zeros and add nothing.  One CTA a tile,
// about 12.3 KB of shared memory and 32 registers: 8 CTAs an SM.  (A
// persistent grid, one wave of CTAs walking tiles with the next tile's
// loads in flight, needed 54 registers and 4 CTAs an SM and was slower
// on analytics' 2,077 tiles in every reading.)  vals, word and xg must be
// 16-byte aligned (the wrapper checks).  Bound: bytes of vals, word and
// xg (12 per slot) read once; y tiles are touched by atomics that mostly
// hit L2.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 1024;  // slots per tile (B13)
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

constexpr int kGThreads = kTile / 4;  // B13: threads a tile, 4 slots each
constexpr int kGRows = kTile / kLanes;  // B13: rows a tile, a warp each

__global__ void __launch_bounds__(kGThreads, 8)
    gathered_tile_kernel(const float4* __restrict__ vals,
                         const int4* __restrict__ word,
                         const int* __restrict__ byt,
                         const float4* __restrict__ xg, long long xg_rows,
                         float* __restrict__ y, int y_tiles) {
  __shared__ __align__(16) unsigned s_w[kTile];
  __shared__ __align__(16) double s_pf[kTile];
  __shared__ double s_row[kGRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = blockIdx.x;
  // slots 4 lane .. 4 lane + 3 of row warp, by 16 bytes each
  const size_t off = static_cast<size_t>(t) * kGThreads + threadIdx.x;
  const float4 v = vals[off];
  const int4 w = word[off];
  const float4 x = t * kGRows + warp < xg_rows
                       ? xg[off]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  const int yt = byt[t];
  reinterpret_cast<int4*>(s_w)[threadIdx.x] = w;
  const double q0 = static_cast<double>(v.x) * x.x;
  const double q1 = q0 + static_cast<double>(v.y) * x.y;
  const double q2 = q1 + static_cast<double>(v.z) * x.z;
  const double q3 = q2 + static_cast<double>(v.w) * x.w;
  double inc = q3;  // the row's inclusive prefix of lane totals
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += n;
  }
  double pre = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) pre = 0.0;
  if (lane == 31) s_row[warp] = inc;
  __syncthreads();  // s_w and the row totals complete
  for (int r = 0; r < warp; ++r) pre += s_row[r];  // warp-uniform
  double2* pf = reinterpret_cast<double2*>(s_pf) + 2 * threadIdx.x;
  pf[0] = make_double2(pre + q0, pre + q1);
  pf[1] = make_double2(pre + q2, pre + q3);
  __syncthreads();  // s_pf complete
  if (yt < 0 || yt >= y_tiles) return;
  // cells j = lane + 32q of row warp; route 1 in bits 0-12, route 2 in
  // 13-25: subA at +0, laneB at +3, subC at +10.  All 8 chains at once.
  const int row = warp << 7;
  unsigned wd[4], m1[4], m2[4];
  int c1[4], c2[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) wd[q] = s_w[row + lane + 32 * q];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = lane + 32 * q;
    c1[q] = ((wd[q] >> 10) & 7) << 7;
    c2[q] = ((wd[q] >> 23) & 7) << 7;
    m1[q] = s_w[c1[q] + j];  // a warp: 32 distinct banks
    m2[q] = s_w[c2[q] + j];
  }
  int l1[4], l2[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    l1[q] = (m1[q] >> 3) & 127;
    l2[q] = (m2[q] >> 16) & 127;
    m1[q] = s_w[c1[q] + l1[q]];
    m2[q] = s_w[c2[q] + l2[q]];
  }
  float* yp = y + static_cast<size_t>(yt) * kTile;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float diff = static_cast<float>(
        s_pf[((m1[q] & 7) << 7) + l1[q]] -
        s_pf[(((m2[q] >> 13) & 7) << 7) + l2[q]]);
    const int i = row + lane + 32 * q;  // cell 0 is the trash cell
    if (diff != 0.f && i != 0) atomicAdd(yp + i, diff);
  }
}

// B13's resident CTAs an SM, asked of the card once (the query costs host
// time).
cudaError_t gathered_resident(int* occ) {
  static std::atomic<int> resident{0};
  int n = resident.load(std::memory_order_relaxed);
  if (n == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, gathered_tile_kernel, kGThreads, 0);
    if (e != cudaSuccess) return e;
    resident.store(n, std::memory_order_relaxed);
  }
  *occ = n;
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// B13: see the file comment for the arrays; vals, word and xg 16-byte
// aligned.  Returns a cudaError_t code.
int hispmv_spmv_gathered(const float* vals, const int* word, const int* byt,
                         const float* xg, long long xg_rows, float* y,
                         int y_tiles, int num_tiles, cudaStream_t stream) {
  if (num_tiles <= 0 || y_tiles <= 0 || xg_rows < 0 || !aligned16(vals) ||
      !aligned16(word) || !aligned16(xg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gathered_tile_kernel<<<num_tiles, kGThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(vals),
      reinterpret_cast<const int4*>(word), byt,
      reinterpret_cast<const float4*>(xg), xg_rows, y, y_tiles);
  return static_cast<int>(cudaGetLastError());
}

// B13's launch shape for num_tiles tiles into out[3]: (threads a CTA,
// CTAs, resident CTAs an SM).  Returns a cudaError_t code.
int hispmv_spmv_gathered_grid(int num_tiles, int* out) {
  if (num_tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int occ = 0;
  const cudaError_t e = gathered_resident(&occ);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = kGThreads;
  out[1] = num_tiles;
  out[2] = occ;
  return 0;
}

}  // extern "C"
