// Shared device code of the block streams (spmv_chunked.cu: B1,
// spmv_chunked_batched.cu: B2, spmv_chunked_paneled.cu: B3,
// spmv_chunked_tiled.cu: B4, spmv_windowed.cu: B7,
// spmv_windowed_batched.cu: B8) on Hopper (sm_90a).  B1, B3, B4 and B7
// run at one vector: x2d [n, 128] is xt [n, 128, 1] and y [nrb, bh] is y
// [nrb, bh, 1], in the same memory.
//
// Arrays: data [nchunks, chunk*bh, 128] f32 or bf16, meta [nchunks, 2,
// chunk] i32 (row_block*2 + last, col block or window), y [nrb, bh, B] f32
// zeroed by the caller (B3: added into), and x vector-minor: x row s, lane
// l of vector b at x[(s*128 + l)*B + b].  Block k's x row for lane l is
// set by the x-row mode XRow, a template parameter, never a runtime branch
// (one in a shared template once slowed B1 by 65%): kCol, its col block
// (B1, B2); kWindow, window*8 + subidx[k*128 + l] (B7, B8: subidx
// [nchunks, chunk, 128] i32, one word a lane, coalesced); kPanel, its col
// block plus panel_ids[k / chunk] * panel_ncb, the first x row of its
// chunk's column panel (B3, at V 1 only: panel_ids [nchunks] i32); kTile,
// kPanel's x row and, for y, its row block plus ypanel_ids[k / chunk] *
// panel_nrb, the first row block of its chunk's row panel (B4, at V 1
// only: ypanel_ids [nchunks] i32).
//
// Sector mask (kTile, B4): mask [nchunks, chunk*bh] u16
// holds a word a payload row, bit g set when lanes 8g .. 8g+7 of the row
// hold a nonzero.  Thread l loads its payload value of row r only when bit
// l/8 of row r's word is set and takes 0 otherwise, so a warp asks only
// for the 32-byte sectors (f32; 16-byte halves of one with bf16) that hold
// a nonzero.  The mask words of block k+2 (R rows, one broadcast load of
// 2R bytes) come with its meta words, so block k+1's predicates are in
// registers when its payload loads issue.
//
// Design: a lane-per-thread stream with V vectors a thread.  A CTA has 128
// threads and thread l owns lane l; it holds acc[R][V] in registers, R =
// min(bh, 8) rows of the block and V (1, 4 or 8) vectors.  Per block it
// loads its R payload values (each warp reads one 128-byte row a load,
// coalesced) and the V contiguous values of its x row (two 16-byte loads
// when B % 4 == 0 and x is 16-byte aligned, else masked 4-byte loads),
// then does R*V fp32 FMAs.  There is no shared memory and no barrier per
// block, and the next block's loads (and the meta words, and with kWindow
// the subidx word, of the block after it) are issued before the current
// block's FMAs, so an x load never waits on a fresh index load.  The meta
// cursor runs two blocks ahead of the FMAs, so with kPanel and kTile it
// holds the panel offsets of its own chunk (loaded at the range's first
// chunk and at every chunk it enters) and each block carries its own x
// row and row block.
//
// Grid: (ranges of blocks) x (bh/R row slices) x (ceil(B/V) vector groups),
// the vector group fastest so that the groups reading one range of A run
// side by side and all but one read it from L2.  The stream is cut into
// equal ranges of the whole block sequence (a range may cross chunks, and
// with kPanel and kTile panels: the blocks are contiguous) until the grid
// holds one full wave: the kernel's resident CTAs per SM, which its
// register count sets (the launcher asks the occupancy API once per
// instance), times the SMs.  Blocks are sorted by row-block (with kPanel,
// by panel, then row-block; with kTile, by row panel, col panel, then
// row-block) and every run of a row-block (within a panel) ends with a
// last-flagged block, so the partial still open at a range's end is added
// into the row-block of its last block and the next range adds the rest,
// and acc is zero wherever the stream enters a new panel.  Padding blocks
// (zero payload, col 0, subidx 0, no last flag, sector mask 0; with kPanel
// and kTile at the end of every panel's segment, carrying its last
// row-block) read a valid x row and add zeros; they never flush, save at a
// range's end, with zeros.
//
// Flush (a last-flagged block, and a range's end): the R*V values are
// reduced across the warp by recursive halving (each shuffle step a thread
// keeps half its values and sends the other half: 62 shuffles for 64
// values, 9 for B1's 8), the 4 warps are combined through a
// double-buffered shared array (one barrier a flush), and each live output
// is one atomicAdd into y.  Columns past B are neither loaded nor written.
//
// All arithmetic is fp32 FMA (the TPU kernels run at Precision.HIGHEST), no
// TF32; a bf16 payload is widened on load.  The order of the atomic
// additions varies from run to run, so results agree with the plain
// versions to fp32 rounding, not bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>

#include "block_stream.cuh"

namespace hispmv {

constexpr int kMaxRows = 8;  // R at most: 64 accumulators at V 8
// __launch_bounds__ min CTAs an SM: 128 registers a thread at 4.  The
// windowed R 8, V 8 instance fits it without spills too (123-128), and a
// bound of 3 for kWindow was no faster on an H100 SXM
constexpr int kMinCtas = 4;
constexpr int kSegs = 8;  // column segments per 1024-column window (B7, B8)
// __launch_bounds__ min CTAs an SM with kTile (B4): 64 registers a
// thread.  A masked block asks for half its bytes in the same latency, so
// B4 reads at warps in flight: on an H100 SXM 8 CTAs an SM beat 6 (76
// registers) and 10 (44), and more payload blocks in flight a thread (2
// to 4, at fewer CTAs) were slower.
constexpr int kSectorMinCtas = 8;

// How a block's x row (and with kTile its row block) is found (see the
// file comment).
enum class XRow { kCol, kWindow, kPanel, kTile };

// The sector-mask words of rows r0 .. r0+R-1 of a block at p (row r in the
// half r % 2 of m[r / 2]): one load of 2R bytes, the same address for the
// whole warp.  p is 2R-byte aligned: the block's first row is a multiple
// of bh and r0 one of R.
template <int R>
__device__ __forceinline__ void load_mask(
    const unsigned short* __restrict__ p, unsigned (&m)[(R + 1) / 2]) {
  static_assert(R == 1 || R == 2 || R == 4 || R == 8, "R is 1, 2, 4 or 8");
  if constexpr (R == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    m[0] = v.x;
    m[1] = v.y;
    m[2] = v.z;
    m[3] = v.w;
  } else if constexpr (R == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    m[0] = v.x;
    m[1] = v.y;
  } else if constexpr (R == 2) {
    m[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    m[0] = __ldg(p);
  }
}

// The V values x[.., b0 : b0 + V] at src (zeros past the batch).
template <int V, bool kVec4>
__device__ __forceinline__ void load_x(const float* __restrict__ src,
                                       int live, float (&xv)[V]) {
  static_assert(!kVec4 || V % 4 == 0, "16-byte loads take V in fours");
  if constexpr (kVec4) {  // live is a multiple of 4: all four or none
#pragma unroll
    for (int u = 0; u < V / 4; ++u) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * u < live) f = __ldg(reinterpret_cast<const float4*>(src) + u);
      xv[4 * u] = f.x;
      xv[4 * u + 1] = f.y;
      xv[4 * u + 2] = f.z;
      xv[4 * u + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) xv[v] = v < live ? __ldg(src + v) : 0.f;
  }
}

// Reduces the N values of every lane across the warp by recursive halving:
// at offset 16, 8, ... a lane keeps the lower half of its M values (upper,
// if its bit of the offset is set), adds its partner's copy of that half
// and sends the other half, until one value is left; further offsets add
// the partner's value.  Afterwards a[0 : max(1, N/32)) hold warp totals of
// the outputs idx .. idx + N/32 - 1 (idx is accumulated here); lanes that
// differ only in the bits of those further offsets hold the same totals.
// Every count is a template parameter, so each loop unrolls and a stays in
// registers.
template <int N, int M = N, int OFF = 16>
__device__ __forceinline__ void halve_across_warp(float (&a)[N], int lane,
                                                  int& idx) {
  if constexpr (OFF > 0) {
    if constexpr (M >= 2) {
      const bool up = lane & OFF;
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const float lo = a[i];
        const float hi = a[i + M / 2];
        a[i] = (up ? hi : lo) +
               __shfl_xor_sync(0xffffffffu, up ? lo : hi, OFF);
      }
      if (up) idx += M / 2;
      halve_across_warp<N, M / 2, OFF / 2>(a, lane, idx);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], OFF);
      halve_across_warp<N, 1, OFF / 2>(a, lane, idx);
    }
  }
}

// log2 of a power of two, at compile time.
__host__ __device__ constexpr int log2c(int n) {
  return n <= 1 ? 0 : 1 + log2c(n / 2);
}

// Adds the CTA's R*V totals into y_rb (row r, vector v at r*batch + v; only
// v < live) and zeroes acc.  All 128 threads call it together.
template <int R, int V>
__device__ __forceinline__ void flush_vec(float (&acc)[R * V],
                                          float* __restrict__ y_rb,
                                          int batch, int live,
                                          float (&red)[2][kWarps][R * V],
                                          int& buf) {
  constexpr int N = R * V;
  constexpr int kHalvings = log2c(N) < 5 ? log2c(N) : 5;
  constexpr int kKeep = N >> kHalvings;  // totals a lane holds afterwards
  constexpr int kLowBits = (1 << (5 - kHalvings)) - 1;  // not halved on
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int idx = 0;
  halve_across_warp<N>(acc, lane, idx);
  // one writer per total: the lane whose bits below the halvings are zero
  if ((lane & kLowBits) == 0) {
#pragma unroll
    for (int i = 0; i < kKeep; ++i) red[buf][warp][idx + i] = acc[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  // red[buf] complete; red[buf ^ 1] was last read before this barrier's
  // predecessor, so the next flush may write it without another barrier
  __syncthreads();
  const int t = threadIdx.x;
  if (t < N && t % V < live) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[buf][w][t];
    atomicAdd(y_rb + static_cast<size_t>(t / V) * batch + t % V, s);
  }
  buf ^= 1;
}

// One CTA runs blocks k0 .. k1-1 (a range of the whole stream) for rows
// r0 .. r0+R-1 of each block and vectors b0 .. b0+V-1; see the file
// comment.  subidx is read only with kWindow, panel_ids and panel_ncb only
// with kPanel and kTile, ypanel_ids, panel_nrb and mask only with kTile.
template <typename T, int R, int V, bool kVec4, XRow kX>
__global__ void __launch_bounds__(kLanes, kX == XRow::kTile ? kSectorMinCtas
                                                             : kMinCtas)
    chunked_vec_kernel(const T* __restrict__ data,
                       const int* __restrict__ subidx,
                       const int* __restrict__ meta,
                       const int* __restrict__ panel_ids,
                       const int* __restrict__ ypanel_ids,
                       const unsigned short* __restrict__ mask,
                       const float* __restrict__ xt, float* __restrict__ y,
                       int nblocks, int chunk, int bh, int span, int nslice,
                       int ngroups, int batch, int panel_ncb, int panel_nrb) {
  constexpr int N = R * V;
  constexpr bool kXPanel = kX == XRow::kPanel || kX == XRow::kTile;
  // kTile reads the sector mask: 32-bit words of the slice's R 16-bit
  // sector-mask words; in the other modes they are never read and compile
  // away
  constexpr bool kSectors = kX == XRow::kTile;
  constexpr int kMW = (R + 1) / 2;
  __shared__ float red[2][kWarps][N];
  const int l = threadIdx.x;
  int cta = blockIdx.x;
  const int g = cta % ngroups;
  cta /= ngroups;
  const int r0 = (cta % nslice) * R;
  const int k0 = (cta / nslice) * span;
  const int k1 = min(k0 + span, nblocks);
  if (k0 >= k1) return;  // uniform across the CTA
  const int b0 = g * V;
  const int live = min(V, batch - b0);
  const int gbit = l >> 3;  // this lane's bit in a row's sector-mask word

  const T* a_lane = data + static_cast<size_t>(r0) * kLanes + l;
  const size_t a_step = static_cast<size_t>(bh) * kLanes;  // per block
  const float* x_lane = xt + static_cast<size_t>(l) * batch + b0;
  const size_t x_step = static_cast<size_t>(kLanes) * batch;  // per x row
  float* y_slice = y + static_cast<size_t>(r0) * batch + b0;
  const size_t y_step = static_cast<size_t>(bh) * batch;  // per row-block

  // meta cursor: block k of the stream is column k % chunk of chunk k/chunk
  int mc = k0 / chunk, mj = k0 % chunk;
  const int* mrow = meta + static_cast<size_t>(mc) * 2 * chunk;
  // with kPanel and kTile: the first x row of the panel of the cursor's
  // chunk mc; with kTile also twice the first row block of its row panel
  int pbase = 0, ybase = 0;
  auto load_panels = [&]() {
    if constexpr (kXPanel) pbase = __ldg(panel_ids + mc) * panel_ncb;
    if constexpr (kX == XRow::kTile) {
      ybase = __ldg(ypanel_ids + mc) * panel_nrb * 2;
    }
  };
  load_panels();
  // block k's rb2 = row_block*2 + last, xrow = its x row for this lane
  // (kWindow: window*8 + subidx[k*128 + l]; kPanel, kTile: pbase + col
  // block) and, with kTile, mw = the mask words of the slice's rows;
  // the cursor is at k
  auto next_meta = [&](int k, int& rb2, int& xrow, unsigned (&mw)[kMW]) {
    rb2 = __ldg(mrow + mj);
    xrow = __ldg(mrow + chunk + mj);
    if constexpr (kSectors) {
      load_mask<R>(mask + static_cast<size_t>(k) * bh + r0, mw);
    }
    if constexpr (kX == XRow::kWindow) {
      xrow = xrow * kSegs + __ldg(subidx + static_cast<size_t>(k) * kLanes + l);
    } else if constexpr (kXPanel) {
      xrow += pbase;
      if constexpr (kX == XRow::kTile) rb2 += ybase;  // keeps the last bit
    }
    if (++mj == chunk) {
      mj = 0;
      mrow += 2 * chunk;
      if constexpr (kXPanel) {
        // the next chunk's panels, when the range reads on into it
        ++mc;
        if (k + 1 < k1) load_panels();
      }
    }
  };
  // with kTile, row r's value is loaded only when its sector's bit is
  // set (a predicated load: a warp asks only for the live sectors)
  auto load_a = [&](int k, const unsigned (&mw)[kMW], float (&a)[R]) {
    const T* p = a_lane + static_cast<size_t>(k) * a_step;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (kSectors) {
        a[r] = 0.f;
        if ((mw[r / 2] >> ((r & 1) * 16 + gbit)) & 1u) {
          a[r] = to_f32(p[r * kLanes]);
        }
      } else {
        a[r] = to_f32(p[r * kLanes]);
      }
    }
  };

  int rb2, xrow, rb2n = 0, xrown = 0;  // blocks k and k + 1
  unsigned mw[kMW], mwn[kMW];          // their mask words (kTile)
#pragma unroll
  for (int i = 0; i < kMW; ++i) mw[i] = mwn[i] = 0u;
  next_meta(k0, rb2, xrow, mw);
  if (k0 + 1 < k1) next_meta(k0 + 1, rb2n, xrown, mwn);
  float a[R], xv[V];
  load_a(k0, mw, a);
  load_x<V, kVec4>(x_lane + static_cast<size_t>(xrow) * x_step, live, xv);

  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  int buf = 0;
  bool open = false;  // acc holds blocks not yet flushed
  int rb_open = rb2 >> 1;
  for (int k = k0; k < k1; ++k) {
    // issue block k+1's loads and block k+2's indices before k's FMAs
    float an[R], xn[V];
    int rb2nn = 0, xrownn = 0;
    unsigned mwnn[kMW];
#pragma unroll
    for (int i = 0; i < kMW; ++i) mwnn[i] = 0u;
    if (k + 1 < k1) {
      load_a(k + 1, mwn, an);
      load_x<V, kVec4>(x_lane + static_cast<size_t>(xrown) * x_step, live,
                       xn);
      if (k + 2 < k1) next_meta(k + 2, rb2nn, xrownn, mwnn);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[r * V + v] = fmaf(a[r], xv[v], acc[r * V + v]);
      }
    }
    open = true;
    rb_open = rb2 >> 1;
    if (rb2 & 1) {  // uniform across the CTA: meta is per block
      flush_vec<R, V>(acc, y_slice + static_cast<size_t>(rb_open) * y_step,
                      batch, live, red, buf);
      open = false;
    }
    if (k + 1 < k1) {
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = an[r];
#pragma unroll
      for (int v = 0; v < V; ++v) xv[v] = xn[v];
#pragma unroll
      for (int i = 0; i < kMW; ++i) mwn[i] = mwnn[i];
      rb2 = rb2n;
      rb2n = rb2nn;
      xrown = xrownn;
    }
  }
  if (open) {  // the row-block continues in the next range
    flush_vec<R, V>(acc, y_slice + static_cast<size_t>(rb_open) * y_step,
                    batch, live, red, buf);
  }
}

// V for a batch on a card of sms SMs: vpt when it is given (1, 4 or 8);
// else 1 for one vector (B1, B7), 4 when the batch is at most 4 or when V 8
// would launch fewer CTAs than the card has SMs even with one block a
// range, else 8.  0 when vpt is none of these.
inline int pick_v(int batch, long long nblocks, int nslice, int vpt,
                  int sms) {
  if (vpt != 0) return (vpt == 1 || vpt == 4 || vpt == 8) ? vpt : 0;
  if (batch == 1) return 1;
  const long long ctas8 = nblocks * nslice * ((batch + 7) / 8);
  return (batch <= 4 || ctas8 < sms) ? 4 : 8;
}

inline int rows_per_slice(int bh) { return bh < kMaxRows ? bh : kMaxRows; }

inline bool bh_ok(int bh) {
  return bh == 1 || bh == 2 || bh == 4 || bh == 8 || bh == 16 || bh == 32 ||
         bh == 64;
}

// The launch shape: V, row slices, blocks a range and CTAs.
struct Grid {
  int v, nslice, ngroups, span, ctas;
};

// The launch shape on a card of sms SMs.
template <typename T, int R, int V, bool kVec4, XRow kX>
cudaError_t grid_for(int nblocks, int bh, int batch, int sms, Grid* gr) {
  // resident CTAs an SM, asked once per kernel (the query costs host time
  // on every launch otherwise)
  static std::atomic<int> resident{0};
  int occ = resident.load(std::memory_order_relaxed);
  if (occ == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, chunked_vec_kernel<T, R, V, kVec4, kX>, kLanes, 0);
    if (e != cudaSuccess) return e;
    resident.store(occ, std::memory_order_relaxed);
  }
  gr->v = V;
  gr->nslice = bh / R;
  gr->ngroups = (batch + V - 1) / V;
  // equal ranges until the grid holds one wave of resident CTAs
  const long long per = static_cast<long long>(gr->nslice) * gr->ngroups;
  long long nranges = static_cast<long long>(occ > 0 ? occ : 1) * sms / per;
  nranges = nranges < 1 ? 1 : (nranges > nblocks ? nblocks : nranges);
  gr->span = static_cast<int>((nblocks + nranges - 1) / nranges);
  nranges = (nblocks + gr->span - 1) / gr->span;
  if (nranges * per > INT_MAX) return cudaErrorInvalidValue;
  gr->ctas = static_cast<int>(nranges * per);
  return cudaSuccess;
}

// The arguments of one launch; the pointers are null for a shape query.
// panel_ids and panel_ncb are read with kPanel and kTile, ypanel_ids,
// panel_nrb and mask with kTile.
struct VecArgs {
  const void* data;
  const int* subidx;
  const int* meta;
  const int* panel_ids;
  const int* ypanel_ids;
  const unsigned short* mask;
  const float* xt;
  float* y;
  int nblocks, chunk, bh, batch, panel_ncb, panel_nrb, sms;
};

template <typename T, int R, int V, bool kVec4, XRow kX>
int launch_vec(const VecArgs& p, Grid* out, cudaStream_t stream) {
  Grid gr;
  const cudaError_t e = grid_for<T, R, V, kVec4, kX>(
      p.nblocks, p.bh, p.batch, p.sms, &gr);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (out != nullptr) {  // the shape only, no launch
    *out = gr;
    return 0;
  }
  chunked_vec_kernel<T, R, V, kVec4, kX>
      <<<gr.ctas, kLanes, 0, stream>>>(
          static_cast<const T*>(p.data), p.subidx, p.meta, p.panel_ids,
          p.ypanel_ids, p.mask, p.xt, p.y, p.nblocks, p.chunk, p.bh, gr.span,
          gr.nslice, gr.ngroups, p.batch, p.panel_ncb, p.panel_nrb);
  return static_cast<int>(cudaGetLastError());
}

// vec4: 16-byte x loads (batch % 4 == 0 and xt 16-byte aligned; taken at
// V 4 and 8).  With out, computes the launch shape into it and launches
// nothing.  panel_ids and panel_ncb are read with kPanel and kTile,
// ypanel_ids, panel_nrb and mask with kTile; kPanel and kTile run at V 1
// only (B3 and B4 take one vector).
template <typename T, XRow kX>
int launch_vec_stream(const void* data, const int* subidx, const int* meta,
                      const float* xt, float* y, int nchunks, int chunk,
                      int bh, int batch, int vpt, bool vec4, Grid* out,
                      cudaStream_t stream, const int* panel_ids = nullptr,
                      int panel_ncb = 0, const int* ypanel_ids = nullptr,
                      int panel_nrb = 0,
                      const unsigned short* mask = nullptr) {
  const long long nb = static_cast<long long>(nchunks) * chunk;
  if (nchunks <= 0 || chunk <= 0 || batch <= 0 || !bh_ok(bh) ||
      nb > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const VecArgs p{data, subidx, meta, panel_ids, ypanel_ids, mask, xt, y,
                  static_cast<int>(nb), chunk, bh, batch, panel_ncb,
                  panel_nrb, sms};
  const int R = rows_per_slice(bh);
  const int V = pick_v(batch, nb, bh / R, vpt, sms);
  if (V == 0) return static_cast<int>(cudaErrorInvalidValue);
  // V 1 has no 16-byte x load
#define HISPMV_VEC_LAUNCH(RV, VV)                                        \
  if (R == RV && V == VV) {                                              \
    constexpr bool kCan4 = VV % 4 == 0;                                  \
    return vec4 && kCan4                                                 \
               ? launch_vec<T, RV, VV, kCan4, kX>(p, out, stream)        \
               : launch_vec<T, RV, VV, false, kX>(p, out, stream);       \
  }
  HISPMV_VEC_LAUNCH(1, 1)
  HISPMV_VEC_LAUNCH(2, 1)
  HISPMV_VEC_LAUNCH(4, 1)
  HISPMV_VEC_LAUNCH(8, 1)
  if constexpr (kX == XRow::kCol || kX == XRow::kWindow) {
    HISPMV_VEC_LAUNCH(1, 4)
    HISPMV_VEC_LAUNCH(1, 8)
    HISPMV_VEC_LAUNCH(2, 4)
    HISPMV_VEC_LAUNCH(2, 8)
    HISPMV_VEC_LAUNCH(4, 4)
    HISPMV_VEC_LAUNCH(4, 8)
    HISPMV_VEC_LAUNCH(8, 4)
    HISPMV_VEC_LAUNCH(8, 8)
  }
#undef HISPMV_VEC_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch shape for these sizes (f32 payload, 16-byte x loads when
// batch % 4 == 0): out = {V, row slices, CTAs}.  Returns a cudaError_t code
// (cudaErrorInvalidValue for what the launcher refuses).
template <XRow kX>
int vec_stream_grid(int nchunks, int chunk, int bh, int batch, int vpt,
                    int* out) {
  Grid gr;
  const int rc = launch_vec_stream<float, kX>(
      nullptr, nullptr, nullptr, nullptr, nullptr, nchunks, chunk, bh, batch,
      vpt, batch % 4 == 0, &gr, nullptr);
  if (rc == 0) {
    out[0] = gr.v;
    out[1] = gr.nslice;
    out[2] = gr.ctas;
  }
  return rc;
}

}  // namespace hispmv
