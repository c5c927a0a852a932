// B9 and B10: routed-stream SpMV on Hopper (sm_90a), one vector (B9) and
// B vectors (B10).
//
// B9 replaces the TPU kernel hispmv_tpu/ops/spmv_routed.py::_routed_kernel
// (wrapper spmv_routed_stream_pallas), B10 the same file's
// _routed_kernel_batched (wrapper spmv_routed_stream_batched_pallas).
// Both consume the packed arrays of the JAX package
// (ops/spmv_routed.py::pack_stream):
//   vals [Tp, 8, 128] f32, slot / gsub [Tp, 8, 128] i32,
//   bl [Tp, ceil(lmax/2), 8, 128] i32 and bs [Tp, ceil(lmax/4), 8, 128] i32,
//   or, when lmax == 1, the merged word bm [Tp, 8, 128] in place of bl
//   (bs unused), base [Tp] i32, byt [Tp, lmax] i32,
//   x2d [x_rows, 128] f32, y [y_tiles*8, 128] f32 that the kernel adds
//   into (B10: xt and y as below, y zeroed by the caller).
// B9 also takes the plan's lt [Tp] i32 (RoutedStream.lt): the boundary
// layers tile t uses; layers k >= lt[t] are padding (zero bl / bs words,
// byt 0) and add P[0][0] - P[0][0] = 0, so skipping them changes nothing.
//
// What it computes, per tile t, cell (s, j) = sublane s, lane j, all shifts
// logical:
//   1. L = slot & 127, layer = (l1 == 1) ? 0 : (slot >> 7) & 7; the 9-bit
//      field of that layer is read at cell (s, L) (gsub >> 9l for l < 3,
//      slot >> (10 + 9(l-3)) for l = 3, 4); sub = field & 7, vid = field >>
//      3, xg = x2d[(base[t] + vid)*8 + sub][L] (0 when vid >= W, the layer
//      is >= l1, or the row lies past x).
//   2. p = vals * xg; P = inclusive prefix over the 1024 slots in flat
//      order s*128 + j (B9 in fp64, B10 in fp32).  The reserved lane-0
//      slots make P[0][0] == 0.
//   3. For each boundary layer k: raw = bl[t, k/2] >> 14(k%2) and
//      q = bs[t, k/4] >> 8(k%4) (both from bm when lmax == 1); a = raw &
//      127, b = (raw >> 7) & 127; y[byt[t,k]][s][j] += P[q[s,a] & 7][a] -
//      P[(q[s,b] >> 4) & 7][b].  The sub fields are read at the GATHERED
//      lane, as the TPU's composed gathers do.
//
// The TPU builds the x gather from a select tree over the W windows of the
// tile's span and the prefix from triangular MXU matmuls (in a bf16x3
// split); a GPU thread can index x and shared memory directly, so neither
// is carried over.  The TPU runs one pallas_call per stream (W, l1 and
// lmax are compile-time shapes there) and every lmax layer of every tile
// (a predicated layer cost it as much as a live one); neither holds here.
//
// B9 design.  One launch runs every stream of a routed plan: the streams'
// arrays and dims come as a table in the kernel's parameters (StreamTable,
// at most kMaxStreams entries), the grid covers the streams' tiles end to
// end (ops/spmv_routed.py::routed_table lays them out by descending lmax,
// so the longest layer loops start first), and a CTA finds its stream
// from the table's first tiles.  One CTA of 1024 threads per tile, one
// thread per slot.
// - Prologue: thread 0 reads lt[t] and issues the tile's live boundary
//   words as two bulk copies (cp.async.bulk) into shared memory, completing
//   on one mbarrier with the expected byte count: the first ceil(lt/2) bl
//   rows (the bm row at lmax 1) and the first ceil(lt/4) bs rows, 4 KB
//   each.  Every thread loads its slot, gsub and vals words and the byt row
//   goes to shared memory.  The copies' latency overlaps the x gather and
//   the prefix, where the parent loaded each layer's words behind it.
// - Gather and prefix: the slot and gsub words in shared memory (the
//   gather reads them at (s, L)); tile_prefix.cuh's warp-shuffle scan, in
//   fp64 as B13's: a row's sum is the difference of two prefixes of the
//   whole tile, so an fp32 prefix errs by ulps of the tile's running sum
//   and cancels a small row away (in fp32, one row of the trans5
//   stand-in's split body missed the float64 golden at rtol 1e-3, atol
//   1e-5 on an H100).  The product of two floats is exact in fp64.
// - Layers: after the prefix's barrier and the mbarrier's wait, each
//   thread runs k < lt[t] with no barrier (every word it reads is staged).
//   Consecutive layers with the same y tile are summed in an fp64 register
//   and added, rounded to fp32 once, by one atomicAdd when the y tile
//   changes or the loop ends; a zero sum is skipped.  Many tiles add into one y tile, so the order of
//   the additions varies from run to run: results agree with the plain
//   version to fp32 rounding, not bit for bit.
// Bound: the stream's words that the live layers need (vals, slot, gsub
// and the live bl / bs rows) are read once and coalesced; x reads are
// scattered 4-byte loads that mostly hit L2, and y is touched by one
// atomic per run of equal y tiles and nonzero sum.  __launch_bounds__(1024,
// 2) keeps two CTAs on an SM (32 registers a thread); the staged words take
// at most 96 KB of dynamic shared memory a CTA (lmax 32), beside 16.4 KB of
// static, so two still fit in the SM's 228 KB.
// On an H100 SXM a lmax-32 tile is held by its layer loop (dependent
// shared-memory reads, one CTA on an SM), the others by the latency of
// their loads, x gather and prefix (ablations in PERF.md).
//
// B10 runs the same tile against B vectors.  x comes vector-minor, as
// xt [x_rows, 128, B] (B2's convention): the B values of one (row, lane)
// are contiguous.  y is [B*y_tiles*8, 128]: vector b adds into y tile
// b*y_tiles + byt.
//
// B10 design.  The grid is tiles x vector groups: CTA (t, g) runs tile t
// against the V vectors b0 = g*V .. b0+V-1 (the last group masked when V
// does not divide B), V a template parameter.  A CTA has 256 threads of
// four slots each; thread i holds slots c*256 + i (c < 4), so each slot
// word load and each vector's y atomics stay coalesced across a warp.
// - Gather: a thread forms its four gather coordinates once and reads the
//   V values of xt[row, L, b0:b0+V], contiguous: one 32-byte sector
//   carries 8 vectors, where a vector-major x spread one warp's 32 loads
//   over 18-24 sectors.  16-byte loads when B % 4 == 0 (and xt is
//   16-byte aligned), else 4-byte loads, a template flag.
// - Prefix: one block scan for all V: 4V values a shuffle step, the 32
//   (slot quarter, warp) totals of each vector scanned by one warp, two
//   barriers.  The prefix goes to shared memory as s_pf[slot][V] (4V KB,
//   dynamic), read with 16-byte loads.
// - Boundary layers: each group of four layers stages its bs word into a
//   double-buffered s_q, one barrier a group; the tile's byt row is in
//   shared memory, and the bl and bs words of the next group are loaded
//   into registers while the current group runs.  A cell whose end and
//   start name the same prefix entry (every padded layer) adds nothing and
//   is skipped; otherwise each vector's nonzero difference is one atomic.
// Registers: 4V products a thread; __launch_bounds__(256, 2) caps a thread
// at 128 registers, so at least two CTAs share an SM (V 8 takes 76-80, so
// three do).  V is chosen in the launcher (see pick_v): 8, or 4 at B <= 4
// and when V 8 would leave SMs without a CTA.  V 16 (nearly all of its
// 128 registers) was slower than V 8 on every stream measured.
// Bound: the stream is read once for each vector group (ceil(B/V) times,
// from L2 after the first), x moves 32 bytes a slot for 8 vectors, and
// every layer costs one atomic per vector and nonzero difference.  The
// byte bound is set by y (B*y_tiles*4 KB a launch, zeroed by the wrapper);
// on an H100 SXM the kernel runs 1.4-5x above it at B 64 (chip_smoke.py).
// Issuing no atomic (x = 0) saved at most a fifth there, and a scan
// through shared memory (fewer shuffles, more registers), 512-thread CTAs,
// a 64-register cap and a grid with the vector group fastest measured no
// faster, so no single one of atomics, shuffles or occupancy holds it.

#include <cuda_runtime.h>

#include <cstdint>

#include "tile_prefix.cuh"

namespace {

constexpr int kTile = 1024;  // slots per tile == threads of a B9 CTA
constexpr int kLanes = 128;

// Where slot i of tile t gathers from: the row within one vector's x (or -1
// when the slot gathers nothing) and its lane L.  Reads the tile's slot and
// gsub words in shared memory.
__device__ __forceinline__ long long gather_row(int i, const unsigned* s_slot,
                                                const unsigned* s_gsub,
                                                int base, int W, int l1,
                                                long long x_rows, int* lane) {
  const unsigned sw = s_slot[i];
  const int L = sw & 127;
  *lane = L;
  const int layer = l1 == 1 ? 0 : static_cast<int>((sw >> 7) & 7);
  if (layer >= l1) return -1;
  const int cell = ((i >> 7) << 7) + L;
  const unsigned field =
      (layer < 3 ? s_gsub[cell] >> (9 * layer)
                 : s_slot[cell] >> (10 + 9 * (layer - 3))) &
      511u;
  const int vid = static_cast<int>(field >> 3);
  const long long row = (static_cast<long long>(base) + vid) * 8 + (field & 7);
  return (vid < W && row < x_rows) ? row : -1;
}

// --- B9 -------------------------------------------------------------------

constexpr int kMaxStreams = 8;  // a routed plan has at most six
constexpr int kLmax = 32;       // the plan's layer cap (plan/routed.py)

// One stream of a B9 launch: its packed arrays, dims and first tile in the
// launch's grid.  lt may be null: every tile then runs all lmax layers.
struct RoutedStream {
  const float* vals;
  const int* slot;
  const int* gsub;
  const int* bl;  // bm when lmax == 1
  const int* bs;  // null when lmax == 1
  const int* base;
  const int* byt;
  const int* lt;
  int W, l1, lmax, first;
};

struct StreamTable {
  RoutedStream s[kMaxStreams];
  int n;
};

// Boundary rows (4 KB each) of one stream's tile in the staging area: bl
// rows (or the bm row), then bs rows.
__device__ __forceinline__ int pair_rows(int lmax, int layers) {
  return lmax == 1 ? layers : (layers + 1) / 2;
}

__device__ __forceinline__ int quad_rows(int lmax, int layers) {
  return lmax == 1 ? 0 : (layers + 3) / 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// bytes from global src to shared dst, completing on the mbarrier at bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Thread 0: the tile's live layers, and the bulk copies of their boundary
// rows into s_rows on the mbarrier at bar.  Returns the live layer count.
__device__ __forceinline__ int stage_rows(const RoutedStream& st, size_t t,
                                          unsigned* s_rows, unsigned bar) {
  const int lmax = st.lmax;
  const int lt = st.lt == nullptr ? lmax : min(max(st.lt[t], 0), lmax);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lt == 0) return 0;
  const int np = pair_rows(lmax, lt);
  const int nq = quad_rows(lmax, lt);
  const unsigned row = kTile * sizeof(unsigned);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"((np + nq) * row)
      : "memory");
  bulk_copy(s_rows, st.bl + t * pair_rows(lmax, lmax) * kTile, np * row, bar);
  if (nq > 0) {
    bulk_copy(s_rows + np * kTile, st.bs + t * quad_rows(lmax, lmax) * kTile,
              nq * row, bar);
  }
  return lt;
}

__device__ __forceinline__ void wait_rows(unsigned bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// The live boundary layers of one tile: per layer the prefix difference of
// cell i, summed while consecutive layers name the same y tile, one
// atomicAdd a run.  s_rows holds the staged bl (or bm) rows, then the bs
// rows.
__device__ __forceinline__ void boundary_layers(int lmax, int lt,
                                                const unsigned* s_rows,
                                                const int* s_byt,
                                                const double* s_pf,
                                                float* __restrict__ y,
                                                int y_tiles) {
  const int i = threadIdx.x;
  const int s = i >> 7;
  const unsigned* s_bs = s_rows + pair_rows(lmax, lt) * kTile;
  double sum = 0.0;
  int yt = s_byt[0];
  for (int k = 0; k < lt; ++k) {
    unsigned raw, qa, qb;
    int sub_a, sub_b;
    if (lmax == 1) {
      raw = s_rows[i];
    } else {
      raw = s_rows[(k >> 1) * kTile + i] >> (14 * (k & 1));
    }
    const int a = raw & 127;
    const int b = (raw >> 7) & 127;
    if (lmax == 1) {
      qa = s_rows[(s << 7) + a];
      qb = s_rows[(s << 7) + b];
      sub_a = (qa >> 14) & 7;
      sub_b = (qb >> 17) & 7;
    } else {
      const unsigned* q = s_bs + (k >> 2) * kTile + (s << 7);
      const int sh = 8 * (k & 3);
      sub_a = (q[a] >> sh) & 7;
      sub_b = (q[b] >> (sh + 4)) & 7;
    }
    const int to = s_byt[k];
    if (to != yt) {  // a new y tile: add the run so far
      if (sum != 0.0 && yt >= 0 && yt < y_tiles) {
        atomicAdd(y + static_cast<size_t>(yt) * kTile + i,
                  static_cast<float>(sum));
      }
      sum = 0.0;
      yt = to;
    }
    sum += s_pf[(sub_a << 7) + a] - s_pf[(sub_b << 7) + b];
  }
  if (sum != 0.0 && yt >= 0 && yt < y_tiles) {
    atomicAdd(y + static_cast<size_t>(yt) * kTile + i,
              static_cast<float>(sum));
  }
}

// B9: CTA b runs tile b - first of the table's stream whose tiles hold b;
// see the file comment.
__global__ void __launch_bounds__(kTile, 2)
    routed_tile_kernel(const __grid_constant__ StreamTable tab,
                       const float* __restrict__ x2d, long long x_rows,
                       float* __restrict__ y, int y_tiles) {
  extern __shared__ __align__(128) unsigned s_rows[];  // staged bl/bm, bs
  __shared__ unsigned s_slot[kTile];
  __shared__ unsigned s_gsub[kTile];
  __shared__ double s_pf[kTile];  // the tile's inclusive prefix, fp64
  __shared__ double s_warp[32];
  __shared__ int s_byt[kLmax];
  __shared__ int s_lt;
  __shared__ __align__(8) unsigned long long s_bar;

  int k = 0;
  while (k + 1 < tab.n && static_cast<int>(blockIdx.x) >= tab.s[k + 1].first) {
    ++k;
  }
  const RoutedStream& st = tab.s[k];
  const int i = threadIdx.x;
  const size_t t = blockIdx.x - st.first;
  const unsigned bar = smem_addr(&s_bar);
  if (i == 0) s_lt = stage_rows(st, t, s_rows, bar);
  const size_t off = t * kTile + i;
  s_slot[i] = static_cast<unsigned>(st.slot[off]);
  s_gsub[i] = static_cast<unsigned>(st.gsub[off]);
  const float v = st.vals[off];
  if (i < st.lmax) s_byt[i] = st.byt[t * st.lmax + i];
  __syncthreads();
  const int lt = s_lt;
  if (lt == 0) return;  // a padding tile: no layer adds anything

  // 1. x gather
  int L;
  const long long row =
      gather_row(i, s_slot, s_gsub, st.base[t], st.W, st.l1, x_rows, &L);
  const float xg = row >= 0 ? x2d[row * kLanes + L] : 0.f;
  // 2. inclusive prefix of p over the tile's flat slot order
  hispmv::tile_prefix(static_cast<double>(v) * xg, s_warp, s_pf);
  __syncthreads();  // s_pf complete
  // 3. the live boundary layers, once their staged rows have landed
  wait_rows(bar);
  boundary_layers(st.lmax, lt, s_rows, s_byt, s_pf, y, y_tiles);
}

// --- B10 ------------------------------------------------------------------

constexpr int kThreads = 256;             // threads of a B10 CTA
constexpr int kSlots = kTile / kThreads;  // slots a thread: c*256 + i
constexpr int kWarps = kThreads / 32;

// The boundary words of one group of four layers, for a thread's slots: the
// group's bs word and the bl words of its two layer pairs (at lmax 1, the
// merged bm word in l[0]).
struct GroupWords {
  unsigned q[kSlots];
  unsigned l[2][kSlots];
};

__device__ __forceinline__ void load_group(GroupWords& w, size_t t, int g,
                                           const int* __restrict__ bl,
                                           const int* __restrict__ bs,
                                           int lmax) {
  const int npair = (lmax + 1) / 2;
  const int nquad = (lmax + 3) / 4;
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int cell = c * kThreads + threadIdx.x;
    w.q[c] = static_cast<unsigned>(bs[(t * nquad + g) * kTile + cell]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pair = 2 * g + h;
      w.l[h][c] = pair < npair ? static_cast<unsigned>(
                                     bl[(t * npair + pair) * kTile + cell])
                               : 0u;
    }
  }
}

// The V values xt[row, L, b0:b0+V] (zeros past the batch or for row -1).
template <int V, bool kVec4>
__device__ __forceinline__ void load_x(const float* __restrict__ xt,
                                       long long row, int L, int batch,
                                       int b0, float (&xv)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) xv[v] = 0.f;
  if (row < 0) return;
  const float* src = xt + (row * kLanes + L) * batch + b0;
  if constexpr (kVec4) {
#pragma unroll
    for (int u = 0; u < V / 4; ++u) {
      if (b0 + 4 * u < batch) {  // batch % 4 == 0: all four or none
        const float4 f = __ldg(reinterpret_cast<const float4*>(src) + u);
        xv[4 * u] = f.x;
        xv[4 * u + 1] = f.y;
        xv[4 * u + 2] = f.z;
        xv[4 * u + 3] = f.w;
      }
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (b0 + v < batch) xv[v] = __ldg(src + v);
    }
  }
}

// Inclusive prefix of each vector's products over the tile's flat slot
// order, into s_pf[slot*V + v].  Thread i holds slots c*256 + i, so the
// order of the 32 (quarter c, warp) runs is c*8 + warp: a shuffle scan
// inside each warp, then one warp scans the 32 run totals of each vector.
template <int V>
__device__ __forceinline__ void batched_prefix(float (&p)[kSlots][V],
                                               float* s_tot, float* s_pf) {
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float n = __shfl_up_sync(0xffffffffu, p[c][v], d);
        if (lane >= d) p[c][v] += n;
      }
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
#pragma unroll
      for (int v = 0; v < V; ++v) s_tot[(c * kWarps + warp) * V + v] = p[c][v];
    }
  }
  __syncthreads();
  if (warp == 0) {  // lane r holds run r's totals
    float w[V];
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = s_tot[lane * V + v];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float n = __shfl_up_sync(0xffffffffu, w[v], d);
        if (lane >= d) w[v] += n;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) s_tot[lane * V + v] = w[v];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int r = c * kWarps + warp;
    float4* dst = reinterpret_cast<float4*>(s_pf + (c * kThreads + i) * V);
#pragma unroll
    for (int u = 0; u < V / 4; ++u) {
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        e[k] = p[c][4 * u + k] + (r > 0 ? s_tot[(r - 1) * V + 4 * u + k] : 0.f);
      }
      dst[u] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

// B10: CTA (t, g) runs tile t against vectors g*V .. g*V+V-1; see the file
// comment.  256 threads, four slots and V vectors a thread.
template <int V, bool kVec4>
__global__ void __launch_bounds__(kThreads, 2)
    routed_tile_batched_kernel(const float* __restrict__ vals,
                               const int* __restrict__ slot,
                               const int* __restrict__ gsub,
                               const int* __restrict__ bl,
                               const int* __restrict__ bs,
                               const int* __restrict__ base,
                               const int* __restrict__ byt,
                               const float* __restrict__ xt,
                               long long x_rows, int batch,
                               float* __restrict__ y, int y_tiles, int W,
                               int l1, int lmax) {
  static_assert(V % 4 == 0, "V is a multiple of 4");
  extern __shared__ float4 s_pf4[];  // [kTile][V/4]: the prefix
  float* s_pf = reinterpret_cast<float*>(s_pf4);
  __shared__ unsigned s_slot[kTile];
  __shared__ unsigned s_gsub[kTile];
  __shared__ unsigned s_q[2][kTile];  // boundary subs, a group of 4 layers
  __shared__ float s_tot[kSlots * kWarps * V];
  __shared__ int s_byt[32];

  const int i = threadIdx.x;
  const size_t t = blockIdx.x;
  const int b0 = blockIdx.y * V;
  const size_t off = t * kTile;
  float v[kSlots];
  GroupWords w;
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int cell = c * kThreads + i;
    s_slot[cell] = static_cast<unsigned>(slot[off + cell]);
    s_gsub[cell] = static_cast<unsigned>(gsub[off + cell]);
    v[c] = vals[off + cell];
  }
  if (lmax == 1) {
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int cell = c * kThreads + i;
      w.l[0][c] = static_cast<unsigned>(bl[off + cell]);
      s_q[0][cell] = w.l[0][c];
    }
  } else {
    load_group(w, t, 0, bl, bs, lmax);
  }
  if (i < lmax) s_byt[i] = byt[t * lmax + i];
  __syncthreads();

  // 1. x gather: V contiguous values of each slot's (row, lane), times vals
  float p[kSlots][V];
  const int tb = base[t];
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    int L;
    const long long row =
        gather_row(c * kThreads + i, s_slot, s_gsub, tb, W, l1, x_rows, &L);
    load_x<V, kVec4>(xt, row, L, batch, b0, p[c]);
#pragma unroll
    for (int u = 0; u < V; ++u) p[c][u] *= v[c];
  }
  // 2. the prefix of every vector, one scan
  batched_prefix<V>(p, s_tot, s_pf);

  // 3. boundary layers, a group of four at a time
  const int nquad = (lmax + 3) / 4;
  const size_t ystride = static_cast<size_t>(y_tiles) * kTile;
  float* yb = y + static_cast<size_t>(b0) * ystride;
  for (int g = 0; g < nquad; ++g) {
    unsigned* q = s_q[g & 1];
    if (lmax > 1) {
#pragma unroll
      for (int c = 0; c < kSlots; ++c) q[c * kThreads + i] = w.q[c];
    }
    // q complete (and s_pf, at g == 0); every read of this buffer, two
    // groups back, was done before the previous group's barrier
    __syncthreads();
    const GroupWords cur = w;
    if (g + 1 < nquad) load_group(w, t, g + 1, bl, bs, lmax);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 4 * g + kk;
      if (k >= lmax) break;
      const int yt = s_byt[k];
      if (yt < 0 || yt >= y_tiles) continue;
#pragma unroll
      for (int c = 0; c < kSlots; ++c) {
        const int cell = c * kThreads + i;
        const int s = cell >> 7;
        const unsigned raw =
            lmax == 1 ? cur.l[0][c] : cur.l[kk >> 1][c] >> (14 * (kk & 1));
        const int a = raw & 127;
        const int b = (raw >> 7) & 127;
        const unsigned qa = q[(s << 7) + a];
        const unsigned qb = q[(s << 7) + b];
        int sub_a, sub_b;
        if (lmax == 1) {
          sub_a = (qa >> 14) & 7;
          sub_b = (qb >> 17) & 7;
        } else {
          sub_a = (qa >> (8 * kk)) & 7;
          sub_b = (qb >> (8 * kk + 4)) & 7;
        }
        const int ea = (sub_a << 7) + a;
        const int eb = (sub_b << 7) + b;
        if (ea == eb) continue;  // the same prefix entry: adds nothing
        float* yc = yb + static_cast<size_t>(yt) * kTile + cell;
#pragma unroll
        for (int u = 0; u < V / 4; ++u) {
          const float4 fa = s_pf4[ea * (V / 4) + u];
          const float4 fb = s_pf4[eb * (V / 4) + u];
          const float d[4] = {fa.x - fb.x, fa.y - fb.y, fa.z - fb.z,
                              fa.w - fb.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int vec = 4 * u + e;
            if (b0 + vec < batch && d[e] != 0.f) {
              atomicAdd(yc + vec * ystride, d[e]);
            }
          }
        }
      }
    }
  }
}

// V for a batch: vpt when it is given (4 or 8); else 8, or 4 when the
// batch is at most 4 or when V 8 would launch fewer CTAs than the card has
// SMs (asked of the current device, as the block-stream launchers do).  0
// when vpt is neither or the device cannot be asked.
int pick_v(int batch, int num_tiles, int vpt) {
  if (vpt != 0) return (vpt == 4 || vpt == 8) ? vpt : 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  const long long ctas8 = static_cast<long long>(num_tiles) * ((batch + 7) / 8);
  return (batch <= 4 || ctas8 < sms) ? 4 : 8;
}

template <int V>
int launch_batched(const float* vals, const int* slot, const int* gsub,
                   const int* bl, const int* bs, const int* base,
                   const int* byt, const float* xt, long long x_rows,
                   int batch, float* y, int y_tiles, int num_tiles, int W,
                   int l1, int lmax, cudaStream_t stream) {
  const bool vec4 =
      batch % 4 == 0 && reinterpret_cast<uintptr_t>(xt) % 16 == 0;
  void (*kern)(const float*, const int*, const int*, const int*, const int*,
               const int*, const int*, const float*, long long, int, float*,
               int, int, int, int) =
      vec4 ? routed_tile_batched_kernel<V, true>
           : routed_tile_batched_kernel<V, false>;
  const int smem = static_cast<int>(sizeof(float)) * kTile * V;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(num_tiles, (batch + V - 1) / V);
  kern<<<grid, kThreads, smem, stream>>>(vals, slot, gsub, bl, bs, base, byt,
                                         xt, x_rows, batch, y, y_tiles, W, l1,
                                         lmax);
  return static_cast<int>(cudaGetLastError());
}

bool dims_ok(int num_tiles, int W, int l1, int lmax, const int* bs) {
  return num_tiles > 0 && W >= 1 && W <= 64 && l1 >= 1 && l1 <= 5 &&
         lmax >= 1 && lmax <= 32 && (lmax == 1 || bs != nullptr);
}

}  // namespace

extern "C" {

// B9 on every stream of a table: table holds num_streams rows of
// kTableWords int64 words (vals, slot, gsub, bl or bm, bs or 0, base, byt,
// lt or 0, W, l1, lmax, tiles, first tile), the streams' tiles end to end
// in the grid; y [y_tiles*8, 128] is added into.  bl and bs must be 16-byte
// aligned (the bulk copies).  Returns a cudaError_t code (0 on success).
int hispmv_spmv_routed_streams(const long long* table, int num_streams,
                               const float* x2d, long long x_rows, float* y,
                               int y_tiles, cudaStream_t stream) {
  constexpr int kTableWords = 13;
  if (num_streams < 1 || num_streams > kMaxStreams || y_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StreamTable tab{};
  tab.n = num_streams;
  long long tiles = 0;
  int rows = 0;  // staged rows a CTA: the table's largest lmax
  for (int k = 0; k < num_streams; ++k) {
    const long long* w = table + k * kTableWords;
    RoutedStream& st = tab.s[k];
    st.vals = reinterpret_cast<const float*>(w[0]);
    st.slot = reinterpret_cast<const int*>(w[1]);
    st.gsub = reinterpret_cast<const int*>(w[2]);
    st.bl = reinterpret_cast<const int*>(w[3]);
    st.bs = reinterpret_cast<const int*>(w[4]);
    st.base = reinterpret_cast<const int*>(w[5]);
    st.byt = reinterpret_cast<const int*>(w[6]);
    st.lt = reinterpret_cast<const int*>(w[7]);
    st.W = static_cast<int>(w[8]);
    st.l1 = static_cast<int>(w[9]);
    st.lmax = static_cast<int>(w[10]);
    st.first = static_cast<int>(w[12]);
    if (!dims_ok(static_cast<int>(w[11]), st.W, st.l1, st.lmax, st.bs) ||
        w[12] != tiles || (w[3] | w[4]) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tiles += w[11];
    const int r = st.lmax == 1 ? 1 : (st.lmax + 1) / 2 + (st.lmax + 3) / 4;
    rows = r > rows ? r : rows;
  }
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = rows * kTile * static_cast<int>(sizeof(unsigned));
  // past 28 KB the 16.4 KB of static shared memory make more than 48 KB
  if (smem > 28 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        routed_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  routed_tile_kernel<<<static_cast<unsigned>(tiles), kTile, smem, stream>>>(
      tab, x2d, x_rows, y, y_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The V that hispmv_spmv_routed_batched launches for this batch, tile
// count and vpt (0 when it would refuse vpt).
int hispmv_spmv_routed_batched_v(int batch, int num_tiles, int vpt) {
  return pick_v(batch, num_tiles, vpt);
}

// B10: xt [x_rows, 128, batch], y [batch*y_tiles*8, 128] zeroed; vpt 0
// lets the launcher pick V (see pick_v).  Returns a cudaError_t code.
int hispmv_spmv_routed_batched(const float* vals, const int* slot,
                               const int* gsub, const int* bl, const int* bs,
                               const int* base, const int* byt,
                               const float* xt, long long x_rows, int batch,
                               float* y, int y_tiles, int num_tiles, int W,
                               int l1, int lmax, int vpt,
                               cudaStream_t stream) {
  const int V = pick_v(batch, num_tiles, vpt);
  if (!dims_ok(num_tiles, W, l1, lmax, bs) || batch < 1 || V == 0 ||
      (batch + V - 1) / V > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (V == 4) {
    return launch_batched<4>(vals, slot, gsub, bl, bs, base, byt, xt, x_rows,
                             batch, y, y_tiles, num_tiles, W, l1, lmax,
                             stream);
  }
  return launch_batched<8>(vals, slot, gsub, bl, bs, base, byt, xt, x_rows,
                           batch, y, y_tiles, num_tiles, W, l1, lmax, stream);
}

}  // extern "C"
