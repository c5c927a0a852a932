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
//   into (B10: xt and y as below).
// Both also take the plan's lt [Tp] i32 (RoutedStream.lt): the boundary
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
//      order s*128 + j.  The reserved lane-0 slots make P[0][0] == 0.
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
// xt [x_rows, 128, B] (B2's convention), and so does y, [y_tiles*1024, B]:
// the B values of one x row and lane, or of one y row, are contiguous.
// Every launch adds into the y it is given, so the streams of a routed
// plan add into one y.
//
// B10 design.  One CTA of 256 threads a tile, for the whole batch: the
// tile's words are read once a call.  A boundary layer's difference
// P[ea] - P[eb] is the sum of the products of the slots in (eb, ea] (its
// *run*, one y row), so no prefix is formed: each run is summed directly.
// - Prologue: as B9's, thread 0 stages the live bl/bs rows (k < lt) by
//   cp.async.bulk on an mbarrier; every thread loads four slot, gsub and
//   vals words, and forms its four slots' x offsets (row*128 + lane, or -1
//   where the slot gathers nothing or holds the value 0, padding) into
//   shared memory.
// - Run list: each thread decodes its four cells in every live layer and
//   counts the runs with ea != eb whose y tile is in range, the layers of
//   one y tile in a row merged where two pairs chain through a shared entry
//   (the planner spells a run across two layers so, +P[a] - P[0] - P[b] +
//   P[0]: summed apart, both halves would read up to a tile of slots), cut
//   into pieces of at most 32 slots; a block scan gives each thread its
//   place, and the
//   pieces (first slot, length, sign, y row) are listed in shared memory,
//   over the slot words the gather no longer needs (1,024 a round; a tile
//   with more takes more rounds).
// - Sums: a group of G lanes takes two pieces at a time (their loads in
//   flight together; other counts were not compared on the card), each
//   lane VW contiguous vectors (VW 4, 2 or 1: the widest that divides B and
//   that xt and y are aligned to; G the power of two, at most 32, that
//   covers the CTA's vectors in one pass where it can: at B 64, VW 4 and
//   half a warp a piece).  For each
//   slot the group reads the slot's B x values, contiguous (256 B at B 64,
//   two full lines), and sums value * x in fp32 registers; then it adds
//   the B sums into the y row with VW-wide atomics (one row, 256 B at
//   B 64); a lane skips its add where its VW sums are all zero.  One
//   algorithm at every B: G and VW follow the batch and the pointers.
// - Grid: a stream whose tiles fill the card (four CTAs an SM, the launch
//   bound) runs one CTA a tile for the whole batch.  A smaller stream
//   splits the batch into up to B/VW slices of whole VW-vector lanes, one
//   CTA a tile and slice, so that it still fills the SMs; each slice reads
//   the tile's words and lists its runs again.
// Bound: the stream's live words are read once a call, x moves B*4 bytes a
// nonzero slot (mostly from L2: a column strip's windows stay resident),
// and y moves B*4 bytes twice for each run (the atomics' read and write).
// A pokec-sized stream adds into ~31% of y's rows a column strip, so y is
// the largest term; vector-minor y moves only the rows a run adds into,
// where a vector-major y (the design before) touched nearly every line of
// each vector plane for every strip.
// Rounding: a run sums its own products, one or a few in a graph's rows,
// in fp32; there is no difference of two prefixes over 1,024 slots.  Many
// tiles add into one y row, so the order of the additions varies from run
// to run: results agree with the plain version to fp32 rounding, not bit
// for bit.

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
constexpr int kSlots = kTile / kThreads;  // cells a thread decodes: c*256 + i
constexpr int kWarps = kThreads / 32;
constexpr int kPiece = 32;  // slots of a run one group sums before its add
constexpr int kRuns = 1024;  // run pieces listed a round (the slot words' room)
constexpr int kInFlight = 2;  // pieces a group sums at once, loads together
constexpr int kMinCtas = 4;   // CTAs an SM at least (the launch bound)

// The run of cell `cell` in live layer k (< lt) of the staged boundary rows:
// its end and start prefix entries ea, eb (flat slots sub*128 + lane).  The
// run adds P[ea] - P[eb], the products of the slots in (eb, ea].
__device__ __forceinline__ void run_ends(int lmax, int lt, int k, int cell,
                                         const unsigned* s_rows, int* ea,
                                         int* eb) {
  const int s = cell >> 7;
  unsigned raw;
  int sub_a, sub_b;
  if (lmax == 1) {
    raw = s_rows[cell];
  } else {
    raw = s_rows[(k >> 1) * kTile + cell] >> (14 * (k & 1));
  }
  const int a = raw & 127;
  const int b = (raw >> 7) & 127;
  if (lmax == 1) {
    sub_a = (s_rows[(s << 7) + a] >> 14) & 7;
    sub_b = (s_rows[(s << 7) + b] >> 17) & 7;
  } else {
    const unsigned* q =
        s_rows + (pair_rows(lmax, lt) + (k >> 2)) * kTile + (s << 7);
    const int sh = 8 * (k & 3);
    sub_a = (q[a] >> sh) & 7;
    sub_b = (q[b] >> (sh + 4)) & 7;
  }
  *ea = (sub_a << 7) + a;
  *eb = (sub_b << 7) + b;
}

// Sends out the run +P[a] - P[b] of cell `cell` into y tile yt as pieces
// of at most kPiece slots; with list != null, the pieces whose index
// (idx + *n on) falls in [lo, lo + kRuns) are written to list[index - lo]:
// x = first slot | count << 10 | sign << 16, y = y row (yt*1024 + cell).
__device__ __forceinline__ void emit_run(int a, int b, int yt, int cell,
                                         int idx, int lo, int2* list,
                                         int* n) {
  const int neg = a < b;
  const int first = (neg ? a : b) + 1;
  const int len = neg ? b - a : a - b;
  for (int p = 0; p < len; p += kPiece, ++*n) {
    const int e = idx + *n - lo;
    if (list != nullptr && e >= 0 && e < kRuns) {
      list[e] = make_int2(
          (first + p) | (min(kPiece, len - p) << 10) | (neg << 16),
          yt * kTile + cell);
    }
  }
}

// The run pieces of a thread's four cells in the live layers (see
// emit_run; returns their count, and adds the runs to *runs).  A layer
// whose y tile is in range gives
// each cell the pair (ea, eb), +P[ea] - P[eb]; the layers of one y tile in
// a row are merged cell by cell, as ops/spmv_routed.py::decode_runs does: a
// pair that starts where the pending one ends, or ends where it starts,
// joins it (the planner spells one run across two layers through a shared
// entry); any other pair sends the pending one out as it is.
__device__ __forceinline__ int list_pieces(int lmax, int lt,
                                           const unsigned* s_rows,
                                           const int* s_byt, int y_tiles,
                                           int idx, int lo, int2* list,
                                           int* runs) {
  int n = 0;
  int pa[kSlots], pb[kSlots];  // the pending pair of each cell, or -1
#pragma unroll
  for (int c = 0; c < kSlots; ++c) pa[c] = pb[c] = -1;
  int cur = -1;
  for (int k = 0; k < lt; ++k) {
    const int yt = s_byt[k];
    if (yt < 0 || yt >= y_tiles) continue;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int cell = c * kThreads + threadIdx.x;
      if (yt != cur && pa[c] >= 0) {  // a new y tile: the pending run goes
        emit_run(pa[c], pb[c], cur, cell, idx, lo, list, &n);
        ++*runs;
        pa[c] = pb[c] = -1;
      }
      int ea, eb;
      run_ends(lmax, lt, k, cell, s_rows, &ea, &eb);
      if (ea == eb) continue;  // the same prefix entry: no slot
      if (pa[c] >= 0 && pb[c] == ea) {
        pb[c] = eb;
      } else if (pa[c] >= 0 && pa[c] == eb) {
        pa[c] = ea;
      } else {
        if (pa[c] >= 0) {
          emit_run(pa[c], pb[c], yt, cell, idx, lo, list, &n);
          ++*runs;
        }
        pa[c] = ea;
        pb[c] = eb;
        continue;
      }
      if (pa[c] == pb[c]) pa[c] = pb[c] = -1;  // joined into nothing
    }
    cur = yt;
  }
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    if (pa[c] >= 0) {
      emit_run(pa[c], pb[c], cur, c * kThreads + threadIdx.x, idx, lo, list,
               &n);
      ++*runs;
    }
  }
  return n;
}

// Exclusive prefix of n over the CTA's threads; *total gets the sum.
__device__ __forceinline__ int block_offset(int n, int* s_wsum, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int v = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) s_wsum[warp] = v;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_wsum[w] : 0;
    sum += s_wsum[w];
  }
  *total = sum;
  return before + v - n;
}

// VW contiguous floats of xt or y: one load or one vector atomic (sm_90
// adds float2 and float4 atomically since CUDA 12.1).
template <int VW>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else if constexpr (VW == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void add_vec(float* p, const float (&v)[VW]) {
#if __CUDACC_VER_MAJOR__ > 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VW == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
#else
#pragma unroll
  for (int u = 0; u < VW; ++u) atomicAdd(p + u, v[u]);
#endif
}

// B10: CTA (t, j) runs tile t of the stream against vectors [j*slice,
// (j+1)*slice) of the batch; see the file comment.  256 threads; a group of
// G lanes (G a power of two, VW vectors a lane) takes kInFlight run pieces
// at a time.  With counted != null, the CTAs of slice 0 add the runs they
// listed to *counted (the check of the decode against the pack's count).
template <int VW>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    routed_runs_batched_kernel(const __grid_constant__ RoutedStream st,
                               const float* __restrict__ xt,
                               long long x_rows, int batch, int slice,
                               int group, float* __restrict__ y, int y_tiles,
                               unsigned long long* counted) {
  extern __shared__ __align__(128) unsigned s_rows[];  // staged bl/bm, bs
  // the slot and gsub words, then (once the gather has read them) the
  // list of run pieces
  __shared__ __align__(16) unsigned s_words[2 * kTile];
  __shared__ int s_xo[kTile];  // row*128 + lane of a slot's x, or -1
  __shared__ float s_v[kTile];
  __shared__ int s_byt[kLmax];
  __shared__ int s_wsum[kWarps];
  __shared__ int s_lt;
  __shared__ __align__(8) unsigned long long s_bar;
  unsigned* s_slot = s_words;
  unsigned* s_gsub = s_words + kTile;
  int2* s_list = reinterpret_cast<int2*>(s_words);

  const int i = threadIdx.x;
  const size_t t = blockIdx.x;
  const unsigned bar = smem_addr(&s_bar);
  if (i == 0) s_lt = stage_rows(st, t, s_rows, bar);
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int cell = c * kThreads + i;
    const size_t off = t * kTile + cell;
    s_slot[cell] = static_cast<unsigned>(st.slot[off]);
    s_gsub[cell] = static_cast<unsigned>(st.gsub[off]);
    s_v[cell] = st.vals[off];
  }
  if (i < st.lmax) s_byt[i] = st.byt[t * st.lmax + i];
  __syncthreads();
  const int lt = s_lt;
  if (lt == 0) return;  // a padding tile: no layer adds anything

  // 1. where each slot gathers from
  const int tb = st.base[t];
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int cell = c * kThreads + i;
    int L;
    const long long row =
        gather_row(cell, s_slot, s_gsub, tb, st.W, st.l1, x_rows, &L);
    s_xo[cell] = row >= 0 && s_v[cell] != 0.f
                     ? static_cast<int>(row * kLanes + L)
                     : -1;
  }
  // 2. the run pieces: counted, then listed a round of kRuns at a time
  wait_rows(bar);
  int nruns = 0;
  const int mine = list_pieces(st.lmax, lt, s_rows, s_byt, y_tiles, 0, 0,
                               nullptr, &nruns);
  if (counted != nullptr && blockIdx.y == 0 && nruns > 0) {
    atomicAdd(counted, static_cast<unsigned long long>(nruns));
  }
  int total;
  const int idx = block_offset(mine, s_wsum, &total);  // syncs: gather done
  const int g = i / group;
  const int li = i % group;
  const int ngroups = kThreads / group;
  const int v_lo = blockIdx.y * slice;
  const int v_hi = min(batch, v_lo + slice);
  for (int lo = 0; lo < total; lo += kRuns) {
    if (lo > 0) __syncthreads();  // the last round's list read
    list_pieces(st.lmax, lt, s_rows, s_byt, y_tiles, idx, lo, s_list,
                &nruns);
    __syncthreads();
    // 3. each group sums kInFlight pieces at a time over the batch, VW
    // vectors a lane: piece q of a step is entry e + q*ngroups
    const int n = min(kRuns, total - lo);
    for (int e = g; e < n; e += kInFlight * ngroups) {
      int first[kInFlight], len[kInFlight], row[kInFlight];
      bool neg[kInFlight];
      int most = 0;
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int eq = e + q * ngroups;
        const int2 w = eq < n ? s_list[eq] : make_int2(0, 0);
        first[q] = w.x & 1023;
        len[q] = (w.x >> 10) & 63;
        neg[q] = (w.x >> 16) & 1;
        row[q] = w.y;
        most = max(most, len[q]);
      }
      for (int v0 = v_lo + li * VW; v0 < v_hi; v0 += group * VW) {
        float acc[kInFlight][VW];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
#pragma unroll
          for (int u = 0; u < VW; ++u) acc[q][u] = 0.f;
        }
        for (int m = 0; m < most; ++m) {
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {
            const int xo = m < len[q] ? s_xo[first[q] + m] : -1;
            if (xo < 0) continue;
            const float v = s_v[first[q] + m];
            float xv[VW];
            load_vec<VW>(xt + static_cast<size_t>(xo) * batch + v0, xv);
#pragma unroll
            for (int u = 0; u < VW; ++u) acc[q][u] = fmaf(v, xv[u], acc[q][u]);
          }
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          bool any = false;
#pragma unroll
          for (int u = 0; u < VW; ++u) {
            if (neg[q]) acc[q][u] = -acc[q][u];
            any |= acc[q][u] != 0.f;
          }
          if (any) {
            add_vec<VW>(y + static_cast<size_t>(row[q]) * batch + v0, acc[q]);
          }
        }
      }
    }
  }
}

// The shape of a B10 launch for a batch, a stream's tiles and the
// alignment of xt and y: vectors a lane (4, 2 or 1: the widest that divides
// the batch and that both pointers are aligned to); slices of the batch
// (the fewest that give the current device's SMs kMinCtas CTAs each, at
// most one a lane of VW vectors) and vectors a slice; lanes a run piece (a
// power of two, up to a warp, enough to cover a slice in one pass when it
// can).  Returns a cudaError_t code.
int batched_shape(int batch, int num_tiles, uintptr_t xt, uintptr_t y,
                  int* vw, int* slices, int* slice, int* group) {
  const uintptr_t a = xt | y;
  *vw = (batch % 4 == 0 && a % 16 == 0) ? 4
        : (batch % 2 == 0 && a % 8 == 0) ? 2
                                         : 1;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int lanes = (batch + *vw - 1) / *vw;
  const long long want = static_cast<long long>(sms) * kMinCtas;
  const long long ask = (want + num_tiles - 1) / num_tiles;
  const int n = static_cast<int>(ask < lanes ? ask : lanes);
  const int per = (lanes + n - 1) / n;  // lanes a slice
  *slices = (lanes + per - 1) / per;
  *slice = per * *vw;
  int gsz = 1;
  while (gsz < per && gsz < 32) gsz *= 2;
  *group = gsz;
  return 0;
}

template <int VW>
int launch_batched(const RoutedStream& st, const float* xt, long long x_rows,
                   int batch, int slices, int slice, int group, float* y,
                   int y_tiles, int num_tiles, unsigned long long* counted,
                   cudaStream_t stream) {
  const int lmax = st.lmax;
  const int rows = lmax == 1 ? 1 : (lmax + 1) / 2 + (lmax + 3) / 4;
  const int smem = rows * kTile * static_cast<int>(sizeof(unsigned));
  const cudaError_t e = cudaFuncSetAttribute(
      routed_runs_batched_kernel<VW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(num_tiles, slices);
  routed_runs_batched_kernel<VW><<<grid, kThreads, smem, stream>>>(
      st, xt, x_rows, batch, slice, group, y, y_tiles, counted);
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

// B10's launch shape for this batch, a stream of num_tiles tiles and these
// xt and y pointers on the current device: out[0] vectors a lane, out[1]
// lanes a run piece, out[2] slices of the batch (CTAs a tile), out[3]
// vectors a slice.  Returns a cudaError_t code.
int hispmv_spmv_routed_batched_shape(int batch, int num_tiles,
                                     const void* xt, const void* y,
                                     int* out) {
  if (batch < 1 || num_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return batched_shape(batch, num_tiles, reinterpret_cast<uintptr_t>(xt),
                       reinterpret_cast<uintptr_t>(y), &out[0], &out[2],
                       &out[3], &out[1]);
}

// B10: xt [x_rows, 128, batch], y [y_tiles*1024, batch] that every run adds
// into; lt [num_tiles] or null (every tile runs all lmax layers); counted
// null, or a counter the runs the kernel lists are added to.  bl and bs
// must be 16-byte aligned (the bulk copies).  Returns a cudaError_t code.
int hispmv_spmv_routed_batched(const float* vals, const int* slot,
                               const int* gsub, const int* bl, const int* bs,
                               const int* base, const int* byt, const int* lt,
                               const float* xt, long long x_rows, int batch,
                               float* y, int y_tiles, int num_tiles, int W,
                               int l1, int lmax, unsigned long long* counted,
                               cudaStream_t stream) {
  if (!dims_ok(num_tiles, W, l1, lmax, bs) || batch < 1 || y_tiles < 1 ||
      x_rows * kLanes > 0x7fffffffLL ||
      static_cast<long long>(y_tiles) * kTile > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(bl) | reinterpret_cast<uintptr_t>(bs)) %
              16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RoutedStream st{vals, slot, gsub, bl, bs, base, byt, lt, W, l1, lmax, 0};
  int vw, slices, slice, group;
  const int e = batched_shape(batch, num_tiles, reinterpret_cast<uintptr_t>(xt),
                              reinterpret_cast<uintptr_t>(y), &vw, &slices,
                              &slice, &group);
  if (e != 0) return e;
  if (vw == 4) {
    return launch_batched<4>(st, xt, x_rows, batch, slices, slice, group, y,
                             y_tiles, num_tiles, counted, stream);
  }
  if (vw == 2) {
    return launch_batched<2>(st, xt, x_rows, batch, slices, slice, group, y,
                             y_tiles, num_tiles, counted, stream);
  }
  return launch_batched<1>(st, xt, x_rows, batch, slices, slice, group, y,
                           y_tiles, num_tiles, counted, stream);
}

}  // extern "C"
