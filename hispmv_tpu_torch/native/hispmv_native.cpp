// Host-side routines of the prepare path: the routed and permutation
// planners' loops, the MatrixMarket body parser and the block packer.
//
// Carried over from hispmv_tpu/native/hispmv_native.cpp, so that both
// packages build identical plans (the block packer sorts with the radix
// argsort below where the JAX package's calls std::sort; the order, and so
// the output, is the same).  Each has a numpy / Python version beside its
// caller that the tests hold it to:
//
//   euler_color        plan/permute.py::_color_py
//   greedy_cell_merge  plan/routed.py::_greedy_merge_py
//   radix_argsort_u64  np.lexsort((cols, rows, mcell))
//   distinct_rank_u64  plan/routed.py::_distinct_rank_py
//   routed_tile_stats  plan/routed.py::_tile_stats_py
//   parse_mtx_body     formats/mtx.py::_parse_body_numpy
//   pack_blocks_*      plan/blocks.py::_pack_blocks_numpy
//
// Plain C ABI for ctypes; OpenMP when compiled with -fopenmp (results do not
// depend on the thread count).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

// ---------------------------------------------------------------------------
// Bipartite d-regular multigraph edge coloring by recursive Euler splitting
// (d a power of two).  A proper 1024-coloring of the {src_window ->
// dst_window} multigraph turns an arbitrary permutation into 3 within-window
// stages + 2 transposes; an 8-coloring routes a within-window stage.
//
// One split: walk Eulerian circuits alternating edge sides; every vertex
// has even degree so each circuit closes and each vertex's edges split
// exactly in half.  Recursion depth log2(d); total work O(n * log d).
// ---------------------------------------------------------------------------

namespace {

struct ColorScratch {
  std::vector<int32_t> l_order, r_order;  // edge ids sorted by sw / dw
  std::vector<int32_t> l_start, r_start;  // CSR offsets per vertex
  std::vector<int32_t> l_cur, r_cur;      // skip cursors
  std::vector<uint8_t> used;
  std::vector<int8_t> side;
};

// Stable counting sort: the same order as np.argsort(kind="stable"), which
// is what makes the Python walk produce the same colouring.
void counting_sort(const int32_t* key, int64_t n, int32_t nv,
                   std::vector<int32_t>& order, std::vector<int32_t>& start) {
  start.assign(nv + 1, 0);
  for (int64_t i = 0; i < n; ++i) ++start[key[i] + 1];
  for (int32_t v = 0; v < nv; ++v) start[v + 1] += start[v];
  order.resize(n);
  std::vector<int32_t> cur(start.begin(), start.end() - 1);
  for (int64_t i = 0; i < n; ++i) order[cur[key[i]]++] = (int32_t)i;
}

void euler_split(const int32_t* sw, const int32_t* dw, int64_t n, int32_t nl,
                 int32_t nr, ColorScratch& s) {
  counting_sort(sw, n, nl, s.l_order, s.l_start);
  counting_sort(dw, n, nr, s.r_order, s.r_start);
  s.l_cur.assign(s.l_start.begin(), s.l_start.end() - 1);
  s.r_cur.assign(s.r_start.begin(), s.r_start.end() - 1);
  s.used.assign(n, 0);
  s.side.resize(n);
  for (int64_t seed = 0; seed < n; ++seed) {
    if (s.used[seed]) continue;
    int64_t e = seed;
    int sd = 0;
    while (e >= 0) {
      s.used[e] = 1;
      s.side[e] = (int8_t)sd;
      if (sd == 0) {  // L->R: continue from the right vertex
        int32_t v = dw[e];
        int32_t c = s.r_cur[v], end = s.r_start[v + 1];
        while (c < end && s.used[s.r_order[c]]) ++c;
        s.r_cur[v] = c;
        e = c < end ? s.r_order[c] : -1;
      } else {  // R->L: continue from the left vertex
        int32_t v = sw[e];
        int32_t c = s.l_cur[v], end = s.l_start[v + 1];
        while (c < end && s.used[s.l_order[c]]) ++c;
        s.l_cur[v] = c;
        e = c < end ? s.l_order[c] : -1;
      }
      sd ^= 1;
    }
  }
}

void color_rec(const int32_t* sw, const int32_t* dw, const int32_t* ids,
               int64_t n, int32_t nl, int32_t nr, int32_t d, int32_t base,
               int32_t* out_colors, ColorScratch& s) {
  if (d == 1 || n == 0) {
    for (int64_t i = 0; i < n; ++i) out_colors[ids[i]] = base;
    return;
  }
  euler_split(sw, dw, n, nl, nr, s);
  // partition edges by side into fresh buffers (recursion reuses scratch)
  std::vector<int32_t> sw0, dw0, id0, sw1, dw1, id1;
  sw0.reserve(n / 2); dw0.reserve(n / 2); id0.reserve(n / 2);
  sw1.reserve(n / 2); dw1.reserve(n / 2); id1.reserve(n / 2);
  for (int64_t i = 0; i < n; ++i) {
    if (s.side[i] == 0) {
      sw0.push_back(sw[i]); dw0.push_back(dw[i]); id0.push_back(ids[i]);
    } else {
      sw1.push_back(sw[i]); dw1.push_back(dw[i]); id1.push_back(ids[i]);
    }
  }
  color_rec(sw0.data(), dw0.data(), id0.data(), (int64_t)sw0.size(), nl, nr,
            d / 2, base, out_colors, s);
  color_rec(sw1.data(), dw1.data(), id1.data(), (int64_t)sw1.size(), nl, nr,
            d / 2, base + d / 2, out_colors, s);
}

}  // namespace

extern "C" {

// sw/dw: int32 [n] vertex ids >= 0; d: colors (power of two; every vertex
// has degree exactly d).  out_colors: int32 [n].  Returns 0 on success.
int euler_color(const int32_t* sw, const int32_t* dw, long long n, int d,
                int32_t* out_colors) {
  if (n == 0) return 0;
  if (d <= 0 || (d & (d - 1)) != 0) return -1;
  int32_t nl = 0, nr = 0;
  for (long long i = 0; i < n; ++i) {
    if (sw[i] >= nl) nl = sw[i] + 1;
    if (dw[i] >= nr) nr = dw[i] + 1;
  }
  std::vector<int32_t> ids(n);
  for (long long i = 0; i < n; ++i) ids[i] = (int32_t)i;
  ColorScratch s;
  color_rec(sw, dw, ids.data(), n, nl, nr, d, 0, out_colors, s);
  return 0;
}

// ---------------------------------------------------------------------------
// Greedy same-strip cell merging (plan/routed.py): consecutive cells of one
// column strip share tile groups while their combined distinct-band count
// stays within the boundary-layer cap.
// ---------------------------------------------------------------------------

long long greedy_cell_merge(const int64_t* strip, const int64_t* bc,
                            long long n, int64_t cap, int64_t* gid) {
  long long g = -1;
  int64_t cur_b = 0, cur_s = -1;
  for (long long i = 0; i < n; ++i) {
    if (strip[i] != cur_s || cur_b + bc[i] > cap) {
      ++g;
      cur_b = 0;
      cur_s = strip[i];
    }
    gid[i] = g;
    cur_b += bc[i];
  }
  return g + 1;
}

// ---------------------------------------------------------------------------
// Parallel LSD radix argsort by uint64 key (routed planner sort core; the
// numpy version is np.lexsort over the key's fields).  16-bit digits;
// passes whose digit is constant across all keys are skipped.  Stable.
// ---------------------------------------------------------------------------

void radix_argsort_u64(const uint64_t* keys, int64_t n, int64_t* order_out) {
  if (n <= 0) return;
  uint64_t all_or = 0, all_and = ~0ull;
  for (int64_t i = 0; i < n; ++i) {
    all_or |= keys[i];
    all_and &= keys[i];
  }
  struct KV {
    uint64_t k;
    uint32_t i;
  };
  std::vector<KV> a(n), b(n);
  for (int64_t i = 0; i < n; ++i) a[i] = {keys[i], (uint32_t)i};
  const int RAD = 1 << 16;
#ifdef _OPENMP
  int nt = omp_get_max_threads();
#else
  int nt = 1;
#endif
  std::vector<int64_t> hist((int64_t)nt * RAD);
  for (int pass = 0; pass < 4; ++pass) {
    int shift = 16 * pass;
    // digit constant across all keys -> the pass is the identity
    if (((all_or >> shift) & 0xFFFF) == ((all_and >> shift) & 0xFFFF))
      continue;
    std::fill(hist.begin(), hist.end(), 0);
    KV* src = a.data();
    KV* dst = b.data();
#pragma omp parallel num_threads(nt)
    {
#ifdef _OPENMP
      int t = omp_get_thread_num();
#else
      int t = 0;
#endif
      int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
      int64_t* h = hist.data() + (int64_t)t * RAD;
      for (int64_t i = lo; i < hi; ++i)
        ++h[(src[i].k >> shift) & 0xFFFF];
    }
    // exclusive prefix over (bucket, thread) — stable order
    int64_t sum = 0;
    for (int d = 0; d < RAD; ++d) {
      for (int t = 0; t < nt; ++t) {
        int64_t* h = hist.data() + (int64_t)t * RAD + d;
        int64_t c = *h;
        *h = sum;
        sum += c;
      }
    }
#pragma omp parallel num_threads(nt)
    {
#ifdef _OPENMP
      int t = omp_get_thread_num();
#else
      int t = 0;
#endif
      int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
      int64_t* h = hist.data() + (int64_t)t * RAD;
      for (int64_t i = lo; i < hi; ++i)
        dst[h[(src[i].k >> shift) & 0xFFFF]++] = src[i];
    }
    std::swap(a, b);
  }
  for (int64_t i = 0; i < n; ++i) order_out[i] = a[i].i;
}

// ---------------------------------------------------------------------------
// distinct_rank: per entry, the number of DISTINCT ``val`` values that
// precede it within its group (entries sharing (group, val) share a rank).
// key[i] = group[i] * width + val[i] must fit uint64 (caller guarantees).
// ---------------------------------------------------------------------------

void distinct_rank_u64(const uint64_t* key, int64_t n, uint64_t width,
                       int64_t* rank_out) {
  if (n <= 0) return;
  std::vector<int64_t> order(n);
  radix_argsort_u64(key, n, order.data());
  uint64_t prev_key = ~0ull;
  uint64_t prev_group = ~0ull;
  int64_t r = -1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t j = order[i];
    uint64_t k = key[j];
    uint64_t g = k / width;
    if (g != prev_group) {
      r = 0;
      prev_group = g;
      prev_key = k;
    } else if (k != prev_key) {
      ++r;
      prev_key = k;
    }
    rank_out[j] = r;
  }
}

// ---------------------------------------------------------------------------
// routed_tile_stats: per-tile nnz / window-min / window-span / distinct
// band count in one parallel pass.  Slots of tile t are the contiguous
// range [t*1024, (t+1)*1024).
// ---------------------------------------------------------------------------

void routed_tile_stats(const int32_t* p_win, const int32_t* p_band,
                       const uint8_t* pad, int64_t T, int32_t* nnz_t,
                       int32_t* wmin_t, int32_t* span_t, int32_t* band_t) {
#pragma omp parallel for schedule(static)
  for (int64_t t = 0; t < T; ++t) {
    const int64_t lo = t * 1024, hi = lo + 1024;
    int32_t cnt = 0;
    int32_t wmin = INT32_MAX, wmax = INT32_MIN;
    int32_t bands[1024];
    int nb = 0;
    for (int64_t i = lo; i < hi; ++i) {
      if (!pad[i]) ++cnt;
      int32_t w = p_win[i];
      if (w < wmin) wmin = w;
      if (w > wmax) wmax = w;
      bands[nb++] = p_band[i];
    }
    std::sort(bands, bands + nb);
    int32_t db = nb ? 1 : 0;
    for (int i = 1; i < nb; ++i)
      if (bands[i] != bands[i - 1]) ++db;
    nnz_t[t] = cnt;
    wmin_t[t] = wmin;
    span_t[t] = wmax - wmin + 1;
    band_t[t] = db;
  }
}

// ---------------------------------------------------------------------------
// MatrixMarket coordinate body parser: "row col [value]" lines, 1-based
// indices made 0-based (reference loadMtx contract, spmv-helper.cpp:34-136).
// Returns the number of entries parsed, or -1 on malformed input: a token
// that is not a number, or a line with more tokens than an entry has.  The
// numpy version is formats/mtx.py::_parse_body_numpy.
// ---------------------------------------------------------------------------

long long parse_mtx_body(const char* buf, long long len, long long expect,
                         int has_value, int32_t* out_rows, int32_t* out_cols,
                         float* out_vals) {
  const char* p = buf;
  const char* end = buf + len;
  long long n = 0;
  while (p < end && n < expect) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
      ++p;
    if (p >= end) break;
    char* next = nullptr;
    long r = strtol(p, &next, 10);
    if (next == p) return -1;
    p = next;
    long c = strtol(p, &next, 10);
    if (next == p) return -1;
    p = next;
    double v = 1.0;
    if (has_value) {
      v = strtod(p, &next);
      if (next == p) return -1;
      p = next;
    }
    // the rest of the line must be blank
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    if (p < end && *p != '\n') return -1;
    out_rows[n] = (int32_t)(r - 1);
    out_cols[n] = (int32_t)(c - 1);
    out_vals[n] = (float)v;
    ++n;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Block packing (plan/blocks.py::build_block_plan; the numpy version is
// plan/blocks.py::_pack_blocks_numpy): the sorted distinct (row_block,
// col_block) keys of the nonzeros and their dense [nblocks, block_h, 128]
// payloads, duplicates summed.
//
// pack_blocks_count sorts the nonzeros by block key with the stable radix
// argsort above (the order of np.unique's inverse with np.add.at's index
// order within a key) and counts the blocks; the caller allocates the
// outputs; pack_blocks_fill writes them, one block per thread at a time,
// adding each block's nonzeros in their COO order (so sums are those of
// np.add.at, bit for bit); pack_blocks_free releases the context.
// ---------------------------------------------------------------------------

struct PackCtx {
  std::vector<int64_t> order;   // nonzero indices sorted by block key
  std::vector<int64_t> starts;  // [nblocks + 1] first position of a block
  std::vector<uint64_t> keys;   // [nblocks] block key
};

void* pack_blocks_count(const int32_t* rows, const int32_t* cols,
                        long long nnz, int block_h, long long ncb,
                        long long* out_nblocks) {
  auto* ctx = new PackCtx();
  std::vector<uint64_t> key(nnz);
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < nnz; ++i)
    key[i] = (uint64_t)(rows[i] / block_h) * (uint64_t)ncb +
             (uint64_t)(cols[i] >> 7);
  ctx->order.resize(nnz);
  radix_argsort_u64(key.data(), nnz, ctx->order.data());
  for (long long i = 0; i < nnz; ++i) {
    uint64_t k = key[ctx->order[i]];
    if (i == 0 || k != ctx->keys.back()) {
      ctx->starts.push_back(i);
      ctx->keys.push_back(k);
    }
  }
  ctx->starts.push_back(nnz);
  *out_nblocks = (long long)ctx->keys.size();
  return ctx;
}

// out_data must be zero-initialised [nblocks * block_h * 128] floats.
void pack_blocks_fill(void* ctx_ptr, const int32_t* rows, const int32_t* cols,
                      const float* vals, long long nnz, int block_h,
                      long long ncb, int32_t* out_block_rows,
                      int32_t* out_block_cols, float* out_data) {
  (void)nnz;
  auto* ctx = (PackCtx*)ctx_ptr;
  const int64_t nb = (int64_t)ctx->keys.size();
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < nb; ++b) {
    out_block_rows[b] = (int32_t)(ctx->keys[b] / (uint64_t)ncb);
    out_block_cols[b] = (int32_t)(ctx->keys[b] % (uint64_t)ncb);
    float* blk = out_data + b * (int64_t)block_h * 128;
    for (int64_t i = ctx->starts[b]; i < ctx->starts[b + 1]; ++i) {
      int64_t src = ctx->order[i];
      blk[(rows[src] % block_h) * 128 + (cols[src] & 127)] += vals[src];
    }
  }
}

void pack_blocks_free(void* ctx_ptr) { delete (PackCtx*)ctx_ptr; }

}  // extern "C"
