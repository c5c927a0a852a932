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
//   x2d [x_rows, 128] f32, y [y_tiles*8, 128] f32 zeroed by the caller.
//
// What it computes, per tile t, cell (s, j) = sublane s, lane j, all shifts
// logical:
//   1. L = slot & 127, layer = (l1 == 1) ? 0 : (slot >> 7) & 7; the 9-bit
//      field of that layer is read at cell (s, L) (gsub >> 9l for l < 3,
//      slot >> (10 + 9(l-3)) for l = 3, 4); sub = field & 7, vid = field >>
//      3, xg = x2d[(base[t] + vid)*8 + sub][L] (0 when vid >= W, the layer
//      is >= l1, or the row lies past x).
//   2. p = vals * xg; P = inclusive fp32 prefix over the 1024 slots in flat
//      order s*128 + j.  The reserved lane-0 slots make P[0][0] == 0.
//   3. For each boundary layer k < lmax: raw = bl[t, k/2] >> 14(k%2) and
//      q = bs[t, k/4] >> 8(k%4) (both from bm when lmax == 1); a = raw &
//      127, b = (raw >> 7) & 127; y[byt[t,k]][s][j] += P[q[s,a] & 7][a] -
//      P[(q[s,b] >> 4) & 7][b].  The sub fields are read at the GATHERED
//      lane, as the TPU's composed gathers do.
//
// The TPU builds the x gather from a select tree over the W windows of the
// tile's span and the prefix from triangular MXU matmuls (in a bf16x3
// split); a GPU thread can index x and shared memory directly, so neither
// is carried over.
//
// Design.  One CTA of 1024 threads per tile, one thread per slot.  The
// tile's slot and gsub words go to shared memory (the gather reads them at
// (s, L)), the prefix is a warp-shuffle scan plus a scan of the 32 warp
// totals, and the boundary subs of each group of four layers are staged in
// shared memory (read at gathered lanes).  Many tiles and layers add into
// the same y tile, so each nonzero difference is an atomicAdd into a zeroed
// y; the order of those additions varies from run to run, so results agree
// with the plain version to fp32 rounding, not bit for bit.  A zero
// difference (every padded layer reads P[0][0] - P[0][0]) is skipped.
//
// Bound: the stream (vals, slot, gsub, bl, bs: 3 + ceil(lmax/2) +
// ceil(lmax/4) words per slot) is read once and coalesced; x reads are
// scattered 4-byte loads that mostly hit L2, and every layer costs one
// atomic per nonzero difference.  The kernel is latency-bound at one tile
// per CTA; batching tiles per CTA, prefetching the next tile's stream and
// merging a tile's layers that target the same y tile are later work.
//
// B10 runs the same tile against B vectors stacked as x2d
// [B*x_rows, 128] -> y [B*y_tiles*8, 128]: vector b reads x rows
// b*x_rows + (base + vid)*8 + sub (the row bound x_rows holds per vector)
// and adds into y tile b*y_tiles + byt.  The tile's vals (a register),
// slot and gsub words (shared memory) and, at lmax 1, its merged boundary
// word (shared memory) are read from HBM once per call, before a loop over
// the vectors; the gather coordinates are formed once too.  Each vector
// then has its own prefix scan and boundary layers.  At lmax > 1 the bl
// and bs words are read again for every vector: the first vector brings
// the tile's words (4 KB per word row) into L2 and the others read them
// from there.  Bound: per vector a tile costs a scattered x read per slot,
// a block scan and lmax barriers plus atomics, so at B = 64 the kernel is
// bound by those barriers and atomics, not by the stream bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "tile_prefix.cuh"

namespace {

constexpr int kTile = 1024;  // slots per tile == threads per CTA
constexpr int kLanes = 128;

// Where slot i of tile t gathers from: the row within one vector's x (or -1
// when the slot gathers nothing) and its lane L.  Reads the tile's slot and
// gsub words in shared memory.
__device__ __forceinline__ long long gather_row(const unsigned* s_slot,
                                                const unsigned* s_gsub,
                                                int base, int W, int l1,
                                                long long x_rows, int* lane) {
  const int i = threadIdx.x;
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

// Boundary layers of tile t: adds P[end] - P[start-1] into the y tiles
// byt[t, k] of y (y_tiles tiles).  At lmax 1 the caller has put the merged
// bm word into s_q; above, the bs words are staged into s_q here.  All
// threads call it together.
__device__ __forceinline__ void boundary_layers(
    size_t t, const int* __restrict__ bl, const int* __restrict__ bs,
    const int* __restrict__ byt, int lmax, unsigned* s_q, const float* s_pf,
    float* __restrict__ y, int y_tiles) {
  const int i = threadIdx.x;
  const int s = i >> 7;
  const int npair = (lmax + 1) / 2;
  const int nquad = (lmax + 3) / 4;
  for (int k = 0; k < lmax; ++k) {
    unsigned raw;
    if (lmax == 1) {
      raw = s_q[i];
    } else {
      raw = static_cast<unsigned>(bl[(t * npair + k / 2) * kTile + i]) >>
            (14 * (k & 1));
      if ((k & 3) == 0) {
        __syncthreads();  // every read of the previous group is done
        s_q[i] = static_cast<unsigned>(bs[(t * nquad + k / 4) * kTile + i]);
      }
    }
    __syncthreads();  // s_q (and s_pf, on the first layer) complete
    const int a = raw & 127;
    const int b = (raw >> 7) & 127;
    const unsigned qa = s_q[(s << 7) + a];
    const unsigned qb = s_q[(s << 7) + b];
    int sub_a, sub_b;
    if (lmax == 1) {
      sub_a = (qa >> 14) & 7;
      sub_b = (qb >> 17) & 7;
    } else {
      const int sh = 8 * (k & 3);
      sub_a = (qa >> sh) & 7;
      sub_b = (qb >> (sh + 4)) & 7;
    }
    const float diff = s_pf[(sub_a << 7) + a] - s_pf[(sub_b << 7) + b];
    if (diff != 0.f) {
      const int yt = byt[t * lmax + k];
      if (yt >= 0 && yt < y_tiles) {
        atomicAdd(y + static_cast<size_t>(yt) * kTile + i, diff);
      }
    }
  }
}

__global__ void __launch_bounds__(kTile)
    routed_tile_kernel(const float* __restrict__ vals,
                       const int* __restrict__ slot,
                       const int* __restrict__ gsub,
                       const int* __restrict__ bl,
                       const int* __restrict__ bs,
                       const int* __restrict__ base,
                       const int* __restrict__ byt,
                       const float* __restrict__ x2d, long long x_rows,
                       float* __restrict__ y, int y_tiles, int W, int l1,
                       int lmax) {
  __shared__ unsigned s_slot[kTile];
  __shared__ unsigned s_gsub[kTile];
  __shared__ unsigned s_q[kTile];  // boundary subs of the current layers
  __shared__ float s_pf[kTile];    // the tile's inclusive prefix
  __shared__ float s_warp[32];

  const int i = threadIdx.x;
  const size_t t = blockIdx.x;
  const size_t off = t * kTile + i;
  s_slot[i] = static_cast<unsigned>(slot[off]);
  s_gsub[i] = static_cast<unsigned>(gsub[off]);
  const float v = vals[off];
  if (lmax == 1) s_q[i] = static_cast<unsigned>(bl[off]);
  __syncthreads();

  // 1. x gather
  int L;
  const long long row =
      gather_row(s_slot, s_gsub, base[t], W, l1, x_rows, &L);
  const float xg = row >= 0 ? x2d[row * kLanes + L] : 0.f;
  // 2. inclusive prefix of p over the tile's flat slot order
  hispmv::tile_prefix(v * xg, s_warp, s_pf);
  // 3. boundary layers
  boundary_layers(t, bl, bs, byt, lmax, s_q, s_pf, y, y_tiles);
}

// B10: the tile of B9 against `batch` vectors; see the file comment.
__global__ void __launch_bounds__(kTile)
    routed_tile_batched_kernel(const float* __restrict__ vals,
                               const int* __restrict__ slot,
                               const int* __restrict__ gsub,
                               const int* __restrict__ bl,
                               const int* __restrict__ bs,
                               const int* __restrict__ base,
                               const int* __restrict__ byt,
                               const float* __restrict__ xb2d,
                               long long x_rows, int batch,
                               float* __restrict__ y, int y_tiles, int W,
                               int l1, int lmax) {
  __shared__ unsigned s_slot[kTile];
  __shared__ unsigned s_gsub[kTile];
  __shared__ unsigned s_q[kTile];
  __shared__ float s_pf[kTile];
  __shared__ float s_warp[32];

  const int i = threadIdx.x;
  const size_t t = blockIdx.x;
  const size_t off = t * kTile + i;
  s_slot[i] = static_cast<unsigned>(slot[off]);
  s_gsub[i] = static_cast<unsigned>(gsub[off]);
  const float v = vals[off];
  if (lmax == 1) s_q[i] = static_cast<unsigned>(bl[off]);  // kept for all b
  __syncthreads();

  int L;
  const long long row =
      gather_row(s_slot, s_gsub, base[t], W, l1, x_rows, &L);
  for (int b = 0; b < batch; ++b) {
    const float xg =
        row >= 0 ? xb2d[(b * x_rows + row) * kLanes + L] : 0.f;
    __syncthreads();  // every read of the previous vector's prefix is done
    hispmv::tile_prefix(v * xg, s_warp, s_pf);
    boundary_layers(t, bl, bs, byt, lmax, s_q, s_pf,
                    y + static_cast<size_t>(b) * y_tiles * kTile, y_tiles);
  }
}

bool dims_ok(int num_tiles, int W, int l1, int lmax, const int* bs) {
  return num_tiles > 0 && W >= 1 && W <= 64 && l1 >= 1 && l1 <= 5 &&
         lmax >= 1 && lmax <= 32 && (lmax == 1 || bs != nullptr);
}

}  // namespace

extern "C" {

// See the file comment for the arrays; bs may be null when lmax == 1.
// Returns a cudaError_t code (0 on success).
int hispmv_spmv_routed(const float* vals, const int* slot, const int* gsub,
                       const int* bl, const int* bs, const int* base,
                       const int* byt, const float* x2d, long long x_rows,
                       float* y, int y_tiles, int num_tiles, int W, int l1,
                       int lmax, cudaStream_t stream) {
  if (!dims_ok(num_tiles, W, l1, lmax, bs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  routed_tile_kernel<<<num_tiles, kTile, 0, stream>>>(
      vals, slot, gsub, bl, bs, base, byt, x2d, x_rows, y, y_tiles, W, l1,
      lmax);
  return static_cast<int>(cudaGetLastError());
}

// B10: xb2d [batch*x_rows, 128] (x_rows rows per vector), y
// [batch*y_tiles*8, 128] zeroed.  Returns a cudaError_t code.
int hispmv_spmv_routed_batched(const float* vals, const int* slot,
                               const int* gsub, const int* bl, const int* bs,
                               const int* base, const int* byt,
                               const float* xb2d, long long x_rows, int batch,
                               float* y, int y_tiles, int num_tiles, int W,
                               int l1, int lmax, cudaStream_t stream) {
  if (!dims_ok(num_tiles, W, l1, lmax, bs) || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  routed_tile_batched_kernel<<<num_tiles, kTile, 0, stream>>>(
      vals, slot, gsub, bl, bs, base, byt, xb2d, x_rows, batch, y, y_tiles,
      W, l1, lmax);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
