// B5 and B6: the per-block block-ELL stream against one vector and against
// B vectors, on Hopper (sm_90a).
//
// Replace the TPU kernels hispmv_tpu/ops/spmv_block.py::_spmv_block_kernel
// (wrapper spmv_block_pallas) and ::_spmv_block_batched_kernel (wrapper
// spmv_block_batched_pallas).  They consume the plan's arrays unchanged:
//   data   [nblocks, BH, 128] f32 block payloads, sorted by row-block
//   rows, cols, firsts, lasts [nblocks] i32 (BlockPlan / sharded plans)
//   x      [ncb, 128] (B5) or [ncb, 128, batch] (B6) f32: x lane l of col
//          block cb for vector b at (cb*128 + l)*batch + b
//   y      [nrb, BH] (B5) or [nrb, BH, batch] (B6) f32
// They run each shard of the sharded block executor (dist/shard.py), the
// one-shot spmv_block of ops/, and (B6) the block handle's linear() past
// its batch budget.
//
// The TPU grid runs one step per block, in order: it zeroes its accumulator
// on a first-flagged block, adds A_blk * x[cb] (B6: A_blk @ X[cb] on the
// MXU), and on a last-flagged block ASSIGNS y[rows[i]] from it.  The
// parallel form keeps that assign: each run of blocks that starts at a
// first flag (the run starts are found on the host once per plan upload)
// is walked in order by one CTA (B5) or one warp per row slice and vector
// group (B6) until its last flag, and the row-block's outputs are stored
// once with a plain store.  There are no atomics, so the result does not
// change from run to run, and y rows of no run keep the caller's zeros.
// The sharded plans pad a shard with zero blocks on its last row-block with
// first = last = 0: they lie after the last flag of the last run and are
// never read.  An empty shard's one zero block (first = last = 1) stores
// y[0] = 0.  A run that meets the next first flag before a last flag stores
// nothing, as the TPU grid re-zeroes its accumulator there.  A stream whose
// row-block recurs in two runs (no planner emits one) would race where the
// TPU keeps the later run.
//
// B5 reads each payload byte once for one multiply-add, so it is bound by
// the bytes of the A stream, as B1 (a warp reads 128 B of a block row, BH
// accumulators a thread in registers, one shuffle reduction a run).
//
// B6 puts each block's 128-lane reduction in the K dimension of the fp64
// tensor cores: per block a warp forms Y^T[16 vectors x 8 rows] += X^T[16 x
// 128] * A^T[128 x 8] as 32 k-steps of mma.sync m16n8k4 (DMMA, an sm_90
// shape).  One warp owns a (run, 8-row slice, 16-vector group); the CTA
// holds the four groups of a 64-vector panel side by side, so the A tile
// comes from device memory once and three times from L1.  Fragments (lane
// L, t = L&3, q = L>>2; block lane of k-step (j, i) for thread t: 16j + 4t
// + i, the same permutation of K in both operands): A is X^T, lane L holds
// x of vector b + q*2 (row q) and b + q*2 + 1 (row q + 8) at that block
// lane, so a thread's two vectors are adjacent (one 8-byte load when the
// batch is even); B is A^T, lane L holds row q of the slice, and its four
// block lanes of a j are one 16-byte load; D holds rows 2t, 2t+1 of the
// same two vectors.  The reduction never crosses threads: a run's outputs
// stay in the accumulator fragments (two sets, even and odd j, for two
// independent DMMA chains) and its flush is a plain store of fp32 values
// (__double2float_rn).  There is no shared memory, no barrier and no
// atomic.  Block k+1's loads go into each ring slot of block k as soon as
// the slot is widened (a slot is 16 lanes: 12 values a thread), and the
// meta words of block k+2 are loaded before block k's DMMAs; a run reads
// no block past the next run's start.  Rows past bh and vectors past the
// batch load zero and are never stored; a batch past 64 vectors takes
// more panels on grid z.
//
// Why DMMA and not TF32: the TPU kernel runs at Precision.HIGHEST, fp32 on
// the MXU.  DMMA widens each fp32 input exactly, forms exact products and
// accumulates in fp64, at least as accurate as an fp32 FMA chain; a
// single TF32 pass keeps about three digits.  The sum is taken in a fixed
// order, so repeated calls give the same bits.
//
// What bounds B6 (Flan_1565-sized block matrix, ~350,000 blocks of (8,
// 128), ~1.8 blocks a run, B 64): bytes, 1,373 MiB of per-block arrays, x
// and y 400 MB each, 0.67 ms at 3.35 TB/s; x through the SMs, 32 KB a block
// (~12 GB through L2, the x rows of the 40% of blocks at random columns
// from HBM, ~4.5 GB); the DMMA work, ~46 GFLOP, ~0.7 ms at 67 TFLOP/s; the
// fp32 -> fp64 widening, 12 values a slot a thread, ~1.1 ms at 16 a clock
// an SM.  On the card neither the widening nor the DMMA shape is the
// limit (without the widening it gains 2-4%; m8n8k4 is 4-9% slower,
// m16n8k16 20-21%; b6_variants.py): the x traffic and the latency of each
// run's dependent loads (run start, col ids, then its tiles) are, at 168
// registers a thread, 3 CTAs an SM.  Capped at 128 registers it spills and
// loses a third; a warp walking a range of runs needed over 230 registers
// and was slower.  PERF.md has the numbers.

#include <cstdint>

#include "block_stream.cuh"

namespace hispmv {

template <int BH>
__global__ void __launch_bounds__(kLanes)
    block_run_kernel(const float* __restrict__ data,
                     const int* __restrict__ rows,
                     const int* __restrict__ cols,
                     const int* __restrict__ firsts,
                     const int* __restrict__ lasts,
                     const int* __restrict__ starts,
                     const float* __restrict__ x, float* __restrict__ y,
                     int nblocks) {
  __shared__ float red[kWarps][BH];
  const int l = threadIdx.x;
  const int j0 = starts[blockIdx.x];
  float acc[BH];
#pragma unroll
  for (int r = 0; r < BH; ++r) acc[r] = 0.f;
  for (int j = j0; j < nblocks; ++j) {
    if (j != j0 && firsts[j]) return;  // uniform: flags are per block
    const float xv = x[static_cast<size_t>(cols[j]) * kLanes + l];
    const float* ab = data + static_cast<size_t>(j) * BH * kLanes + l;
#pragma unroll
    for (int r = 0; r < BH; ++r) acc[r] = fmaf(ab[r * kLanes], xv, acc[r]);
    if (lasts[j]) {
      flush_tile<BH, true>(acc, y + static_cast<size_t>(rows[j]) * BH, red);
      return;
    }
  }
}

// B6: one warp per (run, 8-row slice, 16-vector group).
constexpr int kB6Rows = 8;     // rows of a slice: the MMA's N
constexpr int kB6Group = 16;   // vectors of a warp: the MMA's M
constexpr int kB6Warps = 4;    // warps of a CTA: 64 vectors of one slice
constexpr int kB6Steps = kLanes / 16;  // ring slots: 16 lanes each

// D (16x8, f64) += A (16x4, row) * B (4x8, col) on the fp64 tensor cores
// (sm_90).  Lane L holds A[L>>2][L&3] (a0) and A[(L>>2) + 8][L&3] (a1),
// B[L&3][L>>2], and D[(L>>2) + 8*m][2*(L&3) + e] in d[m][e].
__device__ __forceinline__ void dmma_16x8x4(double (&d)[2][2], double a0,
                                            double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0][0]), "+d"(d[0][1]), "+d"(d[1][0]), "+d"(d[1][1])
      : "d"(a0), "d"(a1), "d"(b));
}

// The thread's share of one block, slot j of the ring: its A row's lanes
// 16j + 4t .. 16j + 4t + 3 (t = lane & 3) and, at each of those lanes, x
// of its two vectors.
struct B6Slot {
  float4 a;
  float2 x[4];
};

template <bool kVec2>
__device__ __forceinline__ float2 load_x2(const float* __restrict__ p,
                                          bool v0, bool v1) {
  if constexpr (kVec2) {  // v0 implies v1: the batch is even
    return v0 ? __ldg(reinterpret_cast<const float2*>(p))
              : make_float2(0.f, 0.f);
  } else {
    return make_float2(v0 ? __ldg(p) : 0.f, v1 ? __ldg(p + 1) : 0.f);
  }
}

// grid (runs, ceil(bh / 8) row slices, ceil(batch / 64) panels), 32 *
// min(4, ceil(batch / 16)) threads.  kVec2: batch even and x, y 8-byte
// aligned, so a thread's two vectors are one 8-byte load and store.
template <bool kVec2>
__global__ void __launch_bounds__(kB6Warps * 32)
    block_run_batched_kernel(const float* __restrict__ data,
                             const int* __restrict__ rows,
                             const int* __restrict__ cols,
                             const int* __restrict__ lasts,
                             const int* __restrict__ starts,
                             const float* __restrict__ x,
                             float* __restrict__ y, int nblocks, int nruns,
                             int bh, int batch) {
  const int lane = threadIdx.x & 31;
  const int q = lane >> 2;  // A row of the slice; vector pair of the group
  const int t = lane & 3;   // k of each DMMA: lanes 16j + 4t + i
  const int b = blockIdx.z * (kB6Warps * kB6Group) +
                (threadIdx.x >> 5) * kB6Group + 2 * q;  // vectors b, b + 1
  if (b - 2 * q >= batch) return;  // the whole warp: a group past the batch
  const bool v0 = b < batch, v1 = b + 1 < batch;
  const int r0 = blockIdx.y * kB6Rows;
  const int live_rows = min(kB6Rows, bh - r0);
  const bool arow = q < live_rows;
  const int run = blockIdx.x;
  const int j0 = starts[run];
  const int end = run + 1 < nruns ? starts[run + 1] : nblocks;

  const size_t a_step = static_cast<size_t>(bh) * kLanes;
  const size_t x_step = static_cast<size_t>(kLanes) * batch;  // a col block
  const float* a_thr =
      data + static_cast<size_t>(r0 + (arow ? q : 0)) * kLanes + 4 * t;
  const float* x_thr = x + static_cast<size_t>(4 * t) * batch + b;

  B6Slot ring[kB6Steps];
  auto load_slot = [&](B6Slot& s, int j, size_t blk, int cb) {
    s.a = arow ? __ldg(reinterpret_cast<const float4*>(
                     a_thr + blk * a_step + 16 * j))
               : make_float4(0.f, 0.f, 0.f, 0.f);
    const float* p = x_thr + cb * x_step + static_cast<size_t>(16 * j) * batch;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s.x[i] = load_x2<kVec2>(p + static_cast<size_t>(i) * batch, v0, v1);
    }
  };

  int k = j0;
  int cb = cols[k], last = lasts[k];
#pragma unroll
  for (int j = 0; j < kB6Steps; ++j) load_slot(ring[j], j, k, cb);
  // block k + 1's meta, when the run reads it
  bool has1 = !last && k + 1 < end;
  int cb1 = 0, last1 = 1;
  if (has1) {
    cb1 = cols[k + 1];
    last1 = lasts[k + 1];
  }
  // [j parity][vector b or b + 1][row 2t, 2t + 1]
  double acc[2][2][2] = {};
  for (;;) {
    const bool has2 = has1 && !last1 && k + 2 < end;
    int cb2 = 0, last2 = 1;
    if (has2) {
      cb2 = cols[k + 2];
      last2 = lasts[k + 2];
    }
    const int rb = last ? rows[k] : 0;
#pragma unroll
    for (int j = 0; j < kB6Steps; ++j) {
      const B6Slot s = ring[j];
      if (has1) load_slot(ring[j], j, k + 1, cb1);  // block k + 1's slot j
      const double a[4] = {s.a.x, s.a.y, s.a.z, s.a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dmma_16x8x4(acc[j & 1], s.x[i].x, s.x[i].y, a[i]);
      }
    }
    if (last) {
      float* yr = y + (static_cast<size_t>(rb) * bh + r0 + 2 * t) * batch + b;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (2 * t + e >= live_rows) break;
        const float y0 = __double2float_rn(acc[0][0][e] + acc[1][0][e]);
        const float y1 = __double2float_rn(acc[0][1][e] + acc[1][1][e]);
        float* p = yr + static_cast<size_t>(e) * batch;
        if constexpr (kVec2) {
          if (v0) *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
        } else {
          if (v0) p[0] = y0;
          if (v1) p[1] = y1;
        }
      }
      return;
    }
    if (!has1) return;  // the run ends without a last flag: no store
    ++k;
    cb = cb1;
    last = last1;
    has1 = has2;
    cb1 = cb2;
    last1 = last2;
  }
}

struct B6Shape {
  dim3 grid, block;
  bool vec2;
};

// The launch of hispmv_spmv_block_batched; false for what it refuses.
inline bool b6_shape(int nruns, int bh, int batch, const float* x,
                     const float* y, B6Shape& s) {
  if (nruns <= 0 || batch <= 0) return false;
  if (bh != 1 && bh != 2 && bh != 4 && bh != 8 && bh != 16 && bh != 32 &&
      bh != 64) {
    return false;
  }
  constexpr int kPanel = kB6Warps * kB6Group;
  const int npanel = (batch + kPanel - 1) / kPanel;
  if (npanel > 65535) return false;
  const int groups = (batch + kB6Group - 1) / kB6Group;
  s.grid = dim3(nruns, (bh + kB6Rows - 1) / kB6Rows, npanel);
  s.block = dim3(32 * min(kB6Warps, groups));
  s.vec2 = batch % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0 &&
           reinterpret_cast<uintptr_t>(y) % 8 == 0;
  return true;
}

}  // namespace hispmv

extern "C" {

// data f32 [nblocks, bh, 128]; rows/cols/firsts/lasts i32 [nblocks];
// starts i32 [nruns] (the indices j with firsts[j] == 1); x f32 [ncb, 128];
// y f32 [nrb, bh] zeroed.  Returns a cudaError_t code (0 on success).
int hispmv_spmv_block(const float* data, const int* rows, const int* cols,
                      const int* firsts, const int* lasts, const int* starts,
                      const float* x, float* y, int nblocks, int nruns,
                      int bh, cudaStream_t stream) {
  if (nblocks <= 0 || nruns <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(nruns), block(hispmv::kLanes);
#define HISPMV_LAUNCH_RUN(BHV)                                           \
  case BHV:                                                              \
    hispmv::block_run_kernel<BHV><<<grid, block, 0, stream>>>(           \
        data, rows, cols, firsts, lasts, starts, x, y, nblocks);         \
    break;
  switch (bh) {
    HISPMV_LAUNCH_RUN(1)
    HISPMV_LAUNCH_RUN(2)
    HISPMV_LAUNCH_RUN(4)
    HISPMV_LAUNCH_RUN(8)
    HISPMV_LAUNCH_RUN(16)
    HISPMV_LAUNCH_RUN(32)
    HISPMV_LAUNCH_RUN(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HISPMV_LAUNCH_RUN
  return static_cast<int>(cudaGetLastError());
}

// As hispmv_spmv_block against `batch` vectors: x f32 [ncb, 128, batch],
// y f32 [nrb, bh, batch] zeroed.  firsts is not read: starts holds the
// first flags.
int hispmv_spmv_block_batched(const float* data, const int* rows,
                              const int* cols, const int* firsts,
                              const int* lasts, const int* starts,
                              const float* x, float* y, int nblocks,
                              int nruns, int bh, int batch,
                              cudaStream_t stream) {
  (void)firsts;
  hispmv::B6Shape s;
  if (nblocks <= 0 || !hispmv::b6_shape(nruns, bh, batch, x, y, s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s.vec2) {
    hispmv::block_run_batched_kernel<true><<<s.grid, s.block, 0, stream>>>(
        data, rows, cols, lasts, starts, x, y, nblocks, nruns, bh, batch);
  } else {
    hispmv::block_run_batched_kernel<false><<<s.grid, s.block, 0, stream>>>(
        data, rows, cols, lasts, starts, x, y, nblocks, nruns, bh, batch);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of hispmv_spmv_block_batched for these sizes: out =
// {warps a CTA, row slices, CTAs}.  Returns a cudaError_t code
// (cudaErrorInvalidValue for what the launcher refuses).
int hispmv_spmv_block_batched_grid(int nruns, int bh, int batch, int* out) {
  hispmv::B6Shape s;
  if (!hispmv::b6_shape(nruns, bh, batch, nullptr, nullptr, s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = static_cast<int>(s.block.x / 32);
  out[1] = static_cast<int>(s.grid.y);
  out[2] = static_cast<int>(s.grid.x * s.grid.y * s.grid.z);
  return 0;
}

}  // extern "C"
