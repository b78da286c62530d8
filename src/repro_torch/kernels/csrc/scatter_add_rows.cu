// Row scatter-add with duplicate indices, dst[idx[i]] += rows[i], in place,
// for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/level_megastep_bwd.py:108
// `scatter_add_rows` (its pallas_call at :144).  The contract is the same:
// every idx[i] lies in [0, R), duplicates accumulate, nothing is dropped
// (masked contributions arrive as zero rows aimed at a sentinel row), and
// the result is deterministic: no float atomics.  The plain version is
// src/repro_torch/kernels/ref.py `scatter_add_rows` (index_add_).  In the
// backward it is the scatter of the pulled-row cotangents into the packed
// external matrix (dpull = push) and, on the op-by-op leg, the scatter of
// child cotangents into the gradient buffer (dgather = scatter-add).
//
// Bound on an H100 SXM (3.35 TB/s): bytes -- the n contribution rows read
// once, each touched dst row read and written once.
//
// Design.  The Pallas kernel walks a (column stripe, row panel) grid in
// order on one core and folds every contribution into its panel in turn.
// Here the work list is a plan built once per schedule on the host
// (src/repro_torch/core/structure.py `scatter_plans`): the positions i
// grouped by destination row in increasing i (a row's *run*), cut into
// chunks of at most C positions.  Two launches:
//   (1) chunk_add: a warp per (chunk, column stripe).  It sums its
//       chunk's rows in increasing i, starting from the first row, with
//       16 16-byte loads a lane in flight, the chunk's positions read 32
//       at a time and passed round by shuffles.  A chunk of a run split
//       into several (the sentinel, which padding and masked rows aim at)
//       takes a stripe of 128 columns and 16 rows in flight: its long walk
//       is cut across many warps and pipelined deep; it writes its sum to
//       a partial row of the workspace.  A chunk that is its row's whole
//       run (every live destination on the main path) takes a stripe of
//       512 columns, 4 rows in flight: one chunk load serves a wide
//       stripe; it adds its sum to dst, one writer a row.  Split chunks
//       come first in the plan and in the grid, so their walks start
//       first.
//   (2) run_combine (only when a run is split): a block per (split run,
//       stripe of 128 columns).  Its G warps each sum a contiguous group
//       of the run's partials in chunk order; warp 0 adds the G group sums
//       in group order and adds the total to dst once.
// Every sum's order depends on the plan alone, so two runs give the same
// bits, and rows no index points at are never written.  The work is
// O(n * D), with no scan of the indices on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kAddWarps = 8;             // warps (tasks) a chunk_add block
constexpr int kLoads = 16;               // 16-byte loads in flight a lane
constexpr int kNarrow = 128;             // columns a split chunk's task
constexpr int kWide = 512;               // columns a whole run's task
constexpr int kGroups = 16;              // warps (groups) a combine block
constexpr int kCombineRows = 8;          // partials in flight a lane

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Columns [col, col + 4) of a row; zeros past D.  kVec: one 16-byte load
// (D, the strides and the base are multiples of 4 floats).
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ row,
                                        int col, int D) {
  if (kVec) {
    return col < D ? __ldg(reinterpret_cast<const float4*>(row + col))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return make_float4(col < D ? __ldg(row + col) : 0.f,
                     col + 1 < D ? __ldg(row + col + 1) : 0.f,
                     col + 2 < D ? __ldg(row + col + 2) : 0.f,
                     col + 3 < D ? __ldg(row + col + 3) : 0.f);
}

// dst[col, col + 4) += v, columns past D untouched.
template <bool kVec>
__device__ __forceinline__ void add_into(float* __restrict__ row, int col,
                                         int D, float4 v) {
  if (kVec) {
    if (col < D) {
      float4* p = reinterpret_cast<float4*>(row + col);
      *p = add4(*p, v);
    }
    return;
  }
  if (col < D) row[col] += v.x;
  if (col + 1 < D) row[col + 1] += v.y;
  if (col + 2 < D) row[col + 2] += v.z;
  if (col + 3 < D) row[col + 3] += v.w;
}

// The sum of a chunk's rows over columns col0 + 128 v + [0, 4), v < V, of
// each lane, in increasing i from the first row; 16 / V rows in flight.
template <bool kVec, int V>
__device__ __forceinline__ void chunk_sum(const float* __restrict__ rows,
                                          long long rows_stride,
                                          const int* __restrict__ order,
                                          int4 ch, int col0, int D,
                                          float4 (&acc)[V]) {
  constexpr int kRows = kLoads / V;
  const int lane = threadIdx.x & 31;
  {
    const float* r = rows + (long long)ch.w * rows_stride;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = load4<kVec>(r, col0 + 128 * v, D);
  }
  for (int j0 = ch.y + 1; j0 < ch.z; j0 += 32) {   // uniform across a warp
    const int m = min(32, ch.z - j0);
    const int mine = lane < m ? __ldg(order + j0 + lane) : 0;
    for (int u0 = 0; u0 < m; u0 += kRows) {
      float4 val[kRows][V];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = __shfl_sync(0xffffffffu, mine, u0 + u);
        const float* r = rows + (long long)i * rows_stride;
#pragma unroll
        for (int v = 0; v < V; ++v)
          val[u][v] = u0 + u < m ? load4<kVec>(r, col0 + 128 * v, D)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (u0 + u < m) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = add4(acc[v], val[u][v]);
        }
      }
    }
  }
}

// Tasks [0, split_tasks): (split chunk, 128-column stripe), chunk-major;
// then (whole-run chunk, 512-column stripe).
template <bool kVec>
__global__ void __launch_bounds__(32 * kAddWarps)
chunk_add_kernel(float* __restrict__ dst, long long dst_stride,
                 const float* __restrict__ rows, long long rows_stride,
                 const int* __restrict__ order,
                 const int4* __restrict__ chunks, float* __restrict__ partial,
                 long long split_tasks, long long tasks, int narrow,
                 int wide, int split_chunks, int D) {
  const int lane = threadIdx.x & 31;
  const long long task =
      (long long)blockIdx.x * kAddWarps + (threadIdx.x >> 5);
  if (task >= tasks) return;                       // uniform across a warp
  if (task < split_tasks) {
    const int c = (int)(task / narrow);
    const int col0 = (int)(task % narrow) * kNarrow + 4 * lane;
    float4 acc[1];
    chunk_sum<kVec, 1>(rows, rows_stride, order, __ldg(chunks + c), col0, D,
                       acc);
    // The workspace's rows are narrow * 128 floats: always whole float4s,
    // zeros past D.
    *reinterpret_cast<float4*>(
        partial + (long long)c * narrow * kNarrow + col0) = acc[0];
    return;
  }
  const long long t = task - split_tasks;
  const int4 ch = __ldg(chunks + split_chunks + (int)(t / wide));
  const int col0 = (int)(t % wide) * kWide + 4 * lane;
  float4 acc[4];
  chunk_sum<kVec, 4>(rows, rows_stride, order, ch, col0, D, acc);
  float* out = dst + (long long)ch.x * dst_stride;
#pragma unroll
  for (int v = 0; v < 4; ++v) add_into<kVec>(out, col0 + 128 * v, D, acc[v]);
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kGroups)
run_combine_kernel(float* __restrict__ dst, long long dst_stride,
                   const int4* __restrict__ chunks,
                   const int* __restrict__ run_start,
                   const float* __restrict__ partial, long long part_stride,
                   int stripes, int D) {
  __shared__ float4 group_sum[kGroups][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int run = blockIdx.x / stripes;
  const int col = (blockIdx.x % stripes) * kNarrow + 4 * lane;
  const int c0 = run_start[run];
  const int k = run_start[run + 1] - c0;           // chunks of the run
  const int per = (k + kGroups - 1) / kGroups;     // partials a group
  const int g0 = c0 + w * per;
  const int g1 = min(c0 + k, g0 + per);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g0 < g1) {                                   // uniform across a warp
    const float* base = partial + col;
    acc = *reinterpret_cast<const float4*>(base + (long long)g0 * part_stride);
    for (int c = g0 + 1; c < g1; c += kCombineRows) {
      float4 val[kCombineRows];
#pragma unroll
      for (int u = 0; u < kCombineRows; ++u)
        val[u] = c + u < g1 ? *reinterpret_cast<const float4*>(
                                  base + (long long)(c + u) * part_stride)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kCombineRows; ++u)
        if (c + u < g1) acc = add4(acc, val[u]);
    }
  }
  group_sum[w][lane] = acc;
  __syncthreads();
  if (w != 0) return;
  const int groups = (k + per - 1) / per;          // groups with partials
  float4 total = group_sum[0][lane];
  for (int g = 1; g < groups; ++g) total = add4(total, group_sum[g][lane]);
  add_into<kVec>(dst + (long long)__ldg(chunks + c0).x * dst_stride, col, D,
                 total);
}

template <bool kVec>
int launch(float* dst, long long dst_stride, const float* rows,
           long long rows_stride, const int* order, const int4* chunks,
           const int* run_start, float* partial, int n_chunks,
           int split_chunks, int split_runs, int D, cudaStream_t s) {
  const int narrow = (D + kNarrow - 1) / kNarrow;
  const int wide = (D + kWide - 1) / kWide;
  const long long split_tasks = (long long)split_chunks * narrow;
  const long long tasks =
      split_tasks + (long long)(n_chunks - split_chunks) * wide;
  const long long blocks = (tasks + kAddWarps - 1) / kAddWarps;
  if (blocks > 0x7fffffffLL ||
      (long long)split_runs * narrow > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  chunk_add_kernel<kVec><<<(unsigned)blocks, 32 * kAddWarps, 0, s>>>(
      dst, dst_stride, rows, rows_stride, order, chunks, partial,
      split_tasks, tasks, narrow, wide, split_chunks, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split_runs == 0) return (int)err;
  run_combine_kernel<kVec><<<split_runs * narrow, 32 * kGroups, 0, s>>>(
      dst, dst_stride, chunks, run_start, partial,
      (long long)narrow * kNarrow, narrow, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is a device
// pointer: `order`, `chunks` ([n_chunks, 4], 16-byte aligned) and
// `run_start` ([split_runs + 1]) are a plan's (see the header);
// `partial` is a float workspace of split_chunks * ceil(D / 128) * 128
// entries, 16-byte aligned; `stream` is a cudaStream_t.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int scatter_add_rows_launch(void* dst, const void* rows,
                                       const void* order, const void* chunks,
                                       const void* run_start, void* partial,
                                       int n_chunks, int split_chunks,
                                       int split_runs, int D,
                                       long long dst_stride,
                                       long long rows_stride, void* stream) {
  if (n_chunks <= 0 || D <= 0) return 0;
  const bool vec = D % 4 == 0 && dst_stride % 4 == 0 &&
                   rows_stride % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(dst) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(rows) % 16 == 0;
  auto* d = static_cast<float*>(dst);
  auto* r = static_cast<const float*>(rows);
  auto* o = static_cast<const int*>(order);
  auto* c = static_cast<const int4*>(chunks);
  auto* rs = static_cast<const int*>(run_start);
  auto* p = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(d, dst_stride, r, rows_stride, o, c, rs, p,
                            n_chunks, split_chunks, split_runs, D, s)
             : launch<false>(d, dst_stride, r, rows_stride, o, c, rs, p,
                             n_chunks, split_chunks, split_runs, D, s);
}
