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
// Design.  The Pallas kernel walks a (column stripe, row panel) grid in
// order on one core, seeds each destination panel from dst and folds in
// every contribution with a sequential loop.  Here the destination rows
// are cut into panels of BR rows and the columns into stripes of BD, and
// three launches do the work:
//   (1) panel_count: one block per panel counts the indices that land in
//       it;
//   (2) panel_fill: one block per panel sums the counts of the panels
//       before it (its offset) and writes the positions i of its indices,
//       in increasing i, each with its row in the panel, into one list of
//       n entries (warp ballots and a prefix over the warps keep the
//       order);
//   (3) panel_add: one block per (stripe, panel) walks its panel's list.
//       The list is split among P warps, warp p taking entries p, p + P,
//       ...; each warp adds its rows into its own copy of the panel in
//       shared memory (lane = column), U loads in flight at a time.  The
//       P partial panels are summed in the fixed order 0..P-1 and added to
//       dst, for the rows that received a contribution only: every other
//       row stays bit-unchanged.
// The order of every sum depends on the data alone, so two runs give the
// same bits.  The scan over all n indices happens once per panel (not
// once per panel and stripe), and the P-way split lets a destination that
// receives most of the rows (the sentinel of a padded batch) be summed by
// P warps in each stripe, not one.  The wrapper passes an int workspace
// of 2 * panels + n entries (counts, offsets, the list).
//
// Bound on an H100 SXM (3.35 TB/s): bytes -- the n contribution rows and
// the indices read once, each touched dst row read and written once.

#include <cuda_runtime.h>

namespace {

constexpr int BR = 32;          // rows per panel
constexpr int BD = 32;          // columns per stripe (one per lane)
constexpr int P = 8;            // warps, each with its own partial panel
constexpr int NT = 32 * P;      // 256 threads
constexpr int U = 16;           // contributions in flight per warp
// A list entry packs the row within the panel above the position i, so
// the add kernel needs no second, dependent load of idx[i].
constexpr int kRowShift = 26;
constexpr int kPosMask = (1 << kRowShift) - 1;
static_assert(BR <= (1 << (31 - kRowShift)), "panel row must fit the list");

__global__ void __launch_bounds__(NT)
panel_count_kernel(const int* __restrict__ idx, int n,
                   int* __restrict__ count) {
  const int r0 = blockIdx.x * BR;
  int total = 0;
  for (int base = 0; base < n; base += NT) {
    const int i = base + threadIdx.x;
    const int local = i < n ? idx[i] - r0 : -1;
    total += __syncthreads_count(local >= 0 && local < BR);
  }
  if (threadIdx.x == 0) count[blockIdx.x] = total;
}

__global__ void __launch_bounds__(NT)
panel_fill_kernel(const int* __restrict__ idx, int n,
                  const int* __restrict__ count, int* __restrict__ offs,
                  int* __restrict__ list) {
  __shared__ int red[NT];
  __shared__ int warp_cnt[P];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int panel = blockIdx.x;
  const int r0 = panel * BR;

  int part = 0;
  for (int p = tid; p < panel; p += NT) part += count[p];
  red[tid] = part;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  int pos = red[0];
  if (tid == 0) offs[panel] = pos;

  for (int base = 0; base < n; base += NT) {
    const int i = base + tid;
    const int local = i < n ? idx[i] - r0 : -1;
    const bool in = local >= 0 && local < BR;
    const unsigned ballot = __ballot_sync(0xffffffffu, in);
    if (lane == 0) warp_cnt[wid] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < P; ++w) {
      before += w < wid ? warp_cnt[w] : 0;
      total += warp_cnt[w];
    }
    if (in) {
      list[pos + before + __popc(ballot & ((1u << lane) - 1u))] =
          (local << kRowShift) | i;
    }
    pos += total;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT)
panel_add_kernel(float* __restrict__ dst, int dst_stride,
                 const float* __restrict__ rows, int rows_stride,
                 const int* __restrict__ count, const int* __restrict__ offs,
                 const int* __restrict__ list, int R, int D) {
  __shared__ float part[P][BR][BD];
  __shared__ int hit[BR];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int c0 = blockIdx.x * BD;
  // Blocks start in the order of blockIdx; the last panel, which holds
  // the sentinel row that padding and masked rows aim at (the heaviest),
  // goes first so that its long walk does not become the tail.
  const int panel = gridDim.y - 1 - blockIdx.y;
  const int r0 = panel * BR;
  const int col = c0 + lane;
  const bool col_ok = col < D;
  const int cnt = count[panel];
  const int* mine = list + offs[panel];
  if (cnt == 0) return;                     // uniform across the block

  for (int e = tid; e < P * BR * BD; e += NT) (&part[0][0][0])[e] = 0.0f;
  for (int e = tid; e < BR; e += NT) hit[e] = 0;
  __syncthreads();

  for (int j = wid; j < cnt; j += P * U) {
    float v[U];
    int r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jj = j + u * P;
      r[u] = -1;
      v[u] = 0.0f;
      if (jj < cnt) {
        const int e = mine[jj];
        const int ii = e & kPosMask;
        r[u] = e >> kRowShift;
        v[u] = col_ok ? rows[(size_t)ii * rows_stride + col] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r[u] >= 0) {
        part[wid][r[u]][lane] += v[u];
        hit[r[u]] = 1;
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < BR * BD; e += NT) {
    const int r = e / BD, c = e % BD;
    if (!hit[r] || r0 + r >= R || c0 + c >= D) continue;
    float s = part[0][r][c];
#pragma unroll
    for (int p = 1; p < P; ++p) s += part[p][r][c];
    float* out = dst + (size_t)(r0 + r) * dst_stride + c0 + c;
    *out += s;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is a device
// pointer; `ws` is an int workspace of 2 * ceil(R / 32) + n entries;
// `stream` is a cudaStream_t.  Returns the cudaError_t of the launches (0
// on success); cudaErrorInvalidValue for a grid too tall or n >= 2^26.
extern "C" int scatter_add_rows_launch(void* dst, const void* idx,
                                       const void* rows, void* ws, int n,
                                       int R, int D, int dst_stride,
                                       int rows_stride, void* stream) {
  if (n <= 0 || R <= 0 || D <= 0) return 0;
  const int panels = (R + BR - 1) / BR;
  if (panels > 65535 || n > kPosMask + 1) return (int)cudaErrorInvalidValue;
  int* count = static_cast<int*>(ws);
  int* offs = count + panels;
  int* list = offs + panels;
  const int* ip = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  panel_count_kernel<<<panels, NT, 0, s>>>(ip, n, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  panel_fill_kernel<<<panels, NT, 0, s>>>(ip, n, count, offs, list);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + BD - 1) / BD, panels);
  panel_add_kernel<<<grid, NT, 0, s>>>(
      static_cast<float*>(dst), dst_stride,
      static_cast<const float*>(rows), rows_stride, count, offs, list, R, D);
  return (int)cudaGetLastError();
}
