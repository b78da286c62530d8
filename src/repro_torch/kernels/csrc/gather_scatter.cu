// Row gather and row scatter -- the Cavs gather/scatter memcpy primitives --
// for Hopper (sm_90a), on rows of 2- or 4-byte elements (bf16, fp32).
//
// Replaces the TPU kernels of src/repro/kernels/gather_scatter.py:
//   K6a `gather_rows`  (:39, its pallas_call at :61):  out[i] = src[idx[i]]
//   K6b `scatter_rows` (:70, its pallas_call at :91):  dst[idx[i]] = rows[i]
// The plain versions are src/repro_torch/kernels/ref.py `gather_rows`
// (index_select) and `scatter_rows` (a masked index_put).  Contracts:
//   gather  -- idx[i] lies in [0, R) (the caller's contract); the kernel
//              guards its reads and writes a zero row for an index outside.
//   scatter -- dst is written in place; ids are unique, so there are no
//              races and no atomics; an id outside [0, R) is skipped (how a
//              frontier's pad lanes are dropped); every row no id names
//              keeps its bits.
// Both are exact copies: on the card they equal their plain versions bit
// for bit.  K6b is the second launch of every continuous-serving tick
// (ops.frontier_megastep routes the staged frontier states to their arena
// rows) and the scatter of the op-by-op frontier leg; K6a reads the
// finished roots out of the arena at retirement (ops.gather_rows).
//
// Design.  The Pallas kernels walk one [1, 512] row block per grid step,
// the index map steering the DMA.  Here one warp copies one row and a
// block of 8 warps takes 8 consecutive rows; the warp's lanes walk the row
// in the widest vector (16, 8, 4 or 2 bytes) that divides the row's
// length in bytes, both row strides and both base pointers, so a row of
// fp32 H = 512 moves as 16-byte vectors and an odd-width bf16 row element by
// element.  No shared memory, no synchronisation.
//
// Bound on an H100 SXM (3.35 TB/s): bytes -- the n indices and n rows read
// once and n rows written once.  A continuous Tree-LSTM tick (n = 256 lanes,
// S = 1024 fp32) moves 2 MB: 0.6 us, so a launch is bound by its latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;        // rows per block, one warp per row
constexpr int NT = 32 * WARPS;  // 256 threads

template <typename V>
__global__ void __launch_bounds__(NT)
gather_rows_kernel(char* __restrict__ out, const char* __restrict__ src,
                   const int* __restrict__ idx, int n, int R, int nv,
                   long long src_stride, long long out_stride) {
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;
  const int lane = threadIdx.x & 31;
  const int r = idx[i];
  V* o = reinterpret_cast<V*>(out + (long long)i * out_stride);
  if (r < 0 || r >= R) {
    const V zero{};
    for (int v = lane; v < nv; v += 32) o[v] = zero;
    return;
  }
  const V* s = reinterpret_cast<const V*>(src + (long long)r * src_stride);
  for (int v = lane; v < nv; v += 32) o[v] = s[v];
}

template <typename V>
__global__ void __launch_bounds__(NT)
scatter_rows_kernel(char* __restrict__ dst, const char* __restrict__ rows,
                    const int* __restrict__ idx, int n, int R, int nv,
                    long long dst_stride, long long rows_stride) {
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;
  const int r = idx[i];
  if (r < 0 || r >= R) return;                    // a dropped pad lane
  const int lane = threadIdx.x & 31;
  V* d = reinterpret_cast<V*>(dst + (long long)r * dst_stride);
  const V* s = reinterpret_cast<const V*>(rows + (long long)i * rows_stride);
  for (int v = lane; v < nv; v += 32) d[v] = s[v];
}

// The widest vector, in bytes, that divides every one of these.
int vector_bytes(const void* a, const void* b, long long row_bytes,
                 long long stride_a, long long stride_b) {
  const unsigned long long m =
      (unsigned long long)(uintptr_t)a | (unsigned long long)(uintptr_t)b |
      (unsigned long long)row_bytes | (unsigned long long)stride_a |
      (unsigned long long)stride_b;
  for (int w = 16; w > 1; w /= 2)
    if (m % w == 0) return w;
  return 1;
}

// One launch with vectors of type V; `a` is the destination.
template <typename V, bool GATHER>
cudaError_t launch_as(char* a, const char* b, const int* idx, int n, int R,
                      long long row_bytes, long long stride_a,
                      long long stride_b, cudaStream_t s) {
  const int nv = (int)(row_bytes / (long long)sizeof(V));
  const int grid = (n + WARPS - 1) / WARPS;
  if constexpr (GATHER)
    gather_rows_kernel<V><<<grid, NT, 0, s>>>(a, b, idx, n, R, nv, stride_b,
                                              stride_a);
  else
    scatter_rows_kernel<V><<<grid, NT, 0, s>>>(a, b, idx, n, R, nv, stride_a,
                                               stride_b);
  return cudaGetLastError();
}

template <bool GATHER>
int launch(void* a, const void* b, const void* idx, int n, int R, int D,
           int elem_bytes, int stride_a, int stride_b, void* stream) {
  if (n <= 0 || D <= 0) return 0;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const long long row_bytes = (long long)D * elem_bytes;
  const long long sa = (long long)stride_a * elem_bytes;
  const long long sb = (long long)stride_b * elem_bytes;
  char* pa = static_cast<char*>(a);
  const char* pb = static_cast<const char*>(b);
  const int* ip = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vector_bytes(a, b, row_bytes, sa, sb)) {
    case 16:
      return (int)launch_as<uint4, GATHER>(pa, pb, ip, n, R, row_bytes, sa,
                                           sb, s);
    case 8:
      return (int)launch_as<uint2, GATHER>(pa, pb, ip, n, R, row_bytes, sa,
                                           sb, s);
    case 4:
      return (int)launch_as<unsigned int, GATHER>(pa, pb, ip, n, R,
                                                  row_bytes, sa, sb, s);
    case 2:
      return (int)launch_as<unsigned short, GATHER>(pa, pb, ip, n, R,
                                                    row_bytes, sa, sb, s);
    default:                          // a pointer not aligned to its element
      return (int)cudaErrorMisalignedAddress;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device
// pointer; `D` is the row width in elements of `elem_bytes` (2 or 4) bytes
// each; strides are in elements; `stream` is a cudaStream_t.  Each returns
// the cudaError_t of its launch (0 on success); cudaErrorInvalidValue for
// another element size.
extern "C" int gather_rows_launch(void* out, const void* src, const void* idx,
                                  int n, int R, int D, int elem_bytes,
                                  int out_stride, int src_stride,
                                  void* stream) {
  return launch<true>(out, src, idx, n, R, D, elem_bytes, out_stride,
                      src_stride, stream);
}

extern "C" int scatter_rows_launch(void* dst, const void* rows,
                                   const void* idx, int n, int R, int D,
                                   int elem_bytes, int dst_stride,
                                   int rows_stride, void* stream) {
  return launch<false>(dst, rows, idx, n, R, D, elem_bytes, dst_stride,
                       rows_stride, stream);
}
