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
// for bit.  K6a reads the finished roots out of the continuous engine's
// arena at retirement (ops.gather_rows, once a retiring window); K6b is the
// scatter of a tick on the op-by-op frontier leg.
//
// Design.  The Pallas kernels walk one [1, 512] row block per grid step,
// the index map steering the DMA.  Here the threads walk a row in the
// widest vector (16, 8, 4 or 2 bytes) that divides the row's length in
// bytes and every row stride and base pointer, so a row of fp32 H = 512
// moves as 16-byte vectors and an odd-width bf16 row element by element.
// K6b: one warp a row, a block of 8 warps 8 consecutive rows.  K6a: one
// block of 256 threads a row, so a retiring window's ~8 rows spread over
// ~8 SMs (a 1,024-float row is one 16-byte vector a thread) and 8 warps a
// row issue the host stores below: at a window's n, that timed faster on
// an H100 than a warp a row, with or without the host stores.  No shared
// memory, no synchronisation.
//
// K6a's cost is not its bytes but the copies around it: a retiring window
// used to copy its few root ids to the card, launch, and copy the roots
// back (a second sync after the head's).  So K6a takes the ids BY VALUE,
// up to GATHER_CAP of them in the launch's own parameters (2 KB of the 4 KB
// a launch may carry, read through __grid_constant__ without a local
// copy), and stores each row twice: to `out` on the card, which the heads
// read, and through the mapped device address of a page-locked host buffer
// (cudaHostGetDevicePointer; under unified addressing the host's own
// pointer) straight into host memory.  The window's one sync -- the head's
// logits, or the stream's -- then covers both; no copy of ids or rows is
// enqueued.  More ids than GATHER_CAP take one launch per GATHER_CAP.
// K6b keeps its ids on the card: the op-by-op leg's ids live there.
//
// Bound on an H100 SXM (3.35 TB/s): bytes -- the n ids, the n rows read
// once and written once (K6a: twice, the second copy over the host link,
// which took ~47 GB/s at n 256).  A retiring window (n ~ 8 roots, D = 1024
// fp32) moves 96 KB: 0.03 us, so a launch is bound by its latency and, for
// K6a, by the host link's.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int WARPS = 8;        // rows per block, one warp per row
constexpr int NT = 32 * WARPS;  // 256 threads

// K6a's ids, carried in the launch's parameters.
constexpr int GATHER_CAP = 512;
struct RowIds {
  int v[GATHER_CAP];
};

// K6a: a block a row, its threads over the row's vectors.
template <typename V>
__global__ void __launch_bounds__(NT)
gather_rows_kernel(char* __restrict__ out, char* __restrict__ host,
                   const char* __restrict__ src,
                   const __grid_constant__ RowIds ids, int R, int nv,
                   long long src_stride, long long out_stride,
                   long long host_stride) {
  const int i = blockIdx.x;
  const int r = ids.v[i];
  V* o = reinterpret_cast<V*>(out + (long long)i * out_stride);
  V* h = host ? reinterpret_cast<V*>(host + (long long)i * host_stride)
              : nullptr;
  if (r < 0 || r >= R) {
    const V zero{};
    for (int v = threadIdx.x; v < nv; v += NT) {
      o[v] = zero;
      if (h) h[v] = zero;
    }
    return;
  }
  const V* s = reinterpret_cast<const V*>(src + (long long)r * src_stride);
  for (int v = threadIdx.x; v < nv; v += NT) {
    const V x = s[v];
    o[v] = x;
    if (h) h[v] = x;
  }
}

// K6b: a warp a row, a block of WARPS rows.
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

// Calls f with a value of the widest vector type whose size in bytes
// divides `m` (the OR of every base pointer, stride and the row's length
// in bytes); cudaErrorMisalignedAddress for a pointer not aligned to its
// element.
template <typename F>
int by_vector(unsigned long long m, F&& f) {
  if (m % 16 == 0) return f(uint4{});
  if (m % 8 == 0) return f(uint2{});
  if (m % 4 == 0) return f(0u);
  if (m % 2 == 0) return f((unsigned short)0);
  return (int)cudaErrorMisalignedAddress;
}

inline unsigned long long bits(const void* p) {
  return (unsigned long long)(uintptr_t)p;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  `D` is the row width in
// elements of `elem_bytes` (2 or 4) bytes each; strides are in elements;
// `stream` is a cudaStream_t.  Each launch returns the cudaError_t of its
// launch (0 on success); cudaErrorInvalidValue for another element size.

// K6a.  `out` and `src` are device pointers; `host_out` is the device
// address of a mapped page-locked host buffer (host_device_pointer), or
// null for none; `ids` is a HOST pointer to n <= GATHER_CAP int32 ids,
// copied into the launch's parameters before this returns.
extern "C" int gather_rows_launch(void* out, void* host_out, const void* src,
                                  const int* ids, int n, int R, int D,
                                  int elem_bytes, int out_stride,
                                  int src_stride, int host_stride,
                                  void* stream) {
  if (n <= 0 || D <= 0) return 0;
  if (n > GATHER_CAP || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  RowIds p;
  memcpy(p.v, ids, sizeof(int) * (size_t)n);
  const long long row = (long long)D * elem_bytes;
  const long long so = (long long)out_stride * elem_bytes;
  const long long ss = (long long)src_stride * elem_bytes;
  const long long sh = (long long)host_stride * elem_bytes;
  unsigned long long m = bits(out) | bits(src) | (unsigned long long)row |
                         (unsigned long long)so | (unsigned long long)ss;
  if (host_out) m |= bits(host_out) | (unsigned long long)sh;
  char* o = static_cast<char*>(out);
  char* h = static_cast<char*>(host_out);
  const char* s = static_cast<const char*>(src);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_vector(m, [&](auto v) {
    using V = decltype(v);
    gather_rows_kernel<V><<<n, NT, 0, st>>>(
        o, h, s, p, R, (int)(row / (long long)sizeof(V)), ss, so, sh);
    return (int)cudaGetLastError();
  });
}

// K6b.  Every pointer is a device pointer.
extern "C" int scatter_rows_launch(void* dst, const void* rows,
                                   const void* idx, int n, int R, int D,
                                   int elem_bytes, int dst_stride,
                                   int rows_stride, void* stream) {
  if (n <= 0 || D <= 0) return 0;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const long long row = (long long)D * elem_bytes;
  const long long sd = (long long)dst_stride * elem_bytes;
  const long long sr = (long long)rows_stride * elem_bytes;
  char* d = static_cast<char*>(dst);
  const char* r = static_cast<const char*>(rows);
  const int* ip = static_cast<const int*>(idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (n + WARPS - 1) / WARPS;
  return by_vector(bits(dst) | bits(rows) | (unsigned long long)row |
                       (unsigned long long)sd | (unsigned long long)sr,
                   [&](auto v) {
                     using V = decltype(v);
                     scatter_rows_kernel<V><<<grid, NT, 0, st>>>(
                         d, r, ip, n, R, (int)(row / (long long)sizeof(V)),
                         sd, sr);
                     return (int)cudaGetLastError();
                   });
}

// The device address of the page-locked host memory at `host` (the base of
// a cudaHostAlloc'd block, or a pointer into one), written to `*dev`.
// Returns the cudaError_t (cudaErrorInvalidValue for memory that is not
// mapped), clearing it so that it is not reported by a later launch.
extern "C" int host_device_pointer(void* host, void** dev) {
  *dev = nullptr;
  const cudaError_t e = cudaHostGetDevicePointer(dev, host, 0);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
