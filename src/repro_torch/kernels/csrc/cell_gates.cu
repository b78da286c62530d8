// The fused gate chains of the op-by-op leg, for Hopper (sm_90a): the LSTM
// gates (K8a) and the child-sum Tree-LSTM gates (K8b), elementwise, fp32
// math on the CUDA cores.
//
// Replaces the TPU kernels of src/repro/kernels/cell_kernels.py:
//   K8a `lstm_gates`     (:46, its pallas_call at :58),
//   K8b `treelstm_gates` (:86, its pallas_call at :102).
// Each computes what src/repro_torch/kernels/ref.py `lstm_gates` /
// `treelstm_gates` compute, for every (m, j) of [M, H]:
//
//   K8a  gates [M, 4H] (lanes i|f|o|u), c_prev [M, H]:
//        c = sigmoid(f + 1.0) * c_prev + sigmoid(i) * tanh(u)
//        h = sigmoid(o) * tanh(c)              (c, h at gates' type)
//   K8b  i/o/u_pre [M, H], f_pre and c_k [M, A, H], child_mask [M, A]:
//        c = sigmoid(i) * tanh(u) + sum_a sigmoid(f_a) * c_a * mask_a
//        h = sigmoid(o) * tanh(c)              (no +1; c, h at i_pre's type)
//
// Every operand is read at its own type (float or bf16) through its own row
// strides, and the math runs in fp32 (expf/tanhf, no fast math).  On the
// main path c_prev is the c half of the gathered [M, 2H] state and c_k the
// c half of the [M, A, 2H] masked child states: strided views, read in
// place, never copied.  The outputs are two fresh contiguous [M, H]
// tensors.
//
// Design.  The Pallas kernels tile [M, H] into (bm, bh) blocks padded to
// 128 lanes.  Here a thread owns V consecutive columns of one row:
// consecutive threads read consecutive addresses and the ragged edge is
// masked, not padded.  K8b sums the A children in the fixed order
// a = 0..A-1, so two launches are bitwise equal.
//
// K8a's geometry.  With V = 4 and 256-thread blocks, a Var-LSTM level (M =
// 128, H = 512) would be 64 CTAs on the card's 132 SMs: half the SMs idle,
// and each busy one with 8 warps that issue their five loads once and then
// wait.  So the host (cell_kernels.k8a_geometry) picks V and the block
// size from M * H and the SM count: the first of (4, 256), (4, 128),
// (2, 128), (4, 64), (2, 64) whose grid puts at least two CTAs on every
// SM, else (2, 64), the most CTAs.  At M 128, H 512 that is V 2 in blocks
// of 64: 512 CTAs, twice the threads, each with half the loads and math,
// on every SM.  Where a 4-wide vector does not fit (a row stride, column
// offset or pointer off 4 elements) a thread owns one column, in blocks of
// 256.  Each thread still issues its five loads before any math, and the
// math (expf/tanhf, no fast math, the same order) is V's lane by lane, so
// every output keeps its bits whatever the geometry.
//
// Bound on an H100 SXM (3.35 TB/s): no reuse, so bytes.  A Var-LSTM level
// (M = 128, H = 512, f32) reads 5 * 256 KB and writes 512 KB: 1.8 MB, 0.55
// us, about a launch's own latency.  K8b moves
// (5 + 2A) * M * H elements plus the mask: 4.7 MB for a served Tree-LSTM
// level of M = 256 slots at A = 2, H = 512 (1.4 us).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Widening loads and narrowing stores for the two element types.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as .to(bf16)
}

// V elements of type T in one aligned load or store.
template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Pack<T, V> x = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = to_f32(x.v[e]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Pack<T, V> x;
#pragma unroll
  for (int e = 0; e < V; ++e) x.v[e] = from_f32<T>(in[e]);
  *reinterpret_cast<Pack<T, V>*>(p) = x;
}

// K8a.  TG: gates' (and the outputs') type; TC: c_prev's.  Blocks of up
// to NT threads (the host's geometry).
template <typename TG, typename TC, int V>
__global__ void __launch_bounds__(NT)
lstm_gates_kernel(TG* __restrict__ c_out, TG* __restrict__ h_out,
                  const TG* __restrict__ gates, const TC* __restrict__ c_prev,
                  int M, int H, int g_stride, int c_stride) {
  const int cols = H / V;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)M * cols) return;
  const int m = (int)(t / cols);
  const int j = (int)(t % cols) * V;
  const TG* g = gates + (size_t)m * g_stride + j;
  float i[V], f[V], o[V], u[V], cp[V], c[V], h[V];
  load<TG, V>(g, i);
  load<TG, V>(g + H, f);
  load<TG, V>(g + 2 * H, o);
  load<TG, V>(g + 3 * H, u);
  load<TC, V>(c_prev + (size_t)m * c_stride + j, cp);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    c[e] = sigmoid_f(f[e] + 1.0f) * cp[e] + sigmoid_f(i[e]) * tanhf(u[e]);
    h[e] = sigmoid_f(o[e]) * tanhf(c[e]);
  }
  store<TG, V>(c_out + (size_t)m * H + j, c);
  store<TG, V>(h_out + (size_t)m * H + j, h);
}

// K8b.  TP: the pre-activations' (and the outputs') type; TS: the type of
// c_k and child_mask (the node buffer's).
template <typename TP, typename TS>
__global__ void __launch_bounds__(NT)
treelstm_gates_kernel(TP* __restrict__ c_out, TP* __restrict__ h_out,
                      const TP* __restrict__ i_pre,
                      const TP* __restrict__ f_pre,
                      const TP* __restrict__ o_pre,
                      const TP* __restrict__ u_pre,
                      const TS* __restrict__ c_k,
                      const TS* __restrict__ mask, int M, int A, int H,
                      int i_stride, int o_stride, int u_stride, int f_sm,
                      int f_sa, int c_sm, int c_sa, int k_sm, int k_sa) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= (long long)M * H) return;
  const int m = (int)(t / H);
  const int j = (int)(t % H);
  float sum = 0.0f;
  for (int a = 0; a < A; ++a) {
    const float f = sigmoid_f(
        to_f32(f_pre[(size_t)m * f_sm + (size_t)a * f_sa + j]));
    const float c = to_f32(c_k[(size_t)m * c_sm + (size_t)a * c_sa + j]);
    const float k = to_f32(mask[(size_t)m * k_sm + (size_t)a * k_sa]);
    sum += f * c * k;
  }
  const float i = sigmoid_f(to_f32(i_pre[(size_t)m * i_stride + j]));
  const float o = sigmoid_f(to_f32(o_pre[(size_t)m * o_stride + j]));
  const float u = tanhf(to_f32(u_pre[(size_t)m * u_stride + j]));
  const float c = i * u + sum;
  c_out[(size_t)m * H + j] = from_f32<TP>(c);
  h_out[(size_t)m * H + j] = from_f32<TP>(o * tanhf(c));
}

inline unsigned blocks(long long n) { return (unsigned)((n + NT - 1) / NT); }

template <typename TG, typename TC, int V>
void lstm_gates_as(void* c_out, void* h_out, const void* gates,
                   const void* c_prev, int M, int H, int g_stride,
                   int c_stride, int nt, cudaStream_t stream) {
  const long long n = (long long)M * (H / V);
  lstm_gates_kernel<TG, TC, V>
      <<<(unsigned)((n + nt - 1) / nt), nt, 0, stream>>>(
          static_cast<TG*>(c_out), static_cast<TG*>(h_out),
          static_cast<const TG*>(gates), static_cast<const TC*>(c_prev), M,
          H, g_stride, c_stride);
}

template <typename TG, typename TC>
int lstm_gates_launch_t(void* c_out, void* h_out, const void* gates,
                        const void* c_prev, int M, int H, int g_stride,
                        int c_stride, int V, int nt, cudaStream_t stream) {
  // A V-wide vector needs every row start and the lane offsets H, 2H, 3H
  // on a multiple of V elements, and aligned base pointers.
  const bool fits = H % V == 0 && g_stride % V == 0 && c_stride % V == 0 &&
                    (uintptr_t)gates % (V * sizeof(TG)) == 0 &&
                    (uintptr_t)c_prev % (V * sizeof(TC)) == 0 &&
                    (uintptr_t)c_out % (V * sizeof(TG)) == 0 &&
                    (uintptr_t)h_out % (V * sizeof(TG)) == 0;
  if (!fits) return (int)cudaErrorMisalignedAddress;
  if (V == 4)
    lstm_gates_as<TG, TC, 4>(c_out, h_out, gates, c_prev, M, H, g_stride,
                             c_stride, nt, stream);
  else if (V == 2)
    lstm_gates_as<TG, TC, 2>(c_out, h_out, gates, c_prev, M, H, g_stride,
                             c_stride, nt, stream);
  else
    lstm_gates_as<TG, TC, 1>(c_out, h_out, gates, c_prev, M, H, g_stride,
                             c_stride, nt, stream);
  return (int)cudaGetLastError();
}

template <typename TP, typename TS>
int treelstm_gates_launch_t(void* c_out, void* h_out, const void* i_pre,
                            const void* f_pre, const void* o_pre,
                            const void* u_pre, const void* c_k,
                            const void* mask, int M, int A, int H,
                            const int* s, cudaStream_t stream) {
  treelstm_gates_kernel<TP, TS><<<blocks((long long)M * H), NT, 0, stream>>>(
      static_cast<TP*>(c_out), static_cast<TP*>(h_out),
      static_cast<const TP*>(i_pre), static_cast<const TP*>(f_pre),
      static_cast<const TP*>(o_pre), static_cast<const TP*>(u_pre),
      static_cast<const TS*>(c_k), static_cast<const TS*>(mask), M, A, H,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device
// pointer; strides count elements; a `*_bf16` flag picks bf16 over float
// for that operand; `stream` is a cudaStream_t.  Each returns the
// cudaError_t of its launch (0 on success; nothing is launched for an
// empty shape); cudaErrorInvalidValue for a grid too large.

// K8a: `vec` columns a thread (1, 2 or 4) in blocks of `nt` threads (32..NT,
// a multiple of 32), as cell_kernels.k8a_geometry chose them;
// cudaErrorMisalignedAddress where a `vec`-wide vector does not fit.
extern "C" int lstm_gates_launch(void* c_out, void* h_out, const void* gates,
                                 const void* c_prev, int M, int H,
                                 int g_stride, int c_stride, int gates_bf16,
                                 int c_bf16, int vec, int nt, void* stream) {
  if (M <= 0 || H <= 0) return 0;
  if ((vec != 1 && vec != 2 && vec != 4) || nt < 32 || nt > NT || nt % 32 ||
      (long long)M * H > (long long)nt * 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gates_bf16) {
    return c_bf16 ? lstm_gates_launch_t<__nv_bfloat16, __nv_bfloat16>(
                        c_out, h_out, gates, c_prev, M, H, g_stride, c_stride,
                        vec, nt, st)
                  : lstm_gates_launch_t<__nv_bfloat16, float>(
                        c_out, h_out, gates, c_prev, M, H, g_stride, c_stride,
                        vec, nt, st);
  }
  return c_bf16 ? lstm_gates_launch_t<float, __nv_bfloat16>(
                      c_out, h_out, gates, c_prev, M, H, g_stride, c_stride,
                      vec, nt, st)
                : lstm_gates_launch_t<float, float>(c_out, h_out, gates,
                                                    c_prev, M, H, g_stride,
                                                    c_stride, vec, nt, st);
}

// Strides: i, o, u rows; f_pre (row, child); c_k (row, child); child_mask
// (row, child).
extern "C" int treelstm_gates_launch(
    void* c_out, void* h_out, const void* i_pre, const void* f_pre,
    const void* o_pre, const void* u_pre, const void* c_k, const void* mask,
    int M, int A, int H, int i_stride, int o_stride, int u_stride, int f_sm,
    int f_sa, int c_sm, int c_sa, int k_sm, int k_sa, int pre_bf16,
    int state_bf16, void* stream) {
  if (M <= 0 || H <= 0) return 0;
  if (A < 1 || (long long)M * H > (long long)NT * 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int s[9] = {i_stride, o_stride, u_stride, f_sm, f_sa,
                    c_sm,     c_sa,     k_sm,     k_sa};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pre_bf16) {
    return state_bf16
               ? treelstm_gates_launch_t<__nv_bfloat16, __nv_bfloat16>(
                     c_out, h_out, i_pre, f_pre, o_pre, u_pre, c_k, mask, M,
                     A, H, s, st)
               : treelstm_gates_launch_t<__nv_bfloat16, float>(
                     c_out, h_out, i_pre, f_pre, o_pre, u_pre, c_k, mask, M,
                     A, H, s, st);
  }
  return state_bf16 ? treelstm_gates_launch_t<float, __nv_bfloat16>(
                          c_out, h_out, i_pre, f_pre, o_pre, u_pre, c_k, mask,
                          M, A, H, s, st)
                    : treelstm_gates_launch_t<float, float>(
                          c_out, h_out, i_pre, f_pre, o_pre, u_pre, c_k, mask,
                          M, A, H, s, st);
}
