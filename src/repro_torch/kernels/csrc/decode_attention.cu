// Single-token decode attention over a KV cache (flash-decode style) for
// Hopper (sm_90a), fp32 math on the CUDA cores, f32 or bf16 operands.
//
// Replaces the TPU kernel of src/repro/kernels/decode_attention.py:
//   K11 `decode_attention` (:70, its pallas_call at :108).
// It computes what src/repro_torch/kernels/ref.py `decode_attention`
// computes:
//
//   q [B, Hq, D], cache k/v [B, Hkv, S, D], kv_len [B] int32 -> o [B, Hq, D]
//   o[b, h] = softmax_r(scale * q[b, h] . k[b, h / G, r]) v[b, h / G, r]
//
// over the cache rows r with lo <= r < min(kv_len[b], S), lo =
// max(0, kv_len[b] - window) under a window (`window` > 0) and 0 without.
// G = Hq / Hkv query heads share one KV head (GQA).  kv_len stays on the
// card (the engine's per-slot fill levels), so a launch never waits for the
// host.  A sequence with no valid row gets a zero row.  The output is at
// q's type; q and the cache are read through their strides (unit stride
// along D).
//
// Design.  The Pallas kernel walks a (B, Hq, S/bk) grid, one query head
// per step, so a GQA group reads each K/V block G times, and it scans the
// whole padded cache whatever kv_len says.  Here one CTA of 8 warps owns
// one (b, KV head) and up to GC = 8 of its query heads (a larger group is
// split over gridDim.z): every K/V row is read once for the whole group,
// and only the rows [lo, len) are read.  Warp w takes rows lo + w,
// lo + w + 8, ...; its 32 lanes hold D / 32 consecutive-lane slices of the
// row (coalesced), the G query vectors sit in registers, each score is a
// warp-shuffle reduction, and each warp keeps, per head, an fp32 running
// max, sum and accumulator slice (online softmax).  At the end the eight
// warps' partial statistics are combined in shared memory:
//   m = max_w m_w,  l = sum_w l_w e^(m_w - m),  o = sum_w acc_w e^(m_w - m) / l.
//
// Bound on an H100 SXM: bytes.  A cache row of one KV head is 4D bytes of
// K and V at bf16 and carries 4GD FLOPs (QK and PV for G heads): G FLOPs a
// byte, far below the card's ~295.  A granite-3-8b decode layer (8 slots,
// Hkv 8, D 128) reads 4 KB a filled row a slot: 10.5 MB at 320 rows, 3.1
// us at 3.35 TB/s.  With B * Hkv = 64 CTAs, half the card's 132 SMs idle:
// split-KV across CTAs is the later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;             // warps per CTA
constexpr int NT = 32 * NW;       // 256 threads
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Dynamic shared memory: each warp's running max and sum per head, and
// its accumulator per head and dim.
size_t smem_bytes(int GC, int D) {
  return sizeof(float) * (size_t)NW * GC * (D + 2);
}

// DPL: head dims per lane (D <= 32 * DPL); GC: query heads per CTA.
template <typename T, int DPL, int GC>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(T* __restrict__ out, const T* __restrict__ q,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const int* __restrict__ kv_len, int Hq, int Hkv,
                        int S, int D, long long qsb, long long qsh,
                        long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss,
                        float scale, int window) {
  extern __shared__ float smem[];
  float* sm = smem;                  // [NW][GC] running max
  float* sl = sm + NW * GC;          // [NW][GC] running sum
  float* sa = sl + NW * GC;          // [NW][GC][D] accumulators

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = Hq / Hkv;
  const int g0 = blockIdx.z * GC;
  const int ng = min(GC, G - g0);
  const int h0 = hk * G + g0;        // the CTA's first query head

  float qv[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      qv[g][j] = g < ng && d < D
                     ? to_f(q[b * qsb + (long long)(h0 + g) * qsh + d]) * scale
                     : 0.f;
    }

  const int len = min(kv_len[b], S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  float m[GC], l[GC], acc[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  // Every warp runs the same number of iterations (the shuffles below stay
  // uniform); a warp past the end skips the update.
  for (int base = lo; base < len; base += NW) {
    const int row = base + warp;
    const bool in = row < len;
    float kr[DPL], vr[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      const bool ok = in && d < D;
      kr[j] = ok ? to_f(kb[(long long)row * kss + d]) : 0.f;
      vr[j] = ok ? to_f(vb[(long long)row * vss + d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) s = fmaf(qv[g][j], kr[j], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      if (in) {
        const float mnew = fmaxf(m[g], s);
        const float alpha = m[g] == -INFINITY ? 0.f : expf(m[g] - mnew);
        const float p = expf(s - mnew);
        l[g] = l[g] * alpha + p;
        m[g] = mnew;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(p, vr[j], acc[g][j] * alpha);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      sm[warp * GC + g] = m[g];
      sl[warp * GC + g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) sa[(warp * GC + g) * D + d] = acc[g][j];
    }
  }
  __syncthreads();

  for (int i = tid; i < ng * D; i += NT) {
    const int g = i / D, d = i - g * D;
    float mx = -INFINITY;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm[w * GC + g]);
    float lt = 0.f, at = 0.f;
    if (mx != -INFINITY) {
      for (int w = 0; w < NW; ++w) {
        const float mw = sm[w * GC + g];
        if (mw == -INFINITY) continue;
        const float e = expf(mw - mx);
        lt = fmaf(sl[w * GC + g], e, lt);
        at = fmaf(sa[(w * GC + g) * D + d], e, at);
      }
    }
    out[((long long)b * Hq + h0 + g) * D + d] =
        from_f<T>(lt > 0.f ? at / lt : 0.f);
  }
}

template <typename T, int DPL, int GC>
int launch_t(void* out, const void* q, const void* k, const void* v,
             const int* kv_len, int B, int Hq, int Hkv, int S, int D,
             const long long* st, float scale, int window,
             cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, DPL, GC>;
  const size_t smem = smem_bytes(GC, D);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int G = Hq / Hkv;
  const dim3 grid(B, Hkv, (G + GC - 1) / GC);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), kv_len, Hq, Hkv, S,
      D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale,
      window);
  return (int)cudaGetLastError();
}

template <typename T, int DPL>
int launch_g(void* out, const void* q, const void* k, const void* v,
             const int* kv_len, int B, int Hq, int Hkv, int S, int D,
             const long long* st, float scale, int window,
             cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G == 1)
    return launch_t<T, DPL, 1>(out, q, k, v, kv_len, B, Hq, Hkv, S, D, st,
                               scale, window, stream);
  if (G <= 4)
    return launch_t<T, DPL, 4>(out, q, k, v, kv_len, B, Hq, Hkv, S, D, st,
                               scale, window, stream);
  return launch_t<T, DPL, 8>(out, q, k, v, kv_len, B, Hq, Hkv, S, D, st,
                             scale, window, stream);
}

template <typename T>
int launch_d(void* out, const void* q, const void* k, const void* v,
             const int* kv_len, int B, int Hq, int Hkv, int S, int D,
             const long long* st, float scale, int window,
             cudaStream_t stream) {
  if (D <= 32)
    return launch_g<T, 1>(out, q, k, v, kv_len, B, Hq, Hkv, S, D, st, scale,
                          window, stream);
  if (D <= 64)
    return launch_g<T, 2>(out, q, k, v, kv_len, B, Hq, Hkv, S, D, st, scale,
                          window, stream);
  if (D <= 128)
    return launch_g<T, 4>(out, q, k, v, kv_len, B, Hq, Hkv, S, D, st, scale,
                          window, stream);
  return launch_g<T, 8>(out, q, k, v, kv_len, B, Hq, Hkv, S, D, st, scale,
                        window, stream);
}

}  // namespace

// Strides in elements: q (batch, head), k (batch, head, row), v (batch,
// head, row); unit stride along D.  kv_len: [B] int32 on the card.
// `window` <= 0: no window.  The output is a contiguous [B, Hq, D] tensor
// of q's type.
extern "C" int decode_attention_launch(
    void* out, const void* q, const void* k, const void* v,
    const void* kv_len, int B, int Hq, int Hkv, int S, int D, long long qsb,
    long long qsh, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int window,
    int bf16, void* stream) {
  if (B <= 0 || Hq <= 0 || D <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D > 256 || S < 0 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[8] = {qsb, qsh, ksb, ksh, kss, vsb, vsh, vss};
  const int* kvl = static_cast<const int*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(out, q, k, v, kvl, B, Hq, Hkv, S, D,
                                        st, scale, window, s)
              : launch_d<float>(out, q, k, v, kvl, B, Hq, Hkv, S, D, st,
                                scale, window, s);
}
