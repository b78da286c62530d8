// Blocked online-softmax attention (flash attention, forward) for Hopper
// (sm_90a), fp32 math on the CUDA cores, f32 or bf16 operands.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   K10 `flash_attention` (:88, its pallas_call at :109).
// It computes what src/repro_torch/kernels/ref.py `mha` computes:
//
//   q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] (Hq % Hkv == 0) -> o [B, Hq, Sq, D]
//   o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
//
// over the keys j valid for query i, which sits at key position
// p = i + Sk - Sq (the ends aligned): j < Sk, and j <= p under `causal`,
// and j > p - window under a window (`window` > 0).  G = Hq / Hkv folds each
// query head onto its KV head (GQA) with no copy of K or V.  The output is
// at q's type; a query with no valid key gets a zero row.  q, k and v are
// read through their batch, head and row strides (unit stride along D), so
// the projections' permuted views go in without a copy.
//
// Design.  The Pallas kernel walks a (B, Hq, Sq/bq, Sk/bk) grid in order,
// carrying the running max, sum and accumulator in VMEM scratch across the
// key axis, its statistics replicated over 128 lanes, the sequence padded
// to a block multiple.  Here one CTA of 128 threads owns one (b, query
// head, tile of BQ = 32 query rows) and loops over the key tiles itself:
//   - the Q tile and each K/V tile of BK = 32 rows are staged in shared
//     memory as fp32 (rows padded to D + 1 words, so the threads of a warp
//     that read different rows hit different banks), each K/V tile shared
//     by the tile's 32 query rows;
//   - four threads own one query row: each scores 8 of the tile's 32 keys,
//     the row's max and sum combine over the four by warp shuffles, and
//     each thread keeps a quarter of the row's fp32 accumulator (head dims
//     t, t + 4, ...) in registers with the running max and sum;
//   - the probabilities of a tile go through a per-row strip of shared
//     memory (the row's four threads are one warp, so a __syncwarp orders
//     them) for P.V;
//   - the ragged ends (Sq, Sk not multiples of 32) are masked, not padded;
//     key tiles wholly above the causal diagonal or wholly before the
//     window are never loaded.
// Masked scores are -inf and contribute exactly 0 (the Pallas kernel's
// -1e30 stand-in gives the mean of V for a query with no valid key).
//
// Bound on an H100 SXM: 4 * D FLOPs a head for every pair of a query and
// a key it sees (QK^T and PV) at 989 TFLOP/s, the bf16 tensor-core rate,
// against q, k, v and o each moved once at 3.35 TB/s.  A granite-3-8b
// prefill of a 1,024-token bucket (Hq 32, Hkv 8, D 128, causal) is 8.6
// GFLOP, 8.7 us, against 21 MB of bytes, 6.3 us: bound by operations.
// This kernel runs its products as fp32 FMAs on the CUDA cores (67
// TFLOP/s peak) and reads an operand from shared memory for about every
// FMA, so it stays far from either bound.  It is the route for f32
// operands (which the fp32 constraint keeps off the tensor cores) and for
// bf16 head dims that are not a multiple of 16; bf16 operands with
// D % 16 == 0 take flash_attention_sm90.cu (wgmma for QK^T and PV, fed by
// TMA), chosen by flash_attention.py's `route`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;            // query rows per CTA
constexpr int BK = 32;            // keys per tile
constexpr int TPR = 4;            // threads per query row
constexpr int NT = BQ * TPR;      // 128 threads
constexpr int CPT = BK / TPR;     // keys each thread scores per tile: 8
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

// Dynamic shared memory of a CTA for head dim D: Q, K and V tiles of
// D + 1 words a row, and a BQ x (BK + 1) strip of probabilities.
size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
}

// DPT: head dims each thread accumulates, D <= TPR * DPT.
template <typename T, int DPT>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(T* __restrict__ out, const T* __restrict__ q,
                       const T* __restrict__ k, const T* __restrict__ v,
                       int Hq, int Hkv, int Sq, int Sk, int D,
                       long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss,
                       float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int LD = D + 1;
  float* sq = smem;                  // [BQ][LD]
  float* sk = sq + BQ * LD;          // [BK][LD]
  float* sv = sk + BK * LD;          // [BK][LD]
  float* sp = sv + BK * LD;          // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int r = tid / TPR;           // this thread's query row in the tile
  const int c0 = tid % TPR;          // its first key column and head dim
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Sk - Sq;           // query i sits at key position i + off
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, d = i - rr * D;
    sq[rr * LD + d] =
        q0 + rr < Sq ? to_f(qb[(long long)(q0 + rr) * qss + d]) : 0.f;
  }

  // The keys any row of the tile can see: [kbeg, kend).
  const int plo = q0 + off;
  const int phi = min(q0 + BQ, Sq) - 1 + off;
  const int kend = causal ? min(Sk, phi + 1) : Sk;
  const int kbeg = window > 0 ? max(0, plo - window + 1) : 0;

  const int qi = q0 + r;
  const int p = qi + off;
  const bool live = qi < Sq;
  float m = -INFINITY, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float* pr = sp + r * (BK + 1);

  for (int k0 = kbeg / BK * BK; k0 < kend; k0 += BK) {
    __syncthreads();                 // the last tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int rr = i / D, d = i - rr * D;
      const int kr = k0 + rr;
      const bool in = kr < Sk;
      sk[rr * LD + d] = in ? to_f(kb[(long long)kr * kss + d]) : 0.f;
      sv[rr * LD + d] = in ? to_f(vb[(long long)kr * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = 0.f;
    const float* qr = sq + r * LD;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        s[j] = fmaf(qd, sk[(c0 + TPR * j) * LD + d], s[j]);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int kp = k0 + c0 + TPR * j;
      const bool ok = live && kp < Sk && (!causal || kp <= p) &&
                      (window <= 0 || kp > p - window);
      s[j] = ok ? s[j] * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 2));
    const float mnew = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float pj = s[j] == -INFINITY ? 0.f : expf(s[j] - mnew);
      pr[c0 + TPR * j] = pj;
      psum += pj;
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    // Nothing accumulated while m is -inf, so alpha only has to be finite.
    const float alpha = m == -INFINITY ? 0.f : expf(m - mnew);
    l = l * alpha + psum;
    m = mnew;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float pc = pr[c];
      const float* vr = sv + c * LD;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = c0 + TPR * j;
        if (d < D) acc[j] = fmaf(pc, vr[d], acc[j]);
      }
    }
    __syncwarp();                    // pr is rewritten by the next tile
  }

  if (live) {
    T* o = out + (((long long)b * Hq + h) * Sq + qi) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = c0 + TPR * j;
      if (d < D) o[d] = from_f<T>(l > 0.f ? acc[j] / l : 0.f);
    }
  }
}

template <typename T, int DPT>
int launch_t(void* out, const void* q, const void* k, const void* v, int B,
             int Hq, int Hkv, int Sq, int Sk, int D, const long long* st,
             float scale, int causal, int window, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, DPT>;
  const size_t smem = smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), Hq, Hkv, Sq, Sk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(void* out, const void* q, const void* k, const void* v, int B,
             int Hq, int Hkv, int Sq, int Sk, int D, const long long* st,
             float scale, int causal, int window, cudaStream_t stream) {
  if (D <= 32)
    return launch_t<T, 8>(out, q, k, v, B, Hq, Hkv, Sq, Sk, D, st, scale,
                          causal, window, stream);
  if (D <= 64)
    return launch_t<T, 16>(out, q, k, v, B, Hq, Hkv, Sq, Sk, D, st, scale,
                           causal, window, stream);
  if (D <= 128)
    return launch_t<T, 32>(out, q, k, v, B, Hq, Hkv, Sq, Sk, D, st, scale,
                           causal, window, stream);
  return launch_t<T, 64>(out, q, k, v, B, Hq, Hkv, Sq, Sk, D, st, scale,
                         causal, window, stream);
}

}  // namespace

// Strides in elements: q (batch, head, row), k (batch, head, row),
// v (batch, head, row); unit stride along D.  `window` <= 0: no window.
// The output is a contiguous [B, Hq, Sq, D] tensor of q's type.
extern "C" int flash_attention_launch(
    void* out, const void* q, const void* k, const void* v, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int causal,
    int window, int bf16, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0 || D <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D > 256 || Sk < 0 || Hq > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(out, q, k, v, B, Hq, Hkv, Sq, Sk, D,
                                        st, scale, causal, window, s)
              : launch_d<float>(out, q, k, v, B, Hq, Hkv, Sq, Sk, D, st,
                                scale, causal, window, s);
}
