// Mamba-2 SSD intra-chunk scan for Hopper (sm_90a), fp32 math on the CUDA
// cores, f32 or bf16 inputs widened to f32, f32 outputs.
//
// Replaces the TPU kernel of src/repro/kernels/mamba_ssd.py:
//   K12 `ssd_chunk_scan` (:62, its pallas_call at :106, body
//   `_ssd_chunk_kernel` at :29-59).
// It computes what src/repro_torch/kernels/ref.py `ssd_chunk_diag`
// computes.  For each sequence b, chunk c of Q <= 128 positions and head h,
// with a = A[h], da_j = dt_j a and cs the inclusive cumsum of da over the
// chunk:
//
//   y_diag[i, p] = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x[j, p]
//   state[p, n]  = sum_j exp(cs_{Q-1} - cs_j) dt_j x[j, p] B[j, n]
//
// x [Bt, L, H, P], B/C [Bt, L, N] (one B/C group) and dt [Bt, L, H] are
// read through their strides (unit stride along P and N): on the model's
// path x, B and C are views into the conv output, never copied.
// y_diag [Bt, L, H, P] and states [Bt, L/Q, H, P, N] are contiguous f32.
// The cross-chunk recurrence stays in plain PyTorch beside the launch
// (ref.ssd_combine), as the reference keeps it in jnp.
//
// Design.  The Pallas grid runs one (b, h, c) a step and recomputes G = C_c
// B_c^T for every head, though G depends on the chunk only.  Here one CTA of
// 256 threads (a 16 x 16 grid, each thread an 8 x 8 register tile) owns one
// (b, c) and a group of HG heads: it forms G once in shared memory (N in
// slabs of 32) and reuses it over the group.  The wrapper splits the heads
// into the fewest groups that keep >= 132 CTAs in the grid, so every prompt
// of up to 1,024 tokens runs one head a CTA.  Per head: dt x goes to shared
// memory and cs is a warp scan; M = G o exp(cs_i - cs_j) is formed ONLY for
// j <= i (above the diagonal the exponent is positive and can overflow; the
// entries stay an exact 0, never inf * 0); y_diag = M (dt x); then B takes
// M's place, dt x is scaled by the decay to the chunk's end and the state is
// (decayed dt x)^T B.  A ragged chunk (Q = 1, 37, ...) reads only its Q
// rows (its tiles still span 128).  IEEE fp32 throughout (no TF32).  Shared
// memory: G and M at 128 x 129 floats each plus 128 x P for dt x (162 KB at
// P = 64), set through the dynamic-shared-memory attribute: one CTA an SM.
//
// Bound on an H100 SXM: operations.  At a 1,024-token prefill of
// mamba2-370m (Q 128, nc 8, H 32, P 64, N 128), over the Q (Q + 1) / 2
// causal pairs j <= i of a chunk: G once a chunk (2 N a pair = 2.11
// MFLOP) plus 32 heads x (y_diag at 2 P a pair = 1.06 MFLOP, the state at
// 2 Q P N = 2.10 MFLOP) is 0.824 GFLOP: 12.3 us at 67 TFLOP/s fp32; x, B,
// C and dt read once and y_diag and states written once are 26.3 MB: 7.9
// us at 3.35 TB/s.  With one head a CTA (HG = 1 on every prompt of 1,024
// tokens or fewer, so the G sharing is idle on the served path) this
// kernel does 2.15 GFLOP: G once a head over the full square, and the
// full square of M (dt x) too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QM = 128;       // largest chunk
constexpr int NT = 256;       // threads: a 16 x 16 grid
constexpr int TN = 32;        // N-slab of the G product
constexpr int LD = QM + 1;    // padded row of the [QM][QM] buffers
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t smem_bytes(int P) {
  return sizeof(float) * ((size_t)2 * QM * LD + (size_t)QM * P + 2 * QM);
}

// PG: 16-column groups of a thread's y tile (P <= 16 * PG).
template <typename T, int PG>
__global__ void __launch_bounds__(NT)
ssd_chunk_kernel(float* __restrict__ y, float* __restrict__ st,
                 const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, int L, int H, int P, int N, int Q,
                 int HG, long long xsb, long long xsl, long long xsh,
                 long long dsb, long long dsl, long long dsh, long long bsb,
                 long long bsl, long long csb, long long csl) {
  extern __shared__ float smem[];
  float* g = smem;                 // [QM][LD] G = C B^T
  float* m = g + QM * LD;          // [QM][LD] M, G's N-slabs, then B
  float* xs = m + QM * LD;         // [QM][P]  dt x, then decayed
  float* cs = xs + QM * P;         // [QM]     inclusive cumsum of dt a
  float* dts = cs + QM;            // [QM]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nc = L / Q;
  const int b = blockIdx.x / nc, c = blockIdx.x - b * nc;
  const int c0 = c * Q;            // the chunk's first position
  const int h0 = blockIdx.y * HG;

  const T* xb = x + b * xsb + (long long)c0 * xsl;
  const T* Bb = Bm + b * bsb + (long long)c0 * bsl;
  const T* Cb = Cm + b * csb + (long long)c0 * csl;
  const float* db = dt + b * dsb + (long long)c0 * dsl;

  // ---- G = C B^T, once for the CTA's heads ---------------------------------
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
  float* ct = m;                   // [TN][LD] C slab, n-major
  float* bt = m + TN * LD;         // [TN][LD] B slab
  for (int n0 = 0; n0 < N; n0 += TN) {
    for (int e = tid; e < TN * QM; e += NT) {
      const int n = e % TN, i = e / TN;
      const bool ok = i < Q && n0 + n < N;
      ct[n * LD + i] = ok ? to_f(Cb[(long long)i * csl + n0 + n]) : 0.f;
      bt[n * LD + i] = ok ? to_f(Bb[(long long)i * bsl + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < TN; ++n) {
      float a[8], v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = ct[n * LD + ty + 16 * r];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = bt[n * LD + tx + 16 * k];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(a[r], v[k], acc[r][k]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      g[(ty + 16 * r) * LD + tx + 16 * k] = acc[r][k];
  __syncthreads();

  const int hend = min(H, h0 + HG);
  for (int h = h0; h < hend; ++h) {
    // ---- dt, the cumsum of dt a, dt x --------------------------------------
    for (int j = tid; j < Q; j += NT)
      dts[j] = db[(long long)j * dsl + h * dsh];
    __syncthreads();
    if (tid < 32) {
      const float a = A[h];
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * tid + k;
        run += j < Q ? dts[j] * a : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(FULL, incl, o);
        if (tid >= o) incl += up;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) cs[4 * tid + k] = excl + v[k];
    }
    for (int e = tid; e < Q * P; e += NT) {
      const int j = e / P, p = e - j * P;
      xs[e] = dts[j] * to_f(xb[(long long)j * xsl + h * xsh + p]);
    }
    __syncthreads();

    // ---- M = G o exp(cs_i - cs_j) on j <= i, 0 elsewhere -------------------
    for (int e = tid; e < Q * Q; e += NT) {
      const int i = e / Q, j = e - i * Q;
      m[i * LD + j] = j <= i ? g[i * LD + j] * expf(cs[i] - cs[j]) : 0.f;
    }
    __syncthreads();

    // ---- y_diag = M (dt x) -------------------------------------------------
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < PG; ++k) acc[r][k] = 0.f;
#pragma unroll 2
    for (int j = 0; j < Q; ++j) {
      float a[8], v[PG];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = m[(ty + 16 * r) * LD + j];
#pragma unroll
      for (int k = 0; k < PG; ++k) {
        const int p = tx + 16 * k;
        v[k] = p < P ? xs[j * P + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < PG; ++k) acc[r][k] = fmaf(a[r], v[k], acc[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= Q) continue;
      float* yr = y + (((long long)b * L + c0 + i) * H + h) * P;
#pragma unroll
      for (int k = 0; k < PG; ++k) {
        const int p = tx + 16 * k;
        if (p < P) yr[p] = acc[r][k];
      }
    }
    __syncthreads();

    // ---- B in M's place; dt x decayed to the chunk's end -------------------
    for (int e = tid; e < Q * N; e += NT) {
      const int j = e / N, n = e - j * N;
      m[j * LD + n] = to_f(Bb[(long long)j * bsl + n]);
    }
    const float last = cs[Q - 1];
    for (int e = tid; e < Q * P; e += NT) xs[e] *= expf(last - cs[e / P]);
    __syncthreads();

    // ---- state = (decayed dt x)^T B: rows p, columns n ---------------------
#pragma unroll
    for (int r = 0; r < PG; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
#pragma unroll 2
    for (int j = 0; j < Q; ++j) {
      float a[PG], v[8];
#pragma unroll
      for (int r = 0; r < PG; ++r) {
        const int p = ty + 16 * r;
        a[r] = p < P ? xs[j * P + p] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = tx + 16 * k;
        v[k] = n < N ? m[j * LD + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < PG; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(a[r], v[k], acc[r][k]);
    }
    float* sb = st + (((long long)blockIdx.x * H + h) * P) * N;
#pragma unroll
    for (int r = 0; r < PG; ++r) {
      const int p = ty + 16 * r;
      if (p >= P) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = tx + 16 * k;
        if (n < N) sb[(long long)p * N + n] = acc[r][k];
      }
    }
    __syncthreads();
  }
}

template <typename T, int PG>
int launch_t(float* y, float* st, const void* x, const float* dt,
             const float* A, const void* B, const void* C, int Bt, int L,
             int H, int P, int N, int Q, int HG, const long long* s,
             cudaStream_t stream) {
  auto kern = ssd_chunk_kernel<T, PG>;
  const size_t smem = smem_bytes(P);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Bt * (L / Q), (H + HG - 1) / HG);
  kern<<<grid, NT, smem, stream>>>(
      y, st, static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), L, H, P, N, Q, HG, s[0], s[1], s[2], s[3],
      s[4], s[5], s[6], s[7], s[8], s[9]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_p(float* y, float* st, const void* x, const float* dt,
             const float* A, const void* B, const void* C, int Bt, int L,
             int H, int P, int N, int Q, int HG, const long long* s,
             cudaStream_t stream) {
  if (P <= 16)
    return launch_t<T, 1>(y, st, x, dt, A, B, C, Bt, L, H, P, N, Q, HG, s,
                          stream);
  if (P <= 32)
    return launch_t<T, 2>(y, st, x, dt, A, B, C, Bt, L, H, P, N, Q, HG, s,
                          stream);
  if (P <= 64)
    return launch_t<T, 4>(y, st, x, dt, A, B, C, Bt, L, H, P, N, Q, HG, s,
                          stream);
  return launch_t<T, 8>(y, st, x, dt, A, B, C, Bt, L, H, P, N, Q, HG, s,
                        stream);
}

}  // namespace

// Strides in elements: x (batch, position, head), dt (batch, position,
// head), B and C (batch, position); unit stride along P and N.  dt and A
// are f32; x, B and C f32 (bf16 = 0) or bf16 (bf16 = 1).  y_diag is a
// contiguous [Bt, L, H, P] and states a contiguous [Bt, L/Q, H, P, N] f32
// tensor.  Returns the CUDA error of the launch (0: in the stream).
extern "C" int ssd_chunk_launch(
    void* y, void* states, const void* x, const void* dt, const void* A,
    const void* B, const void* C, int Bt, int L, int H, int P, int N, int Q,
    int HG, long long xsb, long long xsl, long long xsh, long long dsb,
    long long dsl, long long dsh, long long bsb, long long bsl, long long csb,
    long long csl, int bf16, void* stream) {
  if (Bt <= 0 || L <= 0 || H <= 0) return 0;
  if (Q < 1 || Q > QM || L % Q != 0 || P < 1 || P > 128 || N < 1 ||
      N > QM || HG < 1 || H > 65535 * HG)
    return (int)cudaErrorInvalidValue;
  const long long s[10] = {xsb, xsl, xsh, dsb, dsl, dsh, bsb, bsl, csb, csl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(states);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  if (bf16)
    return launch_p<__nv_bfloat16>(yo, so, x, d, a, B, C, Bt, L, H, P, N, Q,
                                   HG, s, st);
  return launch_p<float>(yo, so, x, d, a, B, C, Bt, L, H, P, N, Q, HG, s,
                         st);
}
