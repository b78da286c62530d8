// The register-tiled fp32 gate product shared by the Tree-FC forward
// megastep (K5, cell_megastep.cu) and by the fused LSTM level step of the
// op-by-op leg (K9, lstm_level_fused.cu); the gate kernels (K8,
// cell_gates.cu) use its sigmoid and type conversions.  (The forward
// megasteps K1, K3 and K4 and the reverse megastep K2 run the tensor-core
// product of gathered_product.cuh instead.)  Hopper (sm_90a), CUDA cores,
// no TF32 (the 1e-4 fp32 bar).
//
// A block owns a tile of BM slots x BN hidden columns.  For hidden column
// j it accumulates the NG gate lanes j, H+j, ..., (NG-1)H+j of
//
//   X . W,   X[m, a*H + k] = buf[child_ids[m, a], h_off + k]   (a < KA)
//
// with W row-major [KA*H, NG*H]: treefc (NG 1, KA = A, W = wc [A*H, H],
// X = the A child rows side by side; the concatenation never exists in
// memory), the fused LSTM step (NG 4, KA 1, W = W_h [H, 4H], X = the
// h_prev rows).  Every lane of a column lands in the same thread, so the
// gate epilogues stay column-local.  An absent child points at the zero
// sentinel row; it is read as zeros without a load.  The rows of X may be
// float or bf16 (TX); they are widened to fp32 as they are staged, and the
// product stays fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cell {

constexpr int BM = 64;                    // slots per block
constexpr int BN = 64;                    // hidden columns per block
constexpr int BK = 16;                    // depth of one staged chunk
constexpr int TM = 4;                     // slots per thread
constexpr int TN = 4;                     // columns per thread
constexpr int NT = (BM / TM) * (BN / TN); // 256 threads
constexpr int LDM = BM + 4;               // padded row of the slot-major tiles
constexpr int LDN = BN + 4;               // padded row of the transposed weights
constexpr int MAX_A = 4;                  // largest arity taken

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

// Loads the tile's child rows (-1 for an absent child or a slot past M)
// and node mask.  Returns LIVE if a slot of the tile is live
// (node_mask != 0), ORed with KIDS if a slot has a child that is not the
// sentinel.  Every thread of the block must call it.
constexpr int LIVE = 1, KIDS = 2;
__device__ __forceinline__ int load_ids(int (*cid)[BM], float* nm,
                                        const int* __restrict__ child_ids,
                                        const float* __restrict__ node_mask,
                                        int M, int A, int m0, int sentinel) {
  const int tid = threadIdx.x;
  for (int i = tid; i < BM * A; i += NT) {
    const int m = i / A, a = i % A, gm = m0 + m;
    const int row = gm < M ? child_ids[(size_t)gm * A + a] : sentinel;
    cid[a][m] = row == sentinel ? -1 : row;
  }
  for (int i = tid; i < BM; i += NT) {
    nm[i] = (m0 + i) < M ? node_mask[m0 + i] : 0.0f;
  }
  __syncthreads();
  int kid = 0;
  if (tid < BM) {
    for (int a = 0; a < A; ++a) kid |= cid[a][tid] >= 0;
  }
  const int live = __syncthreads_or(tid < BM && nm[tid] != 0.0f);
  const int kids = __syncthreads_or(kid);
  return (live ? LIVE : 0) | (kids ? KIDS : 0);
}

template <int NG>
struct alignas(16) GemmSmem {
  float x[BK][LDM];                       // X chunk, k-major
  float w[NG][BK][BN];                    // W chunk, one panel per lane
};

// acc[q][tm][tn] += sum_k X[ty*TM + tm, k] * W[k, q*H + n0 + tx*TN + tn].
// Every thread of the block must call it (it synchronises).
template <int NG, typename TX = float>
__device__ __forceinline__ void tile_gemm(float (&acc)[NG][TM][TN],
                                          GemmSmem<NG>& sm,
                                          int (*cid)[BM],
                                          const TX* __restrict__ buf,
                                          int buf_stride, int h_off,
                                          const float* __restrict__ w,
                                          int H, int KA, int n0) {
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  const size_t ldw = (size_t)NG * H;
  for (int a = 0; a < KA; ++a) {
    for (int k0 = 0; k0 < H; k0 += BK) {
      // Gather this chunk of each slot's row of child a; consecutive
      // threads read consecutive k of one row.
#pragma unroll
      for (int r = 0; r < (BM * BK) / NT; ++r) {
        const int k = tid % BK;
        const int m = tid / BK + r * (NT / BK);
        const int gk = k0 + k;
        const int row = cid[a][m];
        sm.x[k][m] = (row >= 0 && gk < H)
                         ? to_f32(buf[(size_t)row * buf_stride + h_off + gk])
                         : 0.0f;
      }
      // Stage the chunk of the NG lanes of W for this block's columns.
#pragma unroll
      for (int r = 0; r < (BK * BN) / NT; ++r) {
        const int j = tid % BN;
        const int k = tid / BN + r * (NT / BN);
        const int gk = k0 + k, gj = n0 + j;
        const bool ok = gk < H && gj < H;
        const size_t base = ((size_t)a * H + gk) * ldw + gj;
#pragma unroll
        for (int q = 0; q < NG; ++q)
          sm.w[q][k][j] = ok ? w[base + (size_t)q * H] : 0.0f;
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 x4 = *reinterpret_cast<const float4*>(&sm.x[k][ty * TM]);
        const float xs[TM] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(&sm.w[q][k][tx * TN]);
          const float ws[TN] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int tm = 0; tm < TM; ++tm)
#pragma unroll
            for (int tn = 0; tn < TN; ++tn)
              acc[q][tm][tn] = fmaf(xs[tm], ws[tn], acc[q][tm][tn]);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace cell
