// The reverse megasteps of kinds lstm, gru and treefc: one reverse batching
// task (one level), for Hopper (sm_90a), fp32 on the CUDA cores.  The
// gradient buffer is updated in place.
//
// Replaces the TPU kernel src/repro/kernels/level_megastep_bwd.py:205
// `bwd_megastep` (its pallas_call at :276), kinds "lstm", "gru" and
// "treefc" (kind "treelstm" is treelstm_bwd_megastep.cu).  It computes what
// src/repro_torch/kernels/ref.py `bwd_megastep(kind, ...)` computes, the
// math of src/repro/kernels/level_megastep.py:353-451.  For each slot m of
// the level, with g_s = g[offset + m] * node_mask[m], x = ext[ext_ids[m]] and
// p the predecessor row buf[child_ids[m, 0]]:
//
//   lstm:   recompute i, f (+1.0), o, u, c from p and x;  tc = tanh(c)
//           gc = g_c + g_h * o * (1 - tc^2)
//           d  = [gc*u*i(1-i) | gc*p_c*f(1-f) | g_h*tc*o(1-o) | gc*i(1-u^2)]
//           cotangent of the slot's children: [gc * f | d . W_h^T]
//   gru:    recompute z, r, rec_n = p . W_hn + b_n, n from p and x
//           d_n = g_h(1-z)(1-n^2), d_z = g_h(p-n)z(1-z), d_r = d_n rec_n r(1-r)
//           cotangent of the slot's children: g_h*z + [d_z|d_r|d_n*r] . W_h^T
//   treefc: d_pre = g_s * (1 - h^2), h recomputed;
//           cotangent of child a: d_pre . wc[a*H:(a+1)*H]^T
//   then g[child_ids[m, a]] += the cotangent for every child that exists.
//
// As in the reference, lstm and gru hand the slot's one cotangent to every
// existing child of the slot (an arity-1 cell has one).  Schedule contract
// (pack_batch): an absent child points at the sentinel row T*M; masked
// children contribute nothing.  Children live at lower levels, so the rows
// written (< offset) never overlap the level's own block, which is only
// read.  The sentinel row and every row no child of the level points at
// come out bit-unchanged.
//
// Three launches per level, the layout of treelstm_bwd_megastep.cu:
//   (a) bwd_gates: a tile of BM slots x BN hidden columns re-gathers the
//       predecessor (treefc: child) rows and recomputes the gate
//       pre-activations with the forward's tile product (cell_tile.cuh),
//       then writes the gate cotangents (lstm: d [M, 4H]; gru: d_rec
//       [M, 3H]; treefc: d_pre [M, H]) and the column-local part of the
//       child cotangent (lstm: gc*f; gru: g_h*z) into a workspace;
//   (b) bwd_hgrad: a tiled fp32 product of the gate cotangents against the
//       transposed weight, [M, G] x [G, H] (treefc: one [M, H] x [H, H]
//       product per child, blockIdx.z), written (lstm, treefc) or added
//       (gru) into the child cotangents;
//   (c) scatter_runs (runs.cuh): the sorted-run pass, one block per run,
//       seeded from g, no float atomics.
// A tile whose slots have no child that is not the sentinel (every tile of
// the first level, and the padding) exits at once: no later pass reads its
// workspace rows.  The workspace is allocated by the caller once per
// backward and reused by every level: lstm 6*M*H floats, gru 4*M*H, treefc
// (1 + A)*M*H.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s):
// the multiply-adds that slots with a child need -- NG*H^2 (treefc: A*H^2)
// for the gate recompute and as many again for the child cotangents --
// against each input read once (child rows, ext rows, the level's g rows,
// the weight) and each touched row read and written once.  A Var-LSTM
// level (128 slots, H = 512) is 0.54 GFLOP: 8 us of operations, bound by
// operations, and spread over 16 blocks a pass; Tree-FC's level 1 is 17
// GFLOP (256 us); its level 0 needs no product.  Fusing (a)-(c), tensor
// cores and TMA are later work.

#include <cuda_runtime.h>

#include "cell_tile.cuh"
#include "runs.cuh"

namespace {

using namespace cell;

// Pass (a): recompute the gates, write the gate cotangents ws_d ([M, G])
// and the column-local part of the child cotangents ws_gch.
template <int KIND>
__global__ void __launch_bounds__(NT)
bwd_gates_kernel(const float* __restrict__ g, int g_stride,
                 const float* __restrict__ buf, int buf_stride,
                 const int* __restrict__ child_ids,
                 const int* __restrict__ ext_ids,
                 const float* __restrict__ node_mask,
                 const float* __restrict__ ext, int ext_stride,
                 const float* __restrict__ w,
                 const float* __restrict__ bias,
                 float* __restrict__ ws_d, float* __restrict__ ws_gch,
                 int M, int A, int H, int offset, int sentinel) {
  constexpr int NG = Traits<KIND>::NG;
  __shared__ int cid_s[MAX_A][BM];
  __shared__ float nm_s[BM];
  __shared__ GemmSmem<NG> gsm;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  if (!(load_ids(cid_s, nm_s, child_ids, node_mask, M, A, m0, sentinel)
        & KIDS))
    return;

  float acc[NG][TM][TN];
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int tm = 0; tm < TM; ++tm)
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) acc[q][tm][tn] = 0.0f;
  tile_gemm<NG>(acc, gsm, cid_s, buf, buf_stride, KIND == LSTM ? H : 0, w, H,
                KIND == TREEFC ? A : 1, n0);

  // Cotangent epilogue, one (slot, column) at a time: everything here is
  // column-local, so no other block's result is needed.
  const int G = NG * H;
#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    const int m = ty * TM + tm;
    const int gm = m0 + m;
    if (gm >= M) continue;
    const float nm = nm_s[m];
    const float* x = ext + (size_t)ext_ids[gm] * ext_stride;
    const float* gr = g + (size_t)(offset + gm) * g_stride;
    const int row0 = cid_s[0][m];
    const float* prev = buf + (size_t)(row0 >= 0 ? row0 : 0) * buf_stride;
    float* d = ws_d + (size_t)gm * G;
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      const int j = n0 + tx * TN + tn;
      if (j >= H) continue;
      if constexpr (KIND == LSTM) {
        const float c_prev = row0 >= 0 ? prev[j] : 0.0f;
        const float ig = sigmoid_f(x[j] + acc[0][tm][tn] + bias[j]);
        const float fg =
            sigmoid_f(x[H + j] + acc[1][tm][tn] + bias[H + j] + 1.0f);
        const float og =
            sigmoid_f(x[2 * H + j] + acc[2][tm][tn] + bias[2 * H + j]);
        const float ug = tanhf(x[3 * H + j] + acc[3][tm][tn] + bias[3 * H + j]);
        const float c = fg * c_prev + ig * ug;
        const float tc = tanhf(c);
        const float g_c = gr[j] * nm;
        const float g_h = gr[H + j] * nm;
        const float gc = g_c + g_h * og * (1.0f - tc * tc);
        d[j] = gc * ug * ig * (1.0f - ig);
        d[H + j] = gc * c_prev * fg * (1.0f - fg);
        d[2 * H + j] = g_h * tc * og * (1.0f - og);
        d[3 * H + j] = gc * ig * (1.0f - ug * ug);
        ws_gch[(size_t)gm * 2 * H + j] = gc * fg;
      } else if constexpr (KIND == GRU) {
        const float h_prev = row0 >= 0 ? prev[j] : 0.0f;
        const float z = sigmoid_f(x[j] + (acc[0][tm][tn] + bias[j]));
        const float r = sigmoid_f(x[H + j] + (acc[1][tm][tn] + bias[H + j]));
        const float hn = acc[2][tm][tn] + bias[2 * H + j];
        const float n = tanhf(x[2 * H + j] + r * hn);
        const float g_h = gr[j] * nm;
        const float d_n = g_h * (1.0f - z) * (1.0f - n * n);
        const float d_z = g_h * (h_prev - n) * z * (1.0f - z);
        const float d_r = d_n * hn * r * (1.0f - r);
        d[j] = d_z;
        d[H + j] = d_r;
        d[2 * H + j] = d_n * r;
        ws_gch[(size_t)gm * H + j] = g_h * z;
      } else {
        const float hy = tanhf(acc[0][tm][tn] + x[j] + bias[j]);
        d[j] = gr[j] * nm * (1.0f - hy * hy);
      }
    }
  }
}

// Pass (b): the product part of the child cotangents,
//   out[m, a, n] = sum_{k < G} D[m, k] * W[(a*H + n) * G + k]
// with D = ws_d ([M, G]) and W the weight read along its rows (W_h [H, G],
// or wc [A*H, H] with G = H and a = blockIdx.z).  lstm writes the h half of
// its [M, 2H] rows, gru adds to its [M, H] rows, treefc writes row m*A + a.
template <int KIND>
__global__ void __launch_bounds__(NT)
bwd_hgrad_kernel(const int* __restrict__ child_ids,
                 const float* __restrict__ node_mask,
                 const float* __restrict__ w,
                 const float* __restrict__ ws_d,
                 float* __restrict__ ws_gch,
                 int M, int A, int H, int sentinel) {
  constexpr int NG = Traits<KIND>::NG;
  __shared__ int cid_s[MAX_A][BM];
  __shared__ float nm_s[BM];
  __shared__ __align__(16) float d_s[BK][LDM];
  __shared__ __align__(16) float w_s[BK][LDN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int a = blockIdx.z;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  if (!(load_ids(cid_s, nm_s, child_ids, node_mask, M, A, m0, sentinel)
        & KIDS))
    return;

  const int G = NG * H;
  float acc[TM][TN];
#pragma unroll
  for (int tm = 0; tm < TM; ++tm)
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) acc[tm][tn] = 0.0f;

  for (int k0 = 0; k0 < G; k0 += BK) {
    // Stage the gate cotangents slot-major and the weight transposed:
    // w_s[k][n] = W[a*H + n0 + n, k0 + k]; consecutive threads read
    // consecutive k of one row.
#pragma unroll
    for (int r = 0; r < (BM * BK) / NT; ++r) {
      const int k = tid % BK;
      const int m = tid / BK + r * (NT / BK);
      const int gm = m0 + m, gk = k0 + k;
      d_s[k][m] = (gm < M && gk < G) ? ws_d[(size_t)gm * G + gk] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < (BN * BK) / NT; ++r) {
      const int k = tid % BK;
      const int n = tid / BK + r * (NT / BK);
      const int gk = k0 + k, gn = n0 + n;
      w_s[k][n] = (gn < H && gk < G)
                      ? w[((size_t)a * H + gn) * G + gk] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 d4 = *reinterpret_cast<const float4*>(&d_s[k][ty * TM]);
      const float4 w4 = *reinterpret_cast<const float4*>(&w_s[k][tx * TN]);
      const float dv[TM] = {d4.x, d4.y, d4.z, d4.w};
      const float wv[TN] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int tm = 0; tm < TM; ++tm)
#pragma unroll
        for (int tn = 0; tn < TN; ++tn)
          acc[tm][tn] = fmaf(dv[tm], wv[tn], acc[tm][tn]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    const int gm = m0 + ty * TM + tm;
    if (gm >= M) continue;
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      const int n = n0 + tx * TN + tn;
      if (n >= H) continue;
      if constexpr (KIND == LSTM) {
        ws_gch[(size_t)gm * 2 * H + H + n] = acc[tm][tn];
      } else if constexpr (KIND == GRU) {
        ws_gch[(size_t)gm * H + n] += acc[tm][tn];
      } else {
        ws_gch[((size_t)gm * A + a) * H + n] = acc[tm][tn];
      }
    }
  }
}

template <int KIND>
int launch(void* g, const void* buf, const void* child_ids,
           const void* ext_ids, const void* node_mask, const void* ext,
           const void* w, const void* bias, const void* sort_perm,
           const void* sorted_child_ids, const void* run_head, void* ws,
           int M, int A, int H, int offset, int sentinel, int g_stride,
           int buf_stride, int ext_stride, void* stream) {
  if (M <= 0 || H <= 0) return 0;
  if (A < 1 || A > MAX_A || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int NG = Traits<KIND>::NG;
  constexpr int SM = Traits<KIND>::SM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gp = static_cast<float*>(g);
  const int* cid = static_cast<const int*>(child_ids);
  const float* nm = static_cast<const float*>(node_mask);
  const float* wp = static_cast<const float*>(w);
  float* ws_d = static_cast<float*>(ws);                  // [M, NG*H]
  float* ws_gch = ws_d + (size_t)M * NG * H;              // [M or M*A, S]
  const dim3 grid((H + BN - 1) / BN, (M + BM - 1) / BM);
  bwd_gates_kernel<KIND><<<grid, NT, 0, s>>>(
      gp, g_stride, static_cast<const float*>(buf), buf_stride, cid,
      static_cast<const int*>(ext_ids), nm, static_cast<const float*>(ext),
      ext_stride, wp, static_cast<const float*>(bias), ws_d, ws_gch, M, A, H,
      offset, sentinel);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b(grid.x, grid.y, KIND == TREEFC ? A : 1);
  bwd_hgrad_kernel<KIND><<<grid_b, NT, 0, s>>>(cid, nm, wp, ws_d, ws_gch, M,
                                                A, H, sentinel);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)runs::scatter_runs(
      gp, g_stride, ws_gch, static_cast<const int*>(sort_perm),
      static_cast<const int*>(sorted_child_ids),
      static_cast<const int*>(run_head), M * A, SM * H,
      KIND == TREEFC ? 1 : A, sentinel, s);
}

}  // namespace

// Plain C entry points (loaded with ctypes), one per kind, with the
// argument list of treelstm_bwd_megastep_launch.  Every pointer is a device
// pointer; `ws` is a float workspace of the size given above; `stream` is a
// cudaStream_t.  Each returns the cudaError_t of its launches (0 on
// success); cudaErrorInvalidValue for a shape the kernels do not take
// (arity outside 1..4, a grid too tall).
#define CELL_BWD_MEGASTEP_ENTRY(NAME, KIND)                                    \
  extern "C" int NAME(void* g, const void* buf, const void* child_ids,        \
                      const void* ext_ids, const void* node_mask,             \
                      const void* ext, const void* w, const void* bias,       \
                      const void* sort_perm, const void* sorted_child_ids,    \
                      const void* run_head, void* ws, int M, int A, int H,    \
                      int offset, int sentinel, int g_stride, int buf_stride, \
                      int ext_stride, void* stream) {                         \
    return launch<KIND>(g, buf, child_ids, ext_ids, node_mask, ext, w, bias,  \
                        sort_perm, sorted_child_ids, run_head, ws, M, A, H,   \
                        offset, sentinel, g_stride, buf_stride, ext_stride,   \
                        stream);                                              \
  }

CELL_BWD_MEGASTEP_ENTRY(lstm_bwd_megastep_launch, cell::LSTM)
CELL_BWD_MEGASTEP_ENTRY(gru_bwd_megastep_launch, cell::GRU)
CELL_BWD_MEGASTEP_ENTRY(treefc_bwd_megastep_launch, cell::TREEFC)
