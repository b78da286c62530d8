// The forward megasteps of kinds lstm, gru and treefc: one batching task
// (one level), in place, for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernels of src/repro/kernels/level_megastep.py:
//   K3 `lstm_megastep`   (:98, its pallas_call at :124),
//   K4 `gru_megastep`    (:238, its pallas_call at :262),
//   K5 `treefc_megastep` (:299, its pallas_call at :328).
// Each computes what src/repro_torch/kernels/ref.py `level_megastep(kind,
// ...)` computes.  For each slot m of the level (rows [offset, offset+M)),
// with x = ext[ext_ids[m]] the hoisted input projection row and p the
// predecessor row buf[child_ids[m, 0]]:
//
//   lstm   (state [c|h], S = 2H, x and W_h of 4H lanes i|f|o|u):
//     gates = x + p_h . W_h + b;  i, o = sigmoid;  f = sigmoid(gates_f + 1.0);
//     u = tanh;  c = f * p_c + i * u;  h = o * tanh(c)
//   gru    (state h, S = H, x and W_h of 3H lanes z|r|n):
//     rec = p . W_h + b;  z, r = sigmoid(x + rec);
//     n = tanh(x_n + r * rec_n)     (the reset gate multiplies the recurrent
//                                    candidate INCLUDING its bias)
//     h = (1 - z) * n + z * p
//   treefc (state h, S = H, wc [A*H, H]):
//     h = tanh(sum_a h_a . wc[a*H:(a+1)*H] + x + b)
//
//   buf[offset + m] = state * node_mask[m]
//
// Schedule contract (pack_batch): an absent child points at the zero
// sentinel row T*M, so no child mask is read; children live at lower
// levels, so the rows read (< offset, or the sentinel) never overlap the
// block written, which is what makes the in-place write sound.
//
// Design.  The Pallas kernels walk one slot per grid step (treefc: grid
// (M, A), carrying the child sum in VMEM scratch).  GPU blocks run in no
// order, so each block here owns a tile of BM slots x BN hidden columns and
// runs the level as one register-tiled SGEMM (cell_tile.cuh): the gathered
// predecessor rows (treefc: the A child rows, K = A*H deep) against the NG
// lanes of the weight, the lanes of a hidden column in one thread so the
// epilogue is column-local.  A tile whose slots are all padding
// (node_mask 0 -- most of the upper levels of a Tree-FC batch) writes its
// zero tile and exits; a tile whose slots have no child (the first step of
// every chain, the leaves of a tree) skips the product.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s):
// a slot with a child needs NG*H*H (treefc: A*H*H) multiply-adds, 2 FLOPs
// each; against each input read once (the live slots' child rows and ext
// rows, the weight, the indices) and the block written once.  A Var-LSTM
// level (M = 128 chains, H = 512) is 268 MFLOP against ~6 MB: 4.0 us of
// operations, 1.8 us of bytes -- bound by operations, and so small that one
// launch with 16 of 132 SMs busy is bound by latency in practice.  Tree-FC's
// level 1 (8,192 live slots, A = 2, H = 512) is 8.6 GFLOP: 128 us of
// operations; its level 0 (16,384 leaves, no product) is bound by bytes
// (~67 MB of ext rows and output: 20 us).  Tensor cores (TF32 would miss the
// 1e-4 bar), wgmma and TMA are left for a later change.

#include <cuda_runtime.h>

#include "cell_tile.cuh"

namespace {

using namespace cell;

template <int KIND>
__global__ void __launch_bounds__(NT)
cell_megastep_kernel(float* buf, int buf_stride,
                     const int* __restrict__ child_ids,
                     const int* __restrict__ ext_ids,
                     const float* __restrict__ node_mask,
                     const float* __restrict__ ext, int ext_stride,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     int M, int A, int H, int offset, int sentinel) {
  constexpr int NG = Traits<KIND>::NG;
  constexpr int SM = Traits<KIND>::SM;
  __shared__ int cid_s[MAX_A][BM];
  __shared__ float nm_s[BM];
  __shared__ GemmSmem<NG> gsm;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  const int tile = load_ids(cid_s, nm_s, child_ids, node_mask, M, A, m0,
                            sentinel);
  if (!(tile & LIVE)) {
    for (int i = tid; i < BM * BN; i += NT) {
      const int m = i / BN, j = n0 + i % BN, gm = m0 + m;
      if (gm < M && j < H) {
        float* out = buf + (size_t)(offset + gm) * buf_stride;
#pragma unroll
        for (int s = 0; s < SM; ++s) out[s * H + j] = 0.0f;
      }
    }
    return;
  }

  float acc[NG][TM][TN];
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int tm = 0; tm < TM; ++tm)
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) acc[q][tm][tn] = 0.0f;
  if (tile & KIDS) {
    tile_gemm<NG>(acc, gsm, cid_s, buf, buf_stride, KIND == LSTM ? H : 0, w,
                  H, KIND == TREEFC ? A : 1, n0);
  }

  // Gate epilogue, one (slot, column) at a time.
#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    const int m = ty * TM + tm;
    const int gm = m0 + m;
    if (gm >= M) continue;
    const float nm = nm_s[m];
    const float* x = ext + (size_t)ext_ids[gm] * ext_stride;
    const int row0 = cid_s[0][m];
    const float* prev = buf + (size_t)(row0 >= 0 ? row0 : 0) * buf_stride;
    float* out = buf + (size_t)(offset + gm) * buf_stride;
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
        out[j] = c * nm;
        out[H + j] = og * tanhf(c) * nm;
      } else if constexpr (KIND == GRU) {
        const float h_prev = row0 >= 0 ? prev[j] : 0.0f;
        const float z = sigmoid_f(x[j] + (acc[0][tm][tn] + bias[j]));
        const float r = sigmoid_f(x[H + j] + (acc[1][tm][tn] + bias[H + j]));
        const float n =
            tanhf(x[2 * H + j] + r * (acc[2][tm][tn] + bias[2 * H + j]));
        out[j] = ((1.0f - z) * n + z * h_prev) * nm;
      } else {
        out[j] = tanhf(acc[0][tm][tn] + x[j] + bias[j]) * nm;
      }
    }
  }
}

template <int KIND>
int launch(void* buf, const void* child_ids, const void* ext_ids,
           const void* node_mask, const void* ext, const void* w,
           const void* bias, int M, int A, int H, int offset, int sentinel,
           int buf_stride, int ext_stride, void* stream) {
  if (M <= 0 || H <= 0) return 0;
  if (A < 1 || A > MAX_A || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H + BN - 1) / BN, (M + BM - 1) / BM);
  cell_megastep_kernel<KIND><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(buf), buf_stride, static_cast<const int*>(child_ids),
      static_cast<const int*>(ext_ids), static_cast<const float*>(node_mask),
      static_cast<const float*>(ext), ext_stride,
      static_cast<const float*>(w), static_cast<const float*>(bias), M, A, H,
      offset, sentinel);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes), one per kind.  Every pointer
// is a device pointer; `sentinel` is the zero row T*M; `stream` is a
// cudaStream_t.  Each returns the cudaError_t of its launch (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take (arity
// outside 1..4, a grid too tall).
#define CELL_MEGASTEP_ENTRY(NAME, KIND)                                       \
  extern "C" int NAME(void* buf, const void* child_ids, const void* ext_ids, \
                      const void* node_mask, const void* ext, const void* w, \
                      const void* bias, int M, int A, int H, int offset,     \
                      int sentinel, int buf_stride, int ext_stride,          \
                      void* stream) {                                        \
    return launch<KIND>(buf, child_ids, ext_ids, node_mask, ext, w, bias, M, \
                        A, H, offset, sentinel, buf_stride, ext_stride,      \
                        stream);                                             \
  }

CELL_MEGASTEP_ENTRY(lstm_megastep_launch, cell::LSTM)
CELL_MEGASTEP_ENTRY(gru_megastep_launch, cell::GRU)
CELL_MEGASTEP_ENTRY(treefc_megastep_launch, cell::TREEFC)
