// The forward megastep of kind treefc: one batching task (one level), in
// place, for Hopper (sm_90a), fp32 on the CUDA cores.  (The lstm and gru
// forward megasteps, K3 and K4, run the tensor-core gathered product of
// cell_megastep_sm90.cu.)
//
// Replaces the TPU kernel src/repro/kernels/level_megastep.py:299
// K5 `treefc_megastep` (its pallas_call at :328).  It computes what
// src/repro_torch/kernels/ref.py `level_megastep("treefc", ...)` computes.
// For each slot m of the level (rows [offset, offset+M)), with x =
// ext[ext_ids[m]] the hoisted input projection row and h_a the row
// buf[child_ids[m, a]] of child a (state h, S = H, wc [A*H, H]):
//
//   h = tanh(sum_a h_a . wc[a*H:(a+1)*H] + x + b)
//   buf[offset + m] = h * node_mask[m]
//
// Schedule contract (pack_batch): an absent child points at the zero
// sentinel row, so no child mask is read; children live at lower levels,
// so the rows read (< offset, or the sentinel) never overlap the block
// written, which is what makes the in-place write sound.
//
// Design.  The Pallas kernel walks one slot per grid step (grid (M, A),
// carrying the child sum in VMEM scratch).  GPU blocks run in no order, so
// each block here owns a tile of BM slots x BN hidden columns and runs the
// level as one register-tiled SGEMM (cell_tile.cuh): the A gathered child
// rows, K = A*H deep, against the weight.  A tile whose slots are all
// padding (node_mask 0 -- most of the upper levels of a Tree-FC batch)
// writes its zero tile and exits; a tile whose slots have no child (the
// leaves) skips the product.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s):
// a slot needs H*H multiply-adds per child it has, 2 FLOPs each; against
// each input read once (the live slots' child rows and ext rows, the
// weight, the indices) and the block written once.  Tree-FC's level 1
// (8,192 live slots, A = 2, H = 512) is 8.6 GFLOP: 128 us of operations;
// its level 0 (16,384 leaves, no product) is bound by bytes (~67 MB of
// ext rows and output: 20 us).  Tensor cores (the gathered product of
// gathered_product.cuh, 3xTF32 for the 1e-4 bar), wgmma and TMA are left
// for a later change.

#include <cuda_runtime.h>

#include "cell_tile.cuh"

namespace {

using namespace cell;

__global__ void __launch_bounds__(NT)
cell_megastep_kernel(float* buf, int buf_stride,
                     const int* __restrict__ child_ids,
                     const int* __restrict__ ext_ids,
                     const float* __restrict__ node_mask,
                     const float* __restrict__ ext, int ext_stride,
                     const float* __restrict__ w,
                     const float* __restrict__ bias,
                     int M, int A, int H, int offset, int sentinel) {
  __shared__ int cid_s[MAX_A][BM];
  __shared__ float nm_s[BM];
  __shared__ GemmSmem<1> gsm;

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
        buf[(size_t)(offset + gm) * buf_stride + j] = 0.0f;
      }
    }
    return;
  }

  float acc[1][TM][TN];
#pragma unroll
  for (int tm = 0; tm < TM; ++tm)
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) acc[0][tm][tn] = 0.0f;
  if (tile & KIDS) tile_gemm<1>(acc, gsm, cid_s, buf, buf_stride, 0, w, H, A,
                                n0);

  // Gate epilogue, one (slot, column) at a time.
#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    const int m = ty * TM + tm;
    const int gm = m0 + m;
    if (gm >= M) continue;
    const float nm = nm_s[m];
    const float* x = ext + (size_t)ext_ids[gm] * ext_stride;
    float* out = buf + (size_t)(offset + gm) * buf_stride;
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      const int j = n0 + tx * TN + tn;
      if (j >= H) continue;
      out[j] = tanhf(acc[0][tm][tn] + x[j] + bias[j]) * nm;
    }
  }
}

int launch(void* buf, const void* child_ids, const void* ext_ids,
           const void* node_mask, const void* ext, const void* w,
           const void* bias, int M, int A, int H, int offset, int sentinel,
           int buf_stride, int ext_stride, void* stream) {
  if (M <= 0 || H <= 0) return 0;
  if (A < 1 || A > MAX_A || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H + BN - 1) / BN, (M + BM - 1) / BM);
  cell_megastep_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(buf), buf_stride, static_cast<const int*>(child_ids),
      static_cast<const int*>(ext_ids), static_cast<const float*>(node_mask),
      static_cast<const float*>(ext), ext_stride,
      static_cast<const float*>(w), static_cast<const float*>(bias), M, A, H,
      offset, sentinel);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is a device
// pointer; `sentinel` is the zero row T*M; `stream` is a cudaStream_t.
// Returns the cudaError_t of its launch (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take (arity
// outside 1..4, a grid too tall).
extern "C" int treefc_megastep_launch(void* buf, const void* child_ids,
                                      const void* ext_ids,
                                      const void* node_mask, const void* ext,
                                      const void* w, const void* bias, int M,
                                      int A, int H, int offset, int sentinel,
                                      int buf_stride, int ext_stride,
                                      void* stream) {
  return launch(buf, child_ids, ext_ids, node_mask, ext, w, bias, M, A, H,
                offset, sentinel, buf_stride, ext_stride, stream);
}
