// The fused LSTM level step (K9), for Hopper (sm_90a): the recurrent
// product and the gate chain of one LSTM batching task in one launch, fp32
// on the CUDA cores.
//
// Replaces the TPU kernel of src/repro/kernels/level_step.py:
//   K9 `lstm_level_fused` (:53, its pallas_call at :74).
// It computes what src/repro_torch/kernels/ref.py `lstm_level_fused`
// computes.  For each slot m of the level, with h_prev/c_prev [M, H] the
// gathered predecessor state, ext [M, 4H] the hoisted input projection
// rows, W_h [H, 4H] and b [4H] (lanes i|f|o|u):
//
//   gates = ext[m] + h_prev[m] . W_h + b                       (fp32)
//   c = sigmoid(f + 1.0) * c_prev + sigmoid(i) * tanh(u)
//   h = sigmoid(o) * tanh(c)             (c and h at h_prev's type)
//
// h_prev and c_prev are float or bf16 (one type, the node buffer's) and on
// the main path are the two halves of the gathered [M, 2H] state, strided
// views read in place; ext, W_h and b are float.  The outputs are two fresh
// contiguous [M, H] tensors.
//
// Design.  This is K3 (cell_megastep.cu) without its row gather and without
// its in-place block write: the same register-tiled SGEMM
// (cell_tile.cuh), each block a tile of BM slots x BN hidden columns with
// the four gate lanes j, H+j, 2H+j, 3H+j of a column in one thread, so the
// gate epilogue stays column-local and the [M, 4H] gates never reach
// memory.  The Pallas kernel keeps W_h resident in VMEM (4 MB at H = 512);
// a block's shared memory cannot hold it, so the tile loop streams W_h
// through shared memory in BK-deep chunks.  bf16 rows of h_prev are widened
// as they are staged; the product stays fp32 (TF32 misses the 1e-4 bar).
// The Pallas block padding of M is not copied: slots past M are masked.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s):
// 2*M*H*4H FLOPs against h_prev, c_prev, ext and the outputs read or written
// once and W_h read once.  A Var-LSTM level (M = 128, H = 512) is 268 MFLOP,
// 4.0 us of operations, against 6.3 MB (1.9 us): bound by operations, and
// so small that 16 blocks on 132 SMs make it latency-bound in practice, as
// K3 is.

#include <cuda_runtime.h>

#include "cell_tile.cuh"

namespace {

using namespace cell;

template <typename T>
__global__ void __launch_bounds__(NT)
lstm_level_fused_kernel(T* __restrict__ c_out, T* __restrict__ h_out,
                        const T* __restrict__ h_prev, int h_stride,
                        const T* __restrict__ c_prev, int c_stride,
                        const float* __restrict__ ext, int ext_stride,
                        const float* __restrict__ w,
                        const float* __restrict__ bias, int M, int H) {
  __shared__ int rows_s[1][BM];
  __shared__ GemmSmem<4> gsm;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  // X row m of the tile is h_prev row m0 + m; a slot past M reads zeros.
  for (int i = tid; i < BM; i += NT) rows_s[0][i] = m0 + i < M ? m0 + i : -1;
  __syncthreads();

  float acc[4][TM][TN];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int tm = 0; tm < TM; ++tm)
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) acc[q][tm][tn] = 0.0f;
  tile_gemm<4>(acc, gsm, rows_s, h_prev, h_stride, 0, w, H, 1, n0);

  // Gate epilogue, one (slot, column) at a time.
#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    const int gm = m0 + ty * TM + tm;
    if (gm >= M) continue;
    const float* x = ext + (size_t)gm * ext_stride;
    const T* cp = c_prev + (size_t)gm * c_stride;
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      const int j = n0 + tx * TN + tn;
      if (j >= H) continue;
      const float ig = sigmoid_f(x[j] + acc[0][tm][tn] + bias[j]);
      const float fg =
          sigmoid_f(x[H + j] + acc[1][tm][tn] + bias[H + j] + 1.0f);
      const float og =
          sigmoid_f(x[2 * H + j] + acc[2][tm][tn] + bias[2 * H + j]);
      const float ug = tanhf(x[3 * H + j] + acc[3][tm][tn] + bias[3 * H + j]);
      const float c = fg * to_f32(cp[j]) + ig * ug;
      c_out[(size_t)gm * H + j] = from_f32<T>(c);
      h_out[(size_t)gm * H + j] = from_f32<T>(og * tanhf(c));
    }
  }
}

template <typename T>
int launch(void* c_out, void* h_out, const void* h_prev, const void* c_prev,
           const void* ext, const void* w, const void* bias, int M, int H,
           int h_stride, int c_stride, int ext_stride, cudaStream_t stream) {
  const dim3 grid((H + BN - 1) / BN, (M + BM - 1) / BM);
  lstm_level_fused_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<T*>(c_out), static_cast<T*>(h_out),
      static_cast<const T*>(h_prev), h_stride, static_cast<const T*>(c_prev),
      c_stride, static_cast<const float*>(ext), ext_stride,
      static_cast<const float*>(w), static_cast<const float*>(bias), M, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is a device
// pointer; strides are row strides in elements; `state_bf16` picks bf16
// over float for h_prev, c_prev and the outputs; `stream` is a
// cudaStream_t.  Returns the cudaError_t of the launch (0 on success;
// nothing is launched for an empty shape); cudaErrorInvalidValue for a
// grid too tall.
extern "C" int lstm_level_fused_launch(void* c_out, void* h_out,
                                       const void* h_prev, const void* c_prev,
                                       const void* ext, const void* w,
                                       const void* bias, int M, int H,
                                       int h_stride, int c_stride,
                                       int ext_stride, int state_bf16,
                                       void* stream) {
  if (M <= 0 || H <= 0) return 0;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return state_bf16
             ? launch<__nv_bfloat16>(c_out, h_out, h_prev, c_prev, ext, w,
                                     bias, M, H, h_stride, c_stride,
                                     ext_stride, st)
             : launch<float>(c_out, h_out, h_prev, c_prev, ext, w, bias, M, H,
                             h_stride, c_stride, ext_stride, st);
}
