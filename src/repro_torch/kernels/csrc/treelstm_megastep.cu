// One N-ary child-sum Tree-LSTM batching task (one level), in place, for
// Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/level_megastep.py:181
// `treelstm_megastep` (its pallas_call at :209).  It computes exactly what
// src/repro_torch/kernels/ref.py `level_megastep("treelstm", ...)` computes:
//
//   for each slot m of the level (rows [offset, offset+M) of the buffer):
//     h_k, c_k  = buf[child_ids[m, k], H:2H], buf[child_ids[m, k], 0:H]
//     hsum      = sum_k h_k
//     i, o      = sigmoid(x_{i,o} + hsum . U_{i,o} + b_{i,o})
//     u         = tanh(x_u + hsum . U_u + b_u)
//     f_k       = sigmoid(x_f + h_k . U_f + b_f)     (no +1.0, unlike the LSTM)
//     c         = i * u + sum_k f_k * c_k
//     h         = o * tanh(c)
//     buf[offset + m] = [c | h] * node_mask[m]
//   with x = ext[ext_ids[m]] the hoisted input projection row.
//
// Schedule contract (src/repro/core/structure.py pack_batch): an absent
// child points at the zero sentinel row T*M, so no child mask is read;
// children live at lower levels, so the rows read (< offset, or the
// sentinel) never overlap the block written, which is what makes the
// in-place write sound.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s).
// Serving batches of 64 SST-like parses (the paper's tree_lstm, A = 2,
// H = 512) are packed into T = 16 levels of M = 1024 or 2048 slots after
// pow2 bucketing.  A level of M = 2048 slots that all have children does
// M*(A+3)*H*H*2 = 5.4 GFLOP of multiply-adds (3 child-sum products
// against U_i, U_o, U_u and A per-child products against U_f), against
// ~46 MB of bytes (child rows 17 MB, ext rows 17 MB, output 8 MB, weights
// 4 MB): 80 us of FLOPs against 14 us of bytes, so such a level is bound
// by fp32 operations, not by memory.  What a level's data needs is less:
// a slot needs the products only for the children it has, and level 0
// holds the leaves, which have none, so that level is bound by bytes.
// This kernel does every slot's products all the same (on the zero
// sentinel rows); skipping them is left for a later change.
//
// Design.  The Pallas kernel walks grid (M, A) one row at a time and
// carries hsum and sum f_k*c_k in VMEM scratch across the inner axis; GPU
// blocks run in no order, so nothing is carried between blocks here.  Each
// block owns a tile of BM slots x BN hidden columns and does the level as
// a register-tiled SGEMM: it loads its slots' child ids itself, stages the
// A gathered h_k rows (and their sum) and a BK-deep chunk of the packed
// [H, 4H] = U_i|U_f|U_o|U_u weight in shared memory, and accumulates in
// fp32 registers 3 child-sum products and A forget products per output
// (each thread: TM slots x TN columns x (3 + A) gate sums).  The forget
// term f_k[j]*c_k[j] is column-local, so the gate epilogue needs no other
// block's result.  A block whose slots are all padding (node_mask 0 — most
// of the upper levels of a bucketed batch) writes its zero tile and exits.
// Tensor cores (TF32 would miss the 1e-4 fp32 bar), wgmma and TMA are left
// for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                    // slots per block
constexpr int BN = 64;                    // hidden columns per block
constexpr int BK = 16;                    // depth of one staged chunk
constexpr int TM = 4;                     // slots per thread
constexpr int TN = 4;                     // columns per thread
constexpr int NT = (BM / TM) * (BN / TN); // 256 threads
constexpr int LDM = BM + 4;               // padded row of the slot-major tiles

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int A>
__global__ void __launch_bounds__(NT)
treelstm_megastep_kernel(float* buf, int buf_stride,
                         const int* __restrict__ child_ids,
                         const int* __restrict__ ext_ids,
                         const float* __restrict__ node_mask,
                         const float* __restrict__ ext, int ext_stride,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         int M, int H, int offset) {
  __shared__ int cid_s[A][BM];
  __shared__ float nm_s[BM];
  __shared__ __align__(16) float h_s[A][BK][LDM];
  __shared__ __align__(16) float hsum_s[BK][LDM];
  __shared__ __align__(16) float w_s[4][BK][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  for (int i = tid; i < BM * A; i += NT) {
    const int m = i / A, a = i % A, gm = m0 + m;
    cid_s[a][m] = gm < M ? child_ids[(size_t)gm * A + a] : -1;
  }
  for (int i = tid; i < BM; i += NT) {
    nm_s[i] = (m0 + i) < M ? node_mask[m0 + i] : 0.0f;
  }
  // __syncthreads_or is also the barrier that publishes cid_s / nm_s.
  const int live = __syncthreads_or(tid < BM && nm_s[tid] != 0.0f);
  if (!live) {
    for (int i = tid; i < BM * BN; i += NT) {
      const int m = i / BN, j = n0 + i % BN, gm = m0 + m;
      if (gm < M && j < H) {
        float* out = buf + (size_t)(offset + gm) * buf_stride;
        out[j] = 0.0f;
        out[H + j] = 0.0f;
      }
    }
    return;
  }

  // acc[0..2]: hsum . U_i, U_o, U_u;  acc[3 + a]: h_a . U_f.
  float acc[3 + A][TM][TN];
#pragma unroll
  for (int g = 0; g < 3 + A; ++g)
#pragma unroll
    for (int tm = 0; tm < TM; ++tm)
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) acc[g][tm][tn] = 0.0f;

  for (int k0 = 0; k0 < H; k0 += BK) {
    // Gather the h half of each slot's child rows for this chunk;
    // consecutive threads read consecutive k of one row.
#pragma unroll
    for (int r = 0; r < (BM * BK) / NT; ++r) {
      const int k = tid % BK;
      const int m = tid / BK + r * (NT / BK);
      const int gk = k0 + k;
      float s = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int row = cid_s[a][m];
        const float v = (row >= 0 && gk < H)
                            ? buf[(size_t)row * buf_stride + H + gk] : 0.0f;
        h_s[a][k][m] = v;
        s += v;
      }
      hsum_s[k][m] = s;
    }
    // Stage the chunk of the four gate weights for this block's columns.
#pragma unroll
    for (int r = 0; r < (BK * BN) / NT; ++r) {
      const int j = tid % BN;
      const int k = tid / BN + r * (NT / BN);
      const int gk = k0 + k, gj = n0 + j;
      const bool ok = gk < H && gj < H;
      const float* wr = w + (size_t)gk * 4 * H + gj;
#pragma unroll
      for (int g = 0; g < 4; ++g) w_s[g][k][j] = ok ? wr[(size_t)g * H] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 hs4 = *reinterpret_cast<const float4*>(&hsum_s[k][ty * TM]);
      const float hs[TM] = {hs4.x, hs4.y, hs4.z, hs4.w};
      float ha[A][TM];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float4 v = *reinterpret_cast<const float4*>(&h_s[a][k][ty * TM]);
        ha[a][0] = v.x; ha[a][1] = v.y; ha[a][2] = v.z; ha[a][3] = v.w;
      }
      const float4 wi4 = *reinterpret_cast<const float4*>(&w_s[0][k][tx * TN]);
      const float4 wf4 = *reinterpret_cast<const float4*>(&w_s[1][k][tx * TN]);
      const float4 wo4 = *reinterpret_cast<const float4*>(&w_s[2][k][tx * TN]);
      const float4 wu4 = *reinterpret_cast<const float4*>(&w_s[3][k][tx * TN]);
      const float wi[TN] = {wi4.x, wi4.y, wi4.z, wi4.w};
      const float wf[TN] = {wf4.x, wf4.y, wf4.z, wf4.w};
      const float wo[TN] = {wo4.x, wo4.y, wo4.z, wo4.w};
      const float wu[TN] = {wu4.x, wu4.y, wu4.z, wu4.w};
#pragma unroll
      for (int tm = 0; tm < TM; ++tm) {
#pragma unroll
        for (int tn = 0; tn < TN; ++tn) {
          acc[0][tm][tn] = fmaf(hs[tm], wi[tn], acc[0][tm][tn]);
          acc[1][tm][tn] = fmaf(hs[tm], wo[tn], acc[1][tm][tn]);
          acc[2][tm][tn] = fmaf(hs[tm], wu[tn], acc[2][tm][tn]);
#pragma unroll
          for (int a = 0; a < A; ++a)
            acc[3 + a][tm][tn] = fmaf(ha[a][tm], wf[tn], acc[3 + a][tm][tn]);
        }
      }
    }
    __syncthreads();
  }

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
      const float ig = sigmoid_f(x[j] + acc[0][tm][tn] + bias[j]);
      const float og = sigmoid_f(x[2 * H + j] + acc[1][tm][tn] + bias[2 * H + j]);
      const float ug = tanhf(x[3 * H + j] + acc[2][tm][tn] + bias[3 * H + j]);
      float fc = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float ck = buf[(size_t)cid_s[a][m] * buf_stride + j];
        const float fa = sigmoid_f(x[H + j] + acc[3 + a][tm][tn] + bias[H + j]);
        fc += fa * ck;
      }
      const float c = ig * ug + fc;
      const float h = og * tanhf(c);
      out[j] = c * nm;
      out[H + j] = h * nm;
    }
  }
}

template <int A>
cudaError_t launch(float* buf, int buf_stride, const int* child_ids,
                   const int* ext_ids, const float* node_mask,
                   const float* ext, int ext_stride, const float* w,
                   const float* bias, int M, int H, int offset,
                   cudaStream_t stream) {
  const dim3 grid((H + BN - 1) / BN, (M + BM - 1) / BM);
  treelstm_megastep_kernel<A><<<grid, NT, 0, stream>>>(
      buf, buf_stride, child_ids, ext_ids, node_mask, ext, ext_stride, w,
      bias, M, H, offset);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is a device
// pointer; `stream` is a cudaStream_t.  Returns the cudaError_t of the
// launch (0 on success); cudaErrorInvalidValue for a shape the kernel does
// not take (arity outside 1..4, a grid too tall).
extern "C" int treelstm_megastep_launch(
    void* buf, const void* child_ids, const void* ext_ids,
    const void* node_mask, const void* ext, const void* w, const void* bias,
    int M, int A, int H, int offset, int buf_stride, int ext_stride,
    void* stream) {
  if (M <= 0 || H <= 0) return 0;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  float* b = static_cast<float*>(buf);
  const int* cid = static_cast<const int*>(child_ids);
  const int* eid = static_cast<const int*>(ext_ids);
  const float* nm = static_cast<const float*>(node_mask);
  const float* x = static_cast<const float*>(ext);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (A) {
    case 1: return (int)launch<1>(b, buf_stride, cid, eid, nm, x, ext_stride, wp, bp, M, H, offset, s);
    case 2: return (int)launch<2>(b, buf_stride, cid, eid, nm, x, ext_stride, wp, bp, M, H, offset, s);
    case 3: return (int)launch<3>(b, buf_stride, cid, eid, nm, x, ext_stride, wp, bp, M, H, offset, s);
    case 4: return (int)launch<4>(b, buf_stride, cid, eid, nm, x, ext_stride, wp, bp, M, H, offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
