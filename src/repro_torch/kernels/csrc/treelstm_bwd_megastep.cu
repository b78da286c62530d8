// One reverse N-ary child-sum Tree-LSTM batching task (one level), for
// Hopper (sm_90a), fp32 on the CUDA cores.  The gradient buffer is
// updated in place.
//
// Replaces the TPU kernel src/repro/kernels/level_megastep_bwd.py:205
// `bwd_megastep` (its pallas_call at :276), kind "treelstm".  It computes
// what src/repro_torch/kernels/ref.py `bwd_megastep("treelstm", ...)`
// computes:
//
//   for each slot m of the level (rows [offset, offset+M) of g):
//     [g_c | g_h] = g[offset + m] * node_mask[m]
//     re-gather [c_k | h_k] = buf[child_ids[m, k]] and recompute
//       i, o, u, f_k, c = i*u + sum_k f_k*c_k   (no +1.0 on f, unlike the LSTM)
//     gc   = g_c + g_h * o * (1 - tanh(c)^2)
//     d_i  = gc*u*i*(1-i), d_o = g_h*tanh(c)*o*(1-o), d_u = gc*i*(1-u^2)
//     d_fk = gc*c_k*f_k*(1-f_k)
//     g_c_k = gc * f_k
//     g_h_k = [d_i|d_o|d_u] . [U_i|U_o|U_u]^T + d_fk . U_f^T
//   then g[child_ids[m, k]] += [g_c_k | g_h_k] for every child that exists.
//
// Schedule contract (pack_batch): an absent child points at the sentinel
// row T*M; the child mask is derived from that (as the Pallas kernel does)
// and masked children contribute nothing.  Children live at lower levels,
// so the rows written (< offset) never overlap the level's own block,
// which is only read.  The sentinel row and every row that no child of
// the level points at come out bit-unchanged.
//
// Three launches per level:
//   (a) bwd_gates: a tile of BM slots x BN hidden columns re-gathers the
//       child h rows and recomputes the gate pre-activations as the forward
//       kernel does (a register-tiled SGEMM: 3 child-sum products and A
//       forget products per output), then writes d_i|d_o|d_u, each child's
//       d_f and g_c_k into a workspace;
//   (b) bwd_hgrad: a tiled fp32 product g_h_k = D . U^T over the same
//       tiles (H-deep, 3 shared products per slot plus one per child);
//   (c) scatter_runs (runs.cuh): one block per destination run of the
//       level's sorted child ids (sort_perm / sorted_child_ids / run_head,
//       precomputed on the host by pack_batch): the block seeds from g,
//       adds the run's contributions in sorted order and writes the row
//       once.  No float atomics, so two runs of the same backward give the
//       same bits.
// A tile whose slots have no live child (every tile of level 0, and the
// padding of a bucketed batch) writes zeros to its workspace and exits
// after one barrier.  The workspace is allocated by the caller once per
// backward and reused by every level.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s):
// the multiply-adds that slots with live children need -- (A + 3) H^2
// for the gate recompute and as many again for g_h_k, per slot with a
// child -- against each input read once (child rows, ext rows, the level's
// g rows, weights) and each touched row read and written once.  A
// training level of the paper's tree_lstm (H = 512) with a few hundred
// live slots is bound by operations; level 0 (leaves only) needs no
// product and is bound by bytes.  fp32 FMAs on the CUDA cores, as in the
// forward kernel: TF32 tensor cores would miss the 1e-4 bar.  Fusing
// (a)-(c) into one launch, tensor cores and TMA are later work.

#include <cuda_runtime.h>

#include "runs.cuh"

namespace {

constexpr int BM = 64;                    // slots per block
constexpr int BN = 64;                    // hidden columns per block
constexpr int BK = 16;                    // depth of one staged chunk, pass (a)
constexpr int BKB = 8;                    // depth of one staged chunk, pass (b)
constexpr int TM = 4;                     // slots per thread
constexpr int TN = 4;                     // columns per thread
constexpr int NT = (BM / TM) * (BN / TN); // 256 threads
constexpr int LDM = BM + 4;               // padded row of the slot-major tiles
constexpr int LDN = BN + 4;               // padded row of the transposed weights

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Loads the tile's child ids (-1 for an absent child or a slot past M)
// and node mask; returns whether any slot of the tile is live and has a
// child.  Every thread of the block must call it.
template <int A>
__device__ __forceinline__ int load_tile(int (*cid_s)[BM], float* nm_s,
                                         const int* __restrict__ child_ids,
                                         const float* __restrict__ node_mask,
                                         int M, int m0, int sentinel) {
  const int tid = threadIdx.x;
  for (int i = tid; i < BM * A; i += NT) {
    const int m = i / A, a = i % A, gm = m0 + m;
    const int row = gm < M ? child_ids[(size_t)gm * A + a] : sentinel;
    cid_s[a][m] = row == sentinel ? -1 : row;
  }
  for (int i = tid; i < BM; i += NT) {
    nm_s[i] = (m0 + i) < M ? node_mask[m0 + i] : 0.0f;
  }
  __syncthreads();
  int mine = 0;
  if (tid < BM && nm_s[tid] != 0.0f) {
#pragma unroll
    for (int a = 0; a < A; ++a) mine |= cid_s[a][tid] >= 0;
  }
  return __syncthreads_or(mine);
}

// Pass (a): recompute the gates, write d_i|d_o|d_u ([M, 3H]), d_f
// ([M*A, H]) and the c half of the child cotangents ([M*A, 2H], cols 0:H).
template <int A>
__global__ void __launch_bounds__(NT)
bwd_gates_kernel(const float* __restrict__ g, int g_stride,
                 const float* __restrict__ buf, int buf_stride,
                 const int* __restrict__ child_ids,
                 const int* __restrict__ ext_ids,
                 const float* __restrict__ node_mask,
                 const float* __restrict__ ext, int ext_stride,
                 const float* __restrict__ w,
                 const float* __restrict__ bias,
                 float* __restrict__ ws_d, float* __restrict__ ws_df,
                 float* __restrict__ ws_gch,
                 int M, int H, int offset, int sentinel) {
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

  const int live = load_tile<A>(cid_s, nm_s, child_ids, node_mask, M, m0,
                                sentinel);
  if (!live) {
    for (int i = tid; i < BM * BN; i += NT) {
      const int m = i / BN, j = n0 + i % BN, gm = m0 + m;
      if (gm < M && j < H) {
        ws_d[(size_t)gm * 3 * H + j] = 0.0f;
        ws_d[(size_t)gm * 3 * H + H + j] = 0.0f;
        ws_d[(size_t)gm * 3 * H + 2 * H + j] = 0.0f;
#pragma unroll
        for (int a = 0; a < A; ++a) {
          ws_df[((size_t)gm * A + a) * H + j] = 0.0f;
          ws_gch[((size_t)gm * A + a) * 2 * H + j] = 0.0f;
        }
      }
    }
    return;
  }

  // acc[0..2]: hsum . U_i, U_o, U_u;  acc[3 + a]: h_a . U_f.
  float acc[3 + A][TM][TN];
#pragma unroll
  for (int q = 0; q < 3 + A; ++q)
#pragma unroll
    for (int tm = 0; tm < TM; ++tm)
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) acc[q][tm][tn] = 0.0f;

  for (int k0 = 0; k0 < H; k0 += BK) {
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
#pragma unroll
    for (int r = 0; r < (BK * BN) / NT; ++r) {
      const int j = tid % BN;
      const int k = tid / BN + r * (NT / BN);
      const int gk = k0 + k, gj = n0 + j;
      const bool ok = gk < H && gj < H;
      const float* wr = w + (size_t)gk * 4 * H + gj;
#pragma unroll
      for (int q = 0; q < 4; ++q) w_s[q][k][j] = ok ? wr[(size_t)q * H] : 0.0f;
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

  // Cotangent epilogue, one (slot, column) at a time: everything here is
  // column-local, so no other block's result is needed.
#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    const int m = ty * TM + tm;
    const int gm = m0 + m;
    if (gm >= M) continue;
    const float nm = nm_s[m];
    const float* x = ext + (size_t)ext_ids[gm] * ext_stride;
    const float* gr = g + (size_t)(offset + gm) * g_stride;
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      const int j = n0 + tx * TN + tn;
      if (j >= H) continue;
      const float ig = sigmoid_f(x[j] + acc[0][tm][tn] + bias[j]);
      const float og = sigmoid_f(x[2 * H + j] + acc[1][tm][tn] + bias[2 * H + j]);
      const float ug = tanhf(x[3 * H + j] + acc[2][tm][tn] + bias[3 * H + j]);
      float fa[A], ck[A];
      float fc = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int row = cid_s[a][m];
        ck[a] = row >= 0 ? buf[(size_t)row * buf_stride + j] : 0.0f;
        fa[a] = sigmoid_f(x[H + j] + acc[3 + a][tm][tn] + bias[H + j]);
        fc += fa[a] * ck[a];
      }
      const float c = ig * ug + fc;
      const float tc = tanhf(c);
      const float g_c = gr[j] * nm;
      const float g_h = gr[H + j] * nm;
      const float gc = g_c + g_h * og * (1.0f - tc * tc);
      float* d = ws_d + (size_t)gm * 3 * H;
      d[j] = gc * ug * ig * (1.0f - ig);
      d[H + j] = g_h * tc * og * (1.0f - og);
      d[2 * H + j] = gc * ig * (1.0f - ug * ug);
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const bool has = cid_s[a][m] >= 0;
        ws_df[((size_t)gm * A + a) * H + j] =
            has ? gc * ck[a] * fa[a] * (1.0f - fa[a]) : 0.0f;
        ws_gch[((size_t)gm * A + a) * 2 * H + j] = has ? gc * fa[a] : 0.0f;
      }
    }
  }
}

// Pass (b): the h half of the child cotangents, g_h_k = D . U^T
// ([M*A, 2H], cols H:2H): per slot 3 shared products (d_i . U_i^T,
// d_o . U_o^T, d_u . U_u^T) plus d_f,k . U_f^T for each child.
template <int A>
__global__ void __launch_bounds__(NT)
bwd_hgrad_kernel(const int* __restrict__ child_ids,
                 const float* __restrict__ node_mask,
                 const float* __restrict__ w,
                 const float* __restrict__ ws_d,
                 const float* __restrict__ ws_df,
                 float* __restrict__ ws_gch,
                 int M, int H, int sentinel) {
  __shared__ int cid_s[A][BM];
  __shared__ float nm_s[BM];
  __shared__ __align__(16) float d_s[3][BKB][LDM];
  __shared__ __align__(16) float df_s[A][BKB][LDM];
  __shared__ __align__(16) float w_s[4][BKB][LDN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  const int live = load_tile<A>(cid_s, nm_s, child_ids, node_mask, M, m0,
                                sentinel);
  if (!live) {
    for (int i = tid; i < BM * BN; i += NT) {
      const int m = i / BN, n = n0 + i % BN, gm = m0 + m;
      if (gm < M && n < H) {
#pragma unroll
        for (int a = 0; a < A; ++a)
          ws_gch[((size_t)gm * A + a) * 2 * H + H + n] = 0.0f;
      }
    }
    return;
  }

  float acc_s[TM][TN];
  float acc_a[A][TM][TN];
#pragma unroll
  for (int tm = 0; tm < TM; ++tm)
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      acc_s[tm][tn] = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) acc_a[a][tm][tn] = 0.0f;
    }

  for (int k0 = 0; k0 < H; k0 += BKB) {
    // Stage d_i|d_o|d_u and each child's d_f for this chunk, slot-major;
    // consecutive threads read consecutive k of one row.
#pragma unroll
    for (int r = 0; r < (BM * BKB) / NT; ++r) {
      const int k = tid % BKB;
      const int m = tid / BKB + r * (NT / BKB);
      const int gm = m0 + m, gk = k0 + k;
      const bool ok = gm < M && gk < H;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        d_s[q][k][m] = ok ? ws_d[(size_t)gm * 3 * H + q * H + gk] : 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a)
        df_s[a][k][m] = ok ? ws_df[((size_t)gm * A + a) * H + gk] : 0.0f;
    }
    // Stage the four gate weights transposed: w_s[q][k][n] = U_q[n, k],
    // read from the packed [H, 4H] = U_i|U_f|U_o|U_u along its rows.
#pragma unroll
    for (int r = 0; r < (BN * BKB) / NT; ++r) {
      const int k = tid % BKB;
      const int n = tid / BKB + r * (NT / BKB);
      const int gk = k0 + k, gn = n0 + n;
      const bool ok = gk < H && gn < H;
      const float* wr = w + (size_t)gn * 4 * H + gk;
#pragma unroll
      for (int q = 0; q < 4; ++q) w_s[q][k][n] = ok ? wr[(size_t)q * H] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BKB; ++k) {
      const float4 di4 = *reinterpret_cast<const float4*>(&d_s[0][k][ty * TM]);
      const float4 do4 = *reinterpret_cast<const float4*>(&d_s[1][k][ty * TM]);
      const float4 du4 = *reinterpret_cast<const float4*>(&d_s[2][k][ty * TM]);
      const float di[TM] = {di4.x, di4.y, di4.z, di4.w};
      const float dov[TM] = {do4.x, do4.y, do4.z, do4.w};
      const float du[TM] = {du4.x, du4.y, du4.z, du4.w};
      float dfa[A][TM];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float4 v = *reinterpret_cast<const float4*>(&df_s[a][k][ty * TM]);
        dfa[a][0] = v.x; dfa[a][1] = v.y; dfa[a][2] = v.z; dfa[a][3] = v.w;
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
          acc_s[tm][tn] = fmaf(di[tm], wi[tn], acc_s[tm][tn]);
          acc_s[tm][tn] = fmaf(dov[tm], wo[tn], acc_s[tm][tn]);
          acc_s[tm][tn] = fmaf(du[tm], wu[tn], acc_s[tm][tn]);
#pragma unroll
          for (int a = 0; a < A; ++a)
            acc_a[a][tm][tn] = fmaf(dfa[a][tm], wf[tn], acc_a[a][tm][tn]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    const int m = ty * TM + tm;
    const int gm = m0 + m;
    if (gm >= M) continue;
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      const int n = n0 + tx * TN + tn;
      if (n >= H) continue;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        ws_gch[((size_t)gm * A + a) * 2 * H + H + n] =
            cid_s[a][m] >= 0 ? acc_s[tm][tn] + acc_a[a][tm][tn] : 0.0f;
      }
    }
  }
}

template <int A>
cudaError_t launch(float* g, int g_stride, const float* buf, int buf_stride,
                   const int* child_ids, const int* ext_ids,
                   const float* node_mask, const float* ext, int ext_stride,
                   const float* w, const float* bias, const int* sort_perm,
                   const int* sorted_child_ids, const int* run_head,
                   float* ws, int M, int H, int offset, int sentinel,
                   cudaStream_t stream) {
  float* ws_d = ws;                                 // [M, 3H]
  float* ws_df = ws_d + (size_t)M * 3 * H;          // [M*A, H]
  float* ws_gch = ws_df + (size_t)M * A * H;        // [M*A, 2H]
  const dim3 grid((H + BN - 1) / BN, (M + BM - 1) / BM);
  bwd_gates_kernel<A><<<grid, NT, 0, stream>>>(
      g, g_stride, buf, buf_stride, child_ids, ext_ids, node_mask, ext,
      ext_stride, w, bias, ws_d, ws_df, ws_gch, M, H, offset, sentinel);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_hgrad_kernel<A><<<grid, NT, 0, stream>>>(
      child_ids, node_mask, w, ws_d, ws_df, ws_gch, M, H, sentinel);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return runs::scatter_runs(g, g_stride, ws_gch, sort_perm, sorted_child_ids,
                            run_head, M * A, 2 * H, 1, sentinel, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is a device
// pointer; `stream` is a cudaStream_t.  `ws` is a float workspace of
// M * (3 + 3A) * H elements.  Returns the cudaError_t of the launches (0
// on success); cudaErrorInvalidValue for a shape the kernel does not take
// (arity outside 1..4, a grid too tall).
extern "C" int treelstm_bwd_megastep_launch(
    void* g, const void* buf, const void* child_ids, const void* ext_ids,
    const void* node_mask, const void* ext, const void* w, const void* bias,
    const void* sort_perm, const void* sorted_child_ids,
    const void* run_head, void* ws, int M, int A, int H, int offset,
    int sentinel, int g_stride, int buf_stride, int ext_stride,
    void* stream) {
  if (M <= 0 || H <= 0) return 0;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  float* gp = static_cast<float*>(g);
  const float* bp = static_cast<const float*>(buf);
  const int* cid = static_cast<const int*>(child_ids);
  const int* eid = static_cast<const int*>(ext_ids);
  const float* nm = static_cast<const float*>(node_mask);
  const float* x = static_cast<const float*>(ext);
  const float* wp = static_cast<const float*>(w);
  const float* bi = static_cast<const float*>(bias);
  const int* sp = static_cast<const int*>(sort_perm);
  const int* sc = static_cast<const int*>(sorted_child_ids);
  const int* rh = static_cast<const int*>(run_head);
  float* wsp = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (A) {
    case 1: return (int)launch<1>(gp, g_stride, bp, buf_stride, cid, eid, nm, x, ext_stride, wp, bi, sp, sc, rh, wsp, M, H, offset, sentinel, s);
    case 2: return (int)launch<2>(gp, g_stride, bp, buf_stride, cid, eid, nm, x, ext_stride, wp, bi, sp, sc, rh, wsp, M, H, offset, sentinel, s);
    case 3: return (int)launch<3>(gp, g_stride, bp, buf_stride, cid, eid, nm, x, ext_stride, wp, bi, sp, sc, rh, wsp, M, H, offset, sentinel, s);
    case 4: return (int)launch<4>(gp, g_stride, bp, buf_stride, cid, eid, nm, x, ext_stride, wp, bi, sp, sc, rh, wsp, M, H, offset, sentinel, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
