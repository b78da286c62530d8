// The forward megasteps of kinds lstm, gru and treefc (one batching task,
// one level, in place) and the fused LSTM level step of the op-by-op leg,
// for Hopper (sm_90a): the recurrent product on the TF32 tensor cores with
// the 3xTF32 split, its depth split over a thread-block cluster.
//
// Replaces the TPU kernels of src/repro/kernels/level_megastep.py and
// src/repro/kernels/level_step.py:
//   K3 `lstm_megastep`    (level_megastep.py:98, its pallas_call at :124),
//   K4 `gru_megastep`     (level_megastep.py:238, its pallas_call at :262),
//   K5 `treefc_megastep`  (level_megastep.py:299, its pallas_call at :328),
//   K9 `lstm_level_fused` (level_step.py:53, its pallas_call at :74).
// K3-K5 compute what src/repro_torch/kernels/ref.py `level_megastep(kind,
// ...)` computes.  For each slot m of the level (rows [offset, offset+M)),
// with x = ext[ext_ids[m]] the hoisted input projection row, p the
// predecessor row buf[child_ids[m, 0]] and h_a child a's row
// buf[child_ids[m, a]]:
//
//   lstm   (state [c|h], S = 2H, x and W_h of 4H lanes i|f|o|u):
//     gates = x + p_h . W_h + b;  i, o = sigmoid;  f = sigmoid(gates_f + 1.0);
//     u = tanh;  c = f * p_c + i * u;  h = o * tanh(c)
//   gru    (state h, S = H, x and W_h of 3H lanes z|r|n):
//     rec = p . W_h + b;  z, r = sigmoid(x + rec);
//     n = tanh(x_n + r * rec_n)     (the reset gate multiplies the recurrent
//                                    candidate INCLUDING its bias)
//     h = (1 - z) * n + z * p
//   treefc (state h, S = H, x of H lanes, wc [A*H, H]):
//     h = tanh(sum_a h_a . wc[a*H:(a+1)*H] + x + b)
//
//   buf[dest(m)] = state * node_mask[m]        (zeros where it is 0)
//
// with dest(m) row offset + m of the level's block, or, where the caller
// passes `out_ids` (the continuous engine's union frontier), row
// out_ids[m], no row at all where out_ids[m] lies outside [0, rows) (a
// pad lane): the frontier's scatter (K6b) folded into the store, so a
// tick is one launch (gathered_product.cuh `dest_row`).
//
// K9 computes ref.py `lstm_level_fused`: for each row m of h_prev/c_prev
// [M, H] (the gathered predecessor state, float or bf16, strided views of
// the [M, 2H] gathered rows on the main path), ext [M, 4H], W_h [H, 4H]
// and b [4H] (float), lstm's gates and cell as above, (c, h) written to
// two fresh contiguous [M, H] tensors at h_prev's type.
//
// Schedule contract.  An absent child points at the zero row `sentinel`.
// In a level (src/repro/core/structure.py pack_batch) children live at
// lower levels, so the rows read (< offset, or the sentinel) never
// overlap the block written.  With `out_ids` the ids are unique and none
// names a row the launch reads (a child_ids row or the sentinel): the
// reference composes the megastep and the scatter in two phases, so an
// overlap would read the old row there and race here
// (src/repro_torch/kernels/ops.py `frontier_megastep` says why the
// continuous engine never makes one).  Either way the in-place write is
// sound, and rows no slot is stored at, the sentinel among them, come out
// bit-unchanged.
//
// Bound on an H100 SXM (700 W).  A slot with no child needs no product:
// with p = 0, lstm's c = sigmoid(x_i + b_i) tanh(x_u + b_u) and h =
// sigmoid(x_o + b_o) tanh(c); gru's h = (1 - z) tanh(x_n + r b_n), z and r
// from x + b; treefc's h = tanh(x + b).  So a level of such slots (level 0
// of a batch) is bound by bytes: Tree-FC's level 0 (16,384 leaves) reads
// and writes ~67 MB, 20 us.  A slot with a child needs NG H^2
// multiply-adds (NG = 4 lanes for lstm, 3 for gru; treefc H^2 a child),
// each as three TF32 products at 495 TFLOP/s (at the 67 TFLOP/s of fp32
// FMAs without tensor cores, 2.5x as long): a Var-LSTM level (or a K9
// launch) of 128 chains at H 512 is 0.27 GFLOP, 1.6 us as TF32 products
// (4.0 us as FMAs), against the 4 MB weight and ~2 MB of rows (1.8 us of
// bytes); Tree-FC's level 1 (8,192 slots, A 2) is 8.6 GFLOP, 52 us (128 us
// as FMAs).
//
// Design, against what held the fp32 SIMT kernels these replace (a
// register-tiled SGEMM of 64 slots x 64 columns, synchronous staging, fp32
// FMAs, every slot covered: K3/K4 at 2 %, K5 at 16 % and K9 at 4 % of
// their FMA bounds):
//   1. Products only where a slot may have a child.  The host passes
//      `live`, one past the last slot with a child other than the sentinel
//      (counted from child_ids in numpy when the schedule goes to the
//      card, core/structure.py `level_live`).  The product kernel's grid
//      covers the slots [0, live) only; a second, elementwise launch
//      (cell_leaf_kernel, bound by bytes) writes [live, M) with the
//      formula of a slot with no child, or zeros for padding, reading no
//      child row and no weight.  A level takes at most these two launches
//      (level 0 of a batch only the second).  Without `live` (the decode
//      engine, the continuous frontiers) the grid covers every slot; a
//      tile of the product grid none of whose slots has a child takes that
//      formula at once, with no product.  K9 has no live count (its
//      reference has none): its grid covers its M rows, read in place.
//   2. Filling the card.  A tile is 64 slots x 16 hidden columns (lstm,
//      gru, K9) or 64 (treefc, whose product has one lane: wider tiles
//      re-gather each slot's children 4x less often), a CTA four warps of
//      32 slots; a level of 128 slots is 64 tiles at H 512.  The depth of
//      the product (treefc: A segments of H, one a child) is split over a
//      cluster of s = 1, 2, 4 or 8 CTAs, chosen by the host as for K2's
//      pass (a) of the same kind (level_megastep.py `cell_split`,
//      `k2_split`): 256 CTAs at M 128, H 512; 1,024 at Tree-FC's level 1,
//      64 at its 64-slot top.  The gathered rows and weight tiles stream
//      by cp.async through a ring of three chunk stages; what the epilogue
//      reads (the slot's ext lanes, the predecessor's c (lstm, K9) or h
//      (gru), the bias) is copied into shared memory right after the loop,
//      landing while the partials are stored and the cluster meets.
//   3. The tensor cores.  The product runs on mma.sync.m16n8k8 TF32 with
//      the 3xTF32 split (about 21 bits of each operand, which keeps the
//      fp32 bar of 1e-4 that one TF32 product misses) into fp32
//      accumulators; the ranks' partials are added in rank order through
//      distributed shared memory.  No float atomics: two launches give the
//      same bits.  K9's bf16 state rows are staged raw and widened at the
//      fragment load, two TF32 products a k-step (gathered_product.cuh).
// The loop, the split and the rank-order sum are gathered_product.cuh's
// `Product` in its one-operand shape, the very code of K2's lstm, gru and
// treefc pass (a) (bwd_megastep_sm90.cu); this file adds the forward
// epilogues and the path of slots with no child.

#include <cuda_bf16.h>

#include "gathered_product.cuh"

namespace {

constexpr int NT = 128;         // threads of a product CTA: four warps
constexpr int NT_LEAF = 256;    // threads of a leaf CTA
constexpr int MAX_LEAF_CTAS = 4096;
constexpr int MAX_DEVICES = 64;

enum Kind { LSTM = 0, GRU = 1, TREEFC = 2 };

using Args = FwdLevel;

template <int KIND>
struct Cfg {
  static constexpr int NQ = KIND == LSTM ? 4 : (KIND == GRU ? 3 : 1);
  // Hidden columns a tile: K2's pass (a) tile of the kind.
  static constexpr int BJ = KIND == TREEFC ? 64 : 16;
  // The product: the predecessor's h against the NQ lanes of W_h, or
  // (treefc) each child's h against its segment of wc.
  using Prod = Product<NT, 1, NQ, -1, BJ>;
  // Past the partial tile: a side row a slot (its ext lanes, then the
  // predecessor's c (lstm) or h (gru)), then the bias lanes.
  static constexpr int SIDE = (NQ + (KIND == TREEFC ? 0 : 1)) * BJ;
  static constexpr int END = Prod::P + BM * SIDE + NQ * BJ;
  static constexpr int SMEM = 4 * (Prod::RING > END ? Prod::RING : END);
};

// The state of a slot at one column, in the reference's order: x its ext
// lanes and b the bias lanes (`ls` floats apart), v its products, pv the
// predecessor's c (lstm) or h (gru).  lstm gives c and h; gru and treefc
// h (in c).
template <int KIND>
__device__ __forceinline__ void cell(const float* x, const float* v,
                                     float pv, const float* b, int ls,
                                     float& c, float& h) {
  if constexpr (KIND == LSTM) {
    const float ig = sigmoid_f(x[0] + v[0] + b[0]);
    const float fg = sigmoid_f(x[ls] + v[1] + b[ls] + 1.0f);
    const float og = sigmoid_f(x[2 * ls] + v[2] + b[2 * ls]);
    const float ug = tanhf(x[3 * ls] + v[3] + b[3 * ls]);
    c = fg * pv + ig * ug;
    h = og * tanhf(c);
  } else if constexpr (KIND == GRU) {
    const float z = sigmoid_f(x[0] + (v[0] + b[0]));
    const float r = sigmoid_f(x[ls] + (v[1] + b[ls]));
    const float n = tanhf(x[2 * ls] + r * (v[2] + b[2 * ls]));
    c = (1.0f - z) * n + z * pv;
  } else {
    c = tanhf(v[0] + x[0] + b[0]);        // the reference's order
  }
}

// The state of a slot with no child (p = 0, no product): what `cell`
// gives with v = 0 and pv = 0, bit for bit.  x and b as for `cell`; lstm
// reads lanes i, o, u, gru lanes z, r, n, treefc its one lane.
template <int KIND>
__device__ __forceinline__ void leaf_cell(const float* x, const float* b,
                                          int ls, float& c, float& h) {
  if constexpr (KIND == LSTM) {
    const float ig = sigmoid_f(x[0] + b[0]);
    const float og = sigmoid_f(x[2 * ls] + b[2 * ls]);
    c = ig * tanhf(x[3 * ls] + b[3 * ls]);
    h = og * tanhf(c);
  } else if constexpr (KIND == GRU) {
    const float z = sigmoid_f(x[0] + b[0]);
    const float r = sigmoid_f(x[ls] + b[ls]);
    c = (1.0f - z) * tanhf(x[2 * ls] + r * b[2 * ls]);
  } else {
    c = tanhf(x[0] + b[0]);
  }
}

// Slot gm's row, column j, from the state (zeros where the node mask is
// 0); nothing for a pad lane of the frontier.
template <int KIND>
__device__ __forceinline__ void put(const Args& a, int gm, int j, float c,
                                    float h, float nm) {
  float* out = dest_row(a, gm);
  if (out == nullptr) return;
  out[j] = nm != 0.0f ? c * nm : 0.0f;
  if constexpr (KIND == LSTM) out[a.H + j] = nm != 0.0f ? h * nm : 0.0f;
}

// The formula of a slot with no child for slot gm, column j, its lanes
// read from global memory.
template <int KIND>
__device__ __forceinline__ void leaf(const Args& a, int gm, int eid, int j,
                                     float nm) {
  float c = 0.0f, h = 0.0f;
  if (nm != 0.0f)
    leaf_cell<KIND>(a.ext + (size_t)eid * a.ext_stride + j, a.bias + j, a.H,
                    c, h);
  put<KIND>(a, gm, j, c, h, nm);
}

// The slots [0, live) of a tile of BM slots x BJ columns: the gathered
// product, its depth split over the cluster, then the forward epilogue.
template <int KIND>
__global__ void __launch_bounds__(NT) cell_gates_kernel(const Args a) {
  using C = Cfg<KIND>;
  using Prod = typename C::Prod;
  constexpr int NQ = C::NQ, BJ = C::BJ;
  extern __shared__ __align__(128) float smem[];
  __shared__ int cid_s[MAX_A][BM];
  __shared__ float nm_s[BM];
  __shared__ int eid_s[BM];
  cg::cluster_group cluster = cg::this_cluster();
  const int s = a.split;
  const int rank = (int)cluster.block_rank();
  const int j0 = (blockIdx.x / s) * BJ;
  const int m0 = blockIdx.y * BM;
  const int H = a.H;
  const int tid = threadIdx.x;
  const int rows = BM / s, r0 = rank * rows;      // this rank's epilogue
  if (!load_ids<NT>(cid_s, nm_s, eid_s, a, m0)) {
    // No slot of the tile has a child (every rank alike): the formula of
    // no child for this rank's rows, no product and no cluster barrier.
    for (int i = tid; i < rows * BJ; i += NT) {
      const int row = r0 + i / BJ, gm = m0 + row, j = j0 + i % BJ;
      if (gm < a.live && j < H) leaf<KIND>(a, gm, eid_s[row], j, nm_s[row]);
    }
    return;
  }

  const int cps = (H + BK - 1) / BK;             // chunks a segment
  const int nc = (KIND == TREEFC ? a.A : 1) * cps;
  const int c_lo = rank * nc / s, c_hi = (rank + 1) * nc / s;
  const bool wide = a.wide != 0;
  // lstm's operand is the h half of a [c | h] row; gru's and treefc's rows
  // are h alone.  Treefc's segment seg reads child seg against wc's rows
  // [seg H, (seg + 1) H).
  const int col = KIND == LSTM ? H : 0;
  const int wrow = NQ * H;                       // floats a W row
  Prod prod;
  prod.run(smem, c_lo, c_hi, cps, H, H - j0, a.live - m0, wide, a.buf, a.w,
           [&](int, int seg, int r) -> const float* {
             const int id = cid_s[KIND == TREEFC ? seg : 0][r];
             return id >= 0 ? a.buf + (size_t)id * a.buf_stride + col
                            : nullptr;
           },
           [&](int q, int seg) -> const float* {
             return a.w + (size_t)(KIND == TREEFC ? seg * H : 0) * wrow +
                    q * H + j0;
           },
           wrow);

  // The epilogue's inputs for this rank's rows, past the partial tile:
  // in flight while the partials are stored and the cluster meets.
  float* side = smem + Prod::P;
  float* sbias = side + BM * C::SIDE;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    stage<NT, BJ, C::SIDE>(side + q * BJ, rows, H - j0, wide, a.ext,
                           [&](int r, int cc) -> const float* {
                             return m0 + r0 + r < a.live
                                 ? a.ext + (size_t)eid_s[r0 + r]
                                       * a.ext_stride + q * H + j0 + cc
                                 : nullptr;
                           });
  if constexpr (KIND != TREEFC)
    stage<NT, BJ, C::SIDE>(side + NQ * BJ, rows, H - j0, wide, a.buf,
                           [&](int r, int cc) -> const float* {
                             const int id = cid_s[0][r0 + r];
                             return id >= 0 ? a.buf + (size_t)id
                                                  * a.buf_stride + j0 + cc
                                            : nullptr;
                           });
  stage<NT, BJ, BJ>(sbias, NQ, H - j0, wide, a.bias,
                    [&](int r, int cc) -> const float* {
                      return a.bias + r * H + j0 + cc;
                    });
  cp_commit();

  prod.store(smem);
  cluster.sync();
  cp_wait<0>();                          // the side rows have landed
  __syncthreads();

  // Rank r: rows [r BM / s, (r + 1) BM / s) summed over the ranks in rank
  // order, then the epilogue.
  uint32_t pb[MAX_SPLIT];
  rank_bases(smem, s, pb);
  for (int i = tid; i < rows * BJ; i += NT) {
    const int rr = i / BJ, jj = i % BJ;
    const int row = r0 + rr, gm = m0 + row, j = j0 + jj;
    if (gm >= a.live || j >= H) continue;
    float v[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) v[q] = Prod::value(pb, row, q, jj, s);
    const float* sr = side + rr * C::SIDE + jj;
    float c, h = 0.0f;
    cell<KIND>(sr, v, KIND == TREEFC ? 0.0f : sr[NQ * BJ], sbias + jj, BJ,
               c, h);
    put<KIND>(a, gm, j, c, h, nm_s[row]);
  }
  cluster.sync();                        // no CTA leaves while read
}

// Four floats from p, or the first n of them (the rest 0).
__device__ __forceinline__ void load4(float (&d)[4], const float* p, int n,
                                      bool wide) {
  if (wide) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = e < n ? p[e] : 0.0f;
}

__device__ __forceinline__ void store4(float* p, const float (&d)[4], int n,
                                       bool wide) {
  if (wide) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) p[e] = d[e];
}

// The slots [live, M), none of which has a child: the formula of no child
// (zeros for padding, whose ext row is not read), four columns a thread.
template <int KIND>
__global__ void __launch_bounds__(NT_LEAF) cell_leaf_kernel(const Args a) {
  constexpr int NQ = Cfg<KIND>::NQ;
  const int H = a.H, q4 = (H + 3) / 4;
  const bool wide = a.wide != 0;
  const long long n = (long long)(a.M - a.live) * q4;
  const long long step = (long long)gridDim.x * NT_LEAF;
  for (long long i = (long long)blockIdx.x * NT_LEAF + threadIdx.x; i < n;
       i += step) {
    const int gm = a.live + (int)(i / q4), j = 4 * (int)(i % q4);
    const int nj = H - j < 4 ? H - j : 4;
    const float nm = a.nm[gm];
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f}, h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (nm != 0.0f) {
      const float* x = a.ext + (size_t)a.eid[gm] * a.ext_stride + j;
      const float* b = a.bias + j;
      // Lane q of column e at xs[q * 4 + e], bs likewise.
      float xs[NQ * 4], bs[NQ * 4];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (KIND == LSTM && q == 1) continue;     // f meets p_c = 0
        float d[4];
        load4(d, x + q * H, nj, wide);
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[q * 4 + e] = d[e];
        load4(d, b + q * H, nj, wide);
#pragma unroll
        for (int e = 0; e < 4; ++e) bs[q * 4 + e] = d[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        leaf_cell<KIND>(xs + e, bs + e, 4, c[e], h[e]);
        c[e] *= nm;
        h[e] *= nm;
      }
    }
    float* out = dest_row(a, gm);
    if (out == nullptr) continue;
    store4(out + j, c, nj, wide);
    if (KIND == LSTM) store4(out + H + j, h, nj, wide);
  }
}

template <int KIND>
int launch(const Args& a, cudaStream_t stream, int* launches) {
  using C = Cfg<KIND>;
  // The shared-memory opt-in is set once a device (it is per device).
  static bool ready[MAX_DEVICES] = {};
  auto kg = cell_gates_kernel<KIND>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES || !ready[dev]) {
    e = cudaFuncSetAttribute(kg, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 0 && dev < MAX_DEVICES) ready[dev] = true;
  }
  if (a.live > 0) {
    e = launch_cluster(kg, dim3((a.H + C::BJ - 1) / C::BJ * a.split,
                                (a.live + BM - 1) / BM),
                       NT, a.split, C::SMEM, a, stream);
    if (e != cudaSuccess) return (int)e;
    ++*launches;
  }
  if (a.live < a.M) {
    const long long n = (long long)(a.M - a.live) * ((a.H + 3) / 4);
    const long long ctas = (n + NT_LEAF - 1) / NT_LEAF;
    cell_leaf_kernel<KIND><<<(int)(ctas < MAX_LEAF_CTAS ? ctas
                                                         : MAX_LEAF_CTAS),
                              NT_LEAF, 0, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launches;
  }
  return 0;
}

template <int KIND>
int entry(void* buf, const void* child_ids, const void* ext_ids,
          const void* node_mask, const void* ext, const void* w,
          const void* bias, int M, int A, int H, int offset, int sentinel,
          int buf_stride, int ext_stride, int live, int split,
          const void* out_ids, int rows, void* launches, void* stream) {
  int* nl = static_cast<int*>(launches);
  *nl = 0;
  auto pow2 = [](int s) { return s == 1 || s == 2 || s == 4 || s == 8; };
  if (M <= 0 || H <= 0) return 0;
  if (A < 1 || A > MAX_A || live < 0 || live > M || !pow2(split) ||
      (live + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.out = static_cast<float*>(buf);
  a.buf = a.out;
  a.cid = static_cast<const int*>(child_ids);
  a.eid = static_cast<const int*>(ext_ids);
  a.nm = static_cast<const float*>(node_mask);
  a.ext = static_cast<const float*>(ext);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.M = M; a.A = A; a.H = H; a.offset = offset; a.sentinel = sentinel;
  a.live = live; a.split = split;
  a.out_ids = static_cast<const int*>(out_ids);
  a.rows = rows;
  a.buf_stride = buf_stride; a.ext_stride = ext_stride;
  // 16-byte copies need 16-byte aligned rows: H, the strides and the
  // bases of what is read or written (buf, ext, w, bias) a multiple of
  // 16 B.
  a.wide = H % 4 == 0 && buf_stride % 4 == 0 && ext_stride % 4 == 0 &&
           aligned16(buf) && aligned16(ext) && aligned16(w) &&
           aligned16(bias);
  return launch<KIND>(a, static_cast<cudaStream_t>(stream), nl);
}

// ---------------------------------------------------------------------------
// K9: the fused LSTM level step.  The rows come in place (strided views of
// the gathered state), the outputs are fresh; the product is K3's, over
// rows of TX (float, or uint16_t: a bf16 value's bits), and the epilogue
// is K3's `cell<LSTM>`.
// ---------------------------------------------------------------------------

struct K9Args {
  void* c_out;
  void* h_out;
  const void* h_prev;
  const void* c_prev;
  const float* ext;
  const float* w;
  const float* bias;
  int M, H, split, wide;
  long long h_stride, c_stride, ext_stride;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}
__device__ __forceinline__ void put_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void put_f32(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16(x));   // nearest even
}

template <typename TX>
struct K9Cfg {
  using Prod = Product<NT, 1, 4, -1, Cfg<LSTM>::BJ, TX>;
  static constexpr int BJ = Cfg<LSTM>::BJ;
  // Past the partial tile: a row's four ext lanes, the bias lanes, then
  // c_prev's rows at TX (BJ elements a row).
  static constexpr int SIDE = 4 * BJ;
  static constexpr int END =
      Prod::P + BM * SIDE + 4 * BJ + BM * BJ * (int)sizeof(TX) / 4;
  static constexpr int SMEM = 4 * (Prod::RING > END ? Prod::RING : END);
};

// Rows [m0, m0 + BM) x columns [j0, j0 + BJ) of (c, h): the product of the
// rows' h_prev with W_h, its depth split over the cluster, then the cell.
template <typename TX>
__global__ void __launch_bounds__(NT) k9_level_kernel(const K9Args a) {
  using C = K9Cfg<TX>;
  using Prod = typename C::Prod;
  constexpr int BJ = C::BJ;
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int s = a.split;
  const int rank = (int)cluster.block_rank();
  const int j0 = (blockIdx.x / s) * BJ;
  const int m0 = blockIdx.y * BM;
  const int M = a.M, H = a.H;
  const int tid = threadIdx.x;
  const int rows = BM / s, r0 = rank * rows;      // this rank's epilogue
  const TX* hp = static_cast<const TX*>(a.h_prev);
  const TX* cp = static_cast<const TX*>(a.c_prev);
  const int cps = (H + BK - 1) / BK;
  const int c_lo = rank * cps / s, c_hi = (rank + 1) * cps / s;
  const bool wide = a.wide != 0;
  Prod prod;
  prod.run(smem, c_lo, c_hi, cps, H, H - j0, M - m0, wide, hp, a.w,
           [&](int, int, int r) -> const TX* {    // row m0 + r, in place
             return m0 + r < M ? hp + (size_t)(m0 + r) * a.h_stride
                               : nullptr;
           },
           [&](int q, int) -> const float* { return a.w + q * H + j0; },
           4 * H);

  // The epilogue's inputs for this rank's rows, past the partial tile.
  float* side = smem + Prod::P;
  float* sbias = side + BM * C::SIDE;
  TX* sc = reinterpret_cast<TX*>(sbias + 4 * BJ);
  auto row_in = [&](int r) { return m0 + r0 + r < M; };
#pragma unroll
  for (int q = 0; q < 4; ++q)
    stage<NT, BJ, C::SIDE>(side + q * BJ, rows, H - j0, wide, a.ext,
                           [&](int r, int cc) -> const float* {
                             return row_in(r)
                                 ? a.ext + (size_t)(m0 + r0 + r)
                                       * a.ext_stride + q * H + j0 + cc
                                 : nullptr;
                           });
  stage<NT, BJ, BJ>(sbias, 4, H - j0, wide, a.bias,
                    [&](int r, int cc) -> const float* {
                      return a.bias + r * H + j0 + cc;
                    });
  stage<NT, BJ, BJ>(sc, rows, H - j0, wide, cp,
                    [&](int r, int cc) -> const TX* {
                      return row_in(r) ? cp + (size_t)(m0 + r0 + r)
                                              * a.c_stride + j0 + cc
                                       : nullptr;
                    });
  cp_commit();

  prod.store(smem);
  cluster.sync();
  cp_wait<0>();                          // the side rows have landed
  __syncthreads();

  uint32_t pb[MAX_SPLIT];
  rank_bases(smem, s, pb);
  TX* c_out = static_cast<TX*>(a.c_out);
  TX* h_out = static_cast<TX*>(a.h_out);
  for (int i = tid; i < rows * BJ; i += NT) {
    const int rr = i / BJ, jj = i % BJ;
    const int row = r0 + rr, gm = m0 + row, j = j0 + jj;
    if (gm >= M || j >= H) continue;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = Prod::value(pb, row, q, jj, s);
    float c, h;
    cell<LSTM>(side + rr * C::SIDE + jj, v, to_f32(sc[rr * BJ + jj]),
               sbias + jj, BJ, c, h);
    put_f32(c_out + (size_t)gm * H + j, c);
    put_f32(h_out + (size_t)gm * H + j, h);
  }
  cluster.sync();                        // no CTA leaves while read
}

template <typename TX>
int k9_launch(const K9Args& a, cudaStream_t stream) {
  static bool ready[MAX_DEVICES] = {};
  auto k = k9_level_kernel<TX>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES || !ready[dev]) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K9Cfg<TX>::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 0 && dev < MAX_DEVICES) ready[dev] = true;
  }
  constexpr int BJ = K9Cfg<TX>::BJ;
  return (int)launch_cluster(
      k, dim3((a.H + BJ - 1) / BJ * a.split, (a.M + BM - 1) / BM), NT,
      a.split, K9Cfg<TX>::SMEM, a, stream);
}

}  // namespace

// Plain C entry points of K3-K5 (loaded with ctypes), one per kind.  Every
// pointer but `launches` is a device pointer; `launches` is a host int
// that gets the number of CUDA launches made (at most 2); `stream` is a
// cudaStream_t.  `sentinel`: the zero row absent children point at.
// `live`: slots [live, M) have no child other than the sentinel (M where
// the caller does not know).  `split`: CTAs of a cluster splitting the
// product's depth (1, 2, 4 or 8).  `out_ids`: null, or [M] int32
// destination rows (then `offset` is not read; the schedule contract
// above); `rows`: the buffer's rows.  Each returns the cudaError_t of the
// launches (0 on success); cudaErrorInvalidValue for arguments the
// kernels do not take.
#define CELL_MEGASTEP_ENTRY(NAME, KIND)                                       \
  extern "C" int NAME(void* buf, const void* child_ids, const void* ext_ids, \
                      const void* node_mask, const void* ext, const void* w, \
                      const void* bias, int M, int A, int H, int offset,     \
                      int sentinel, int buf_stride, int ext_stride,          \
                      int live, int split, const void* out_ids, int rows,    \
                      void* launches, void* stream) {                        \
    return entry<KIND>(buf, child_ids, ext_ids, node_mask, ext, w, bias, M,  \
                       A, H, offset, sentinel, buf_stride, ext_stride, live, \
                       split, out_ids, rows, launches, stream);              \
  }

CELL_MEGASTEP_ENTRY(lstm_megastep_sm90_launch, LSTM)
CELL_MEGASTEP_ENTRY(gru_megastep_sm90_launch, GRU)
CELL_MEGASTEP_ENTRY(treefc_megastep_sm90_launch, TREEFC)

// K9's plain C entry point.  Every pointer is a device pointer; strides
// are row strides in elements; `state_bf16` picks bf16 over float for
// h_prev, c_prev and the outputs; `split`: CTAs of a cluster splitting
// the product's depth (1, 2, 4 or 8); `stream` is a cudaStream_t.
// Returns the cudaError_t of its one launch (0 on success; nothing is
// launched for an empty shape); cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int lstm_level_fused_launch(void* c_out, void* h_out,
                                       const void* h_prev, const void* c_prev,
                                       const void* ext, const void* w,
                                       const void* bias, int M, int H,
                                       int h_stride, int c_stride,
                                       int ext_stride, int state_bf16,
                                       int split, void* stream) {
  if (M <= 0 || H <= 0) return 0;
  if (!(split == 1 || split == 2 || split == 4 || split == 8) ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  K9Args a;
  a.c_out = c_out; a.h_out = h_out; a.h_prev = h_prev; a.c_prev = c_prev;
  a.ext = static_cast<const float*>(ext);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.M = M; a.H = H; a.split = split;
  a.h_stride = h_stride; a.c_stride = c_stride; a.ext_stride = ext_stride;
  // 16-byte copies: H and the state strides a multiple of 16 B of the
  // state's type (4 floats, 8 bf16), ext's stride of 4 floats, and every
  // base read 16-byte aligned.
  const int v = state_bf16 ? 8 : 4;
  a.wide = H % v == 0 && h_stride % v == 0 && c_stride % v == 0 &&
           ext_stride % 4 == 0 && aligned16(h_prev) && aligned16(c_prev) &&
           aligned16(ext) && aligned16(w) && aligned16(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return state_bf16 ? k9_launch<uint16_t>(a, st) : k9_launch<float>(a, st);
}

// Dynamic shared memory a product CTA takes (for the report): `kind` 0
// lstm, 1 gru, 2 treefc, 3 K9 at float, 4 K9 at bf16.
extern "C" int cell_megastep_smem_bytes(int kind) {
  switch (kind) {
    case LSTM: return Cfg<LSTM>::SMEM;
    case GRU: return Cfg<GRU>::SMEM;
    case TREEFC: return Cfg<TREEFC>::SMEM;
    case 3: return K9Cfg<float>::SMEM;
    default: return K9Cfg<uint16_t>::SMEM;
  }
}
