// The forward megasteps of kinds lstm and gru: one batching task (one
// level), in place, for Hopper (sm_90a): the recurrent product on the TF32
// tensor cores with the 3xTF32 split, only for the slots before the
// level's live count, its depth split over a thread-block cluster.
//
// Replaces the TPU kernels of src/repro/kernels/level_megastep.py:
//   K3 `lstm_megastep` (:98, its pallas_call at :124),
//   K4 `gru_megastep`  (:238, its pallas_call at :262).
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
//
//   buf[offset + m] = state * node_mask[m]      (zeros where it is 0)
//
// Schedule contract (src/repro/core/structure.py pack_batch): an absent
// predecessor points at the zero row `sentinel`; predecessors live at
// lower levels, so the rows read (< offset, or the sentinel) never overlap
// the block written, which is what makes the in-place write sound.  Rows
// outside the block, the sentinel among them, come out bit-unchanged.
//
// Bound on an H100 SXM (700 W).  A slot with no predecessor needs no
// product: with p = 0, lstm's c = sigmoid(x_i + b_i) tanh(x_u + b_u) and
// h = sigmoid(x_o + b_o) tanh(c); gru's h = (1 - z) tanh(x_n + r b_n), z
// and r from x + b.  So a level of such slots (level 0 of a batch) is
// bound by bytes.  A slot with a predecessor needs NG H^2 multiply-adds
// (NG = 4 lanes for lstm, 3 for gru), each as three TF32 products at 495
// TFLOP/s (at the 67 TFLOP/s of fp32 FMAs without tensor cores, 2.5x as
// long): a Var-LSTM level of 128 chains at H 512 is 0.27 GFLOP, 1.6 us as
// TF32 products (4.0 us as FMAs), against the 4 MB weight and ~2 MB of
// rows (1.8 us of bytes).
//
// Design, against what held the fp32 SIMT kernel it replaces
// (cell_megastep.cu, 16 CTAs of 64 slots x 64 columns at M 128, H 512;
// synchronous staging; fp32 FMAs; every slot covered) at 2 % of its bound:
//   1. Products only where a slot may have a predecessor.  The host passes
//      `live`, one past the last slot with a child other than the sentinel
//      (counted from child_ids in numpy when the schedule goes to the
//      card, core/structure.py `level_live`).  The product kernel's grid
//      covers the slots [0, live) only; a second, elementwise launch
//      (k34_leaf_kernel, bound by bytes) writes [live, M) with the
//      formula of a slot with no predecessor, or zeros for padding,
//      reading no predecessor row and no weight.  A level takes at most
//      these two launches (level 0 of a batch only the second).  Without
//      `live` (the decode engine, the continuous chain frontier) the grid
//      covers every slot; a tile of the product grid none of whose slots
//      has a child takes that formula at once, with no product.
//   2. Filling the card.  A tile is 64 slots x 16 hidden columns, a CTA
//      four warps of 32 slots; a level of 128 slots is 64 tiles at H 512.
//      The depth of the product is split over a cluster of s = 1, 2, 4 or
//      8 CTAs, chosen by the host as for K2's lstm and gru pass (a)
//      (level_megastep.py `cell_split`, `k2_split`): 256 CTAs at M 128, H
//      512.  The gathered predecessor rows and weight tiles stream by
//      cp.async through a ring of three chunk stages; what the epilogue
//      reads (the slot's ext lanes, the predecessor's c (lstm) or h (gru),
//      the bias) is copied into shared memory right after the loop,
//      landing while the partials are stored and the cluster meets.
//   3. The tensor cores.  The product runs on mma.sync.m16n8k8 TF32 with
//      the 3xTF32 split (about 21 bits of each operand, which keeps the
//      fp32 bar of 1e-4 that one TF32 product misses) into fp32
//      accumulators; the ranks' partials are added in rank order through
//      distributed shared memory.  No float atomics: two launches give the
//      same bits.
// The loop, the split and the rank-order sum are gathered_product.cuh's
// `Product` in its one-operand shape, the very code of K2's lstm and gru
// pass (a) (bwd_megastep_sm90.cu); this file adds the forward epilogues
// and the path of slots with no predecessor.

#include "gathered_product.cuh"

namespace {

constexpr int NT = 128;         // threads of a product CTA: four warps
constexpr int BJ = 16;          // hidden columns a product tile
constexpr int NT_LEAF = 256;    // threads of a leaf CTA
constexpr int MAX_LEAF_CTAS = 4096;

enum Kind { LSTM = 0, GRU = 1 };

struct Args : Level {
  float* out;                   // the buffer itself, written in place
  int split;                    // CTAs of a cluster splitting the depth
};

template <int KIND>
struct Cfg {
  static constexpr int NQ = KIND == LSTM ? 4 : 3;   // gate lanes
  // The product: the predecessor's h against the NQ lanes of W_h.
  using Prod = Product<NT, 1, NQ, -1, BJ>;
  // Past the partial tile: a side row a slot (its ext lanes, then the
  // predecessor's c (lstm) or h (gru)), then the bias lanes.
  static constexpr int SIDE = (NQ + 1) * BJ;
  static constexpr int END = Prod::P + BM * SIDE + NQ * BJ;
  static constexpr int SMEM = 4 * (Prod::RING > END ? Prod::RING : END);
};

// The state of a slot at one column, in the reference's order: x its ext
// lanes and b the bias lanes (`ls` floats apart), v its products, pv the
// predecessor's c (lstm) or h (gru).  lstm gives c and h; gru h (in c).
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
  } else {
    const float z = sigmoid_f(x[0] + (v[0] + b[0]));
    const float r = sigmoid_f(x[ls] + (v[1] + b[ls]));
    const float n = tanhf(x[2 * ls] + r * (v[2] + b[2 * ls]));
    c = (1.0f - z) * n + z * pv;
  }
}

// The state of a slot with no predecessor (p = 0, no product): what
// `cell` gives with v = 0 and pv = 0, bit for bit.  x and b as for
// `cell`; lstm reads lanes i, o, u, gru lanes z, r, n.
template <int KIND>
__device__ __forceinline__ void leaf_cell(const float* x, const float* b,
                                          int ls, float& c, float& h) {
  if constexpr (KIND == LSTM) {
    const float ig = sigmoid_f(x[0] + b[0]);
    const float og = sigmoid_f(x[2 * ls] + b[2 * ls]);
    c = ig * tanhf(x[3 * ls] + b[3 * ls]);
    h = og * tanhf(c);
  } else {
    const float z = sigmoid_f(x[0] + b[0]);
    const float r = sigmoid_f(x[ls] + b[ls]);
    c = (1.0f - z) * tanhf(x[2 * ls] + r * b[2 * ls]);
  }
}

// Row gm of the block, column j, from the state (zeros where the node
// mask is 0).
template <int KIND>
__device__ __forceinline__ void put(const Args& a, int gm, int j, float c,
                                    float h, float nm) {
  float* out = a.out + (size_t)(a.offset + gm) * a.buf_stride;
  out[j] = nm != 0.0f ? c * nm : 0.0f;
  if constexpr (KIND == LSTM) out[a.H + j] = nm != 0.0f ? h * nm : 0.0f;
}

// The formula of a slot with no predecessor for slot gm, column j, its
// lanes read from global memory.
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
__global__ void __launch_bounds__(NT) k34_gates_kernel(const Args a) {
  using C = Cfg<KIND>;
  using Prod = typename C::Prod;
  constexpr int NQ = C::NQ;
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
    // no predecessor for this rank's rows, no product and no cluster
    // barrier.
    for (int i = tid; i < rows * BJ; i += NT) {
      const int row = r0 + i / BJ, gm = m0 + row, j = j0 + i % BJ;
      if (gm < a.live && j < H) leaf<KIND>(a, gm, eid_s[row], j, nm_s[row]);
    }
    return;
  }

  const int cps = (H + BK - 1) / BK;             // chunks of the depth
  const int c_lo = rank * cps / s, c_hi = (rank + 1) * cps / s;
  const bool wide = a.wide != 0;
  // lstm's operand is the h half of a [c | h] row; gru's row is h alone.
  const int col = KIND == LSTM ? H : 0;
  Prod prod;
  prod.run(smem, c_lo, c_hi, cps, H, H - j0, a.live - m0, wide, a.buf, a.w,
           [&](int, int, int r) -> const float* {   // the predecessor's h
             const int id = cid_s[0][r];
             return id >= 0 ? a.buf + (size_t)id * a.buf_stride + col
                            : nullptr;
           },
           [&](int q, int) -> const float* { return a.w + q * H + j0; },
           NQ * H);

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
    cell<KIND>(sr, v, sr[NQ * BJ], sbias + jj, BJ, c, h);
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

// The slots [live, M), none of which has a predecessor: the formula of no
// predecessor (zeros for padding, whose ext row is not read), four
// columns a thread.
template <int KIND>
__global__ void __launch_bounds__(NT_LEAF) k34_leaf_kernel(const Args a) {
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
    float* out = a.out + (size_t)(a.offset + gm) * a.buf_stride + j;
    store4(out, c, nj, wide);
    if (KIND == LSTM) store4(out + H, h, nj, wide);
  }
}

template <int KIND>
int launch(const Args& a, cudaStream_t stream, int* launches) {
  using C = Cfg<KIND>;
  // The shared-memory opt-in is set once a device (it is per device).
  constexpr int MAX_DEVICES = 64;
  static bool ready[MAX_DEVICES] = {};
  auto kg = k34_gates_kernel<KIND>;
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
    e = launch_cluster(kg, dim3((a.H + BJ - 1) / BJ * a.split,
                                (a.live + BM - 1) / BM),
                       NT, a.split, C::SMEM, a, stream);
    if (e != cudaSuccess) return (int)e;
    ++*launches;
  }
  if (a.live < a.M) {
    const long long n = (long long)(a.M - a.live) * ((a.H + 3) / 4);
    const long long ctas = (n + NT_LEAF - 1) / NT_LEAF;
    k34_leaf_kernel<KIND><<<(int)(ctas < MAX_LEAF_CTAS ? ctas
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
          void* launches, void* stream) {
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
  a.buf_stride = buf_stride; a.ext_stride = ext_stride;
  // 16-byte copies need 16-byte aligned rows: H, the strides and the
  // bases of what is read or written (buf, ext, w, bias) a multiple of
  // 16 B.
  a.wide = H % 4 == 0 && buf_stride % 4 == 0 && ext_stride % 4 == 0 &&
           aligned16(buf) && aligned16(ext) && aligned16(w) &&
           aligned16(bias);
  return launch<KIND>(a, static_cast<cudaStream_t>(stream), nl);
}

}  // namespace

// Plain C entry points (loaded with ctypes), one per kind.  Every pointer
// but `launches` is a device pointer; `launches` is a host int that gets
// the number of CUDA launches made (at most 2); `stream` is a
// cudaStream_t.  `sentinel`: the zero row absent predecessors point at.
// `live`: slots [live, M) have no child other than the sentinel (M where
// the caller does not know).  `split`: CTAs of a cluster splitting the
// product's depth (1, 2, 4 or 8).  Each returns the cudaError_t of the
// launches (0 on success); cudaErrorInvalidValue for arguments the
// kernels do not take.
#define CELL_MEGASTEP_ENTRY(NAME, KIND)                                       \
  extern "C" int NAME(void* buf, const void* child_ids, const void* ext_ids, \
                      const void* node_mask, const void* ext, const void* w, \
                      const void* bias, int M, int A, int H, int offset,     \
                      int sentinel, int buf_stride, int ext_stride,          \
                      int live, int split, void* launches, void* stream) {   \
    return entry<KIND>(buf, child_ids, ext_ids, node_mask, ext, w, bias, M,  \
                       A, H, offset, sentinel, buf_stride, ext_stride, live, \
                       split, launches, stream);                             \
  }

CELL_MEGASTEP_ENTRY(lstm_megastep_sm90_launch, LSTM)
CELL_MEGASTEP_ENTRY(gru_megastep_sm90_launch, GRU)

// Dynamic shared memory a product CTA of kind `kind` (0 lstm, 1 gru; for
// the report).
extern "C" int cell_megastep_smem_bytes(int kind) {
  return kind == LSTM ? Cfg<LSTM>::SMEM : Cfg<GRU>::SMEM;
}
