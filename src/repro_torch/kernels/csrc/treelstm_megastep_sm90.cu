// One N-ary child-sum Tree-LSTM batching task (one level), in place, for
// Hopper (sm_90a): the products on the TF32 tensor cores with the 3xTF32
// split, only for the slots that have children, their depth split over a
// thread-block cluster.
//
// Replaces the TPU kernel src/repro/kernels/level_megastep.py:181
// `treelstm_megastep` (its pallas_call at :209).  It computes what
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
//     buf[dest(m)] = [c | h] * node_mask[m]        (zeros where it is 0)
//   with x = ext[ext_ids[m]] the hoisted input projection row, and dest(m)
//   row offset + m of the level's block, or, where the caller passes
//   `out_ids` (the continuous engine's union frontier), row out_ids[m],
//   no row at all where out_ids[m] lies outside [0, rows) (a pad lane):
//   the frontier's scatter (K6b) folded into the store, so a tick is one
//   launch (gathered_product.cuh `dest_row`).
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
// Bound on an H100 SXM (700 W).  A leaf -- a slot with no child other
// than the sentinel -- needs no product: c = sigmoid(x_i + b_i) tanh(x_u +
// b_u), h = sigmoid(x_o + b_o) tanh(c).  So a level of leaves is bound by
// bytes: its ext rows' i, o and u lanes read once and its block written
// once at 3.35 TB/s (level 0 of a served batch, about 1,000 leaves at H
// 512: 6 MB + 4 MB, 3 us).  A slot with k children needs (3 + k) H^2
// multiply-adds (hsum . U_i, U_o, U_u and h_k . U_f), each as three TF32
// products at 495 TFLOP/s (at the 67 TFLOP/s of fp32 FMAs without tensor
// cores, 2.5x as long): a served level of 343 slots with two children
// each at H 512 is 0.90 GFLOP, 5.4 us as TF32 products (13.4 us as FMAs)
// against 12 MB of bytes (3.6 us), bound by operations; the small levels
// (tens of live slots) are bound by the 4 MB weight's bytes.
//
// Design, against what held the fp32 SIMT kernel it replaces at 3.6 % of
// its bound:
//   1. Products only where a slot needs them.  The host passes `live`, one
//      past the last slot with a child other than the sentinel (counted
//      from child_ids in numpy when the schedule goes to the card,
//      core/structure.py `level_live`).  The product kernel's grid covers
//      the slots [0, live) only; a second, elementwise launch
//      (k1_leaf_kernel, bound by bytes) writes [live, M) with the leaf
//      formula, or zeros for padding, reading no child row and no weight.
//      A level takes at most these two launches (level 0 of a batch only
//      the second).  Without `live` (the continuous frontier, where leaves
//      and inner nodes share lanes) the grid covers every slot; a tile of
//      the product grid whose slots have no child takes the leaf formula
//      at once, with no product.
//   2. Filling the card at every level size.  A tile is 64 slots x 16
//      hidden columns, a CTA eight warps; a level of 30 live slots is 32
//      tiles at H 512.  The depth of the product is split over a cluster
//      of s = 1, 2, 4 or 8 CTAs, chosen by the host as for K2's pass (a)
//      (level_megastep.py `k1_split`, `k2_split`): about eight warps an
//      SM, then more while each rank keeps at least 8 chunks.  The
//      gathered child rows and weight tiles stream by cp.async through a
//      ring of three chunk stages; what the epilogue reads (the slot's ext
//      lanes, the children's c, the bias) is copied into shared memory
//      right after the loop, landing while the partials are stored and
//      the cluster meets.
//   3. The tensor cores.  Each product runs on mma.sync.m16n8k8 TF32 with
//      the 3xTF32 split (about 21 bits of each operand, which keeps the
//      fp32 bar of 1e-4 that one TF32 product misses) into fp32
//      accumulators; the ranks' partials are added in rank order through
//      distributed shared memory.  No float atomics: two launches give the
//      same bits.
// The loop, the split and the rank-order sum are gathered_product.cuh's
// `Product` in its child-sum shape, the very code of K2's pass (a)
// (bwd_megastep_sm90.cu); this file adds the forward epilogue and the
// leaf path.

#include "gathered_product.cuh"

namespace {

constexpr int NT = 256;         // threads of a product CTA: eight warps
constexpr int BJ = 16;          // hidden columns a product tile
constexpr int NT_LEAF = 256;    // threads of a leaf CTA
constexpr int MAX_LEAF_CTAS = 4096;

using Args = FwdLevel;

template <int TA>
struct Cfg {
  // The child-sum product: TA children, lanes i|f|o|u, the f lane (1) on
  // each child's h, the others on their sum.
  using Prod = Product<NT, TA, 4, 1, BJ>;
  // Past the partial tile: a side row a slot (its ext lanes i|f|o|u, then
  // its children's c), then the bias lanes.
  static constexpr int SIDE = (4 + TA) * BJ;
  static constexpr int END = Prod::P + BM * SIDE + 4 * BJ;
  static constexpr int SMEM = 4 * (Prod::RING > END ? Prod::RING : END);
};

// c and h of a slot with children at one column, in the reference's
// order: x its ext lanes i|f|o|u and b the bias lanes (`ls` floats apart),
// v its products (i, o, u, then each child's f lane), ck its children's c
// (`ls` apart).
template <int A>
__device__ __forceinline__ void cell(const float* x, const float* v,
                                     const float* ck, const float* b, int ls,
                                     float& c, float& h) {
  const float ig = sigmoid_f(x[0] + v[0] + b[0]);
  const float og = sigmoid_f(x[2 * ls] + v[1] + b[2 * ls]);
  const float ug = tanhf(x[3 * ls] + v[2] + b[3 * ls]);
  float fc = 0.0f;
#pragma unroll
  for (int k = 0; k < A; ++k)
    fc += sigmoid_f(x[ls] + v[3 + k] + b[ls]) * ck[k * ls];
  c = ig * ug + fc;
  h = og * tanhf(c);
}

// c and h of a leaf: no product, no child.
__device__ __forceinline__ void leaf_cell(float xi, float xo, float xu,
                                          float bi, float bo, float bu,
                                          float& c, float& h) {
  const float ig = sigmoid_f(xi + bi);
  const float og = sigmoid_f(xo + bo);
  c = ig * tanhf(xu + bu);
  h = og * tanhf(c);
}

// Slot gm's row, column j, from c and h (zeros where the node mask is
// 0); nothing for a pad lane of the frontier.
__device__ __forceinline__ void put(const Args& a, int gm, int j, float c,
                                    float h, float nm) {
  float* out = dest_row(a, gm);
  if (out == nullptr) return;
  out[j] = nm != 0.0f ? c * nm : 0.0f;
  out[a.H + j] = nm != 0.0f ? h * nm : 0.0f;
}

// The leaf formula for slot gm, column j, its lanes read from global
// memory.
__device__ __forceinline__ void leaf(const Args& a, int gm, int eid, int j,
                                     float nm) {
  float c = 0.0f, h = 0.0f;
  if (nm != 0.0f) {
    const float* x = a.ext + (size_t)eid * a.ext_stride + j;
    const float* b = a.bias + j;
    leaf_cell(x[0], x[2 * a.H], x[3 * a.H], b[0], b[2 * a.H], b[3 * a.H],
              c, h);
  }
  put(a, gm, j, c, h, nm);
}

// The slots [0, live) of a tile of BM slots x BJ columns: the gathered
// product, its depth split over the cluster, then the forward epilogue.
template <int TA>
__global__ void __launch_bounds__(NT) k1_gates_kernel(const Args a) {
  using C = Cfg<TA>;
  using Prod = typename C::Prod;
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
    // No slot of the tile has a child (every rank alike): the leaf
    // formula for this rank's rows, no product and no cluster barrier.
    for (int i = tid; i < rows * BJ; i += NT) {
      const int row = r0 + i / BJ, gm = m0 + row, j = j0 + i % BJ;
      if (gm < a.live && j < H) leaf(a, gm, eid_s[row], j, nm_s[row]);
    }
    return;
  }

  const int cps = (H + BK - 1) / BK;             // chunks of the depth
  const int c_lo = rank * cps / s, c_hi = (rank + 1) * cps / s;
  const bool wide = a.wide != 0;
  Prod prod;
  prod.run(smem, c_lo, c_hi, cps, H, H - j0, a.live - m0, wide, a.buf, a.w,
           [&](int x, int, int r) -> const float* {     // child x's h
             const int id = cid_s[x][r];
             return id >= 0 ? a.buf + (size_t)id * a.buf_stride + H
                            : nullptr;
           },
           [&](int q, int) -> const float* { return a.w + q * H + j0; },
           4 * H);

  // The epilogue's inputs for this rank's rows, past the partial tile:
  // in flight while the partials are stored and the cluster meets.
  float* side = smem + Prod::P;
  float* sbias = side + BM * C::SIDE;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    stage<NT, BJ, C::SIDE>(side + q * BJ, rows, H - j0, wide, a.ext,
                           [&](int r, int cc) -> const float* {
                             return m0 + r0 + r < a.live
                                 ? a.ext + (size_t)eid_s[r0 + r]
                                       * a.ext_stride + q * H + j0 + cc
                                 : nullptr;
                           });
#pragma unroll
  for (int k = 0; k < TA; ++k)
    stage<NT, BJ, C::SIDE>(side + (4 + k) * BJ, rows, H - j0, wide, a.buf,
                           [&](int r, int cc) -> const float* {
                             const int id = cid_s[k][r0 + r];
                             return id >= 0 ? a.buf + (size_t)id
                                                  * a.buf_stride + j0 + cc
                                            : nullptr;
                           });
  stage<NT, BJ, BJ>(sbias, 4, H - j0, wide, a.bias,
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
    float v[Prod::NACC];
#pragma unroll
    for (int q = 0; q < Prod::NACC; ++q) v[q] = Prod::value(pb, row, q, jj, s);
    const float* sr = side + rr * C::SIDE + jj;
    float c, h;
    cell<TA>(sr, v, sr + 4 * BJ, sbias + jj, BJ, c, h);
    put(a, gm, j, c, h, nm_s[row]);
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

// The slots [live, M), none of which has a child: the leaf formula (zeros
// for padding, whose ext row is not read), four columns a thread.
__global__ void __launch_bounds__(NT_LEAF) k1_leaf_kernel(const Args a) {
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
      float xi[4], xo[4], xu[4], bi[4], bo[4], bu[4];
      load4(xi, x, nj, wide);
      load4(xo, x + 2 * H, nj, wide);
      load4(xu, x + 3 * H, nj, wide);
      load4(bi, b, nj, wide);
      load4(bo, b + 2 * H, nj, wide);
      load4(bu, b + 3 * H, nj, wide);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        leaf_cell(xi[e], xo[e], xu[e], bi[e], bo[e], bu[e], c[e], h[e]);
        c[e] *= nm;
        h[e] *= nm;
      }
    }
    float* out = dest_row(a, gm);
    if (out == nullptr) continue;
    store4(out + j, c, nj, wide);
    store4(out + H + j, h, nj, wide);
  }
}

template <int TA>
int launch(const Args& a, cudaStream_t stream, int* launches) {
  using C = Cfg<TA>;
  // The shared-memory opt-in is set once a device (it is per device).
  constexpr int MAX_DEVICES = 64;
  static bool ready[MAX_DEVICES] = {};
  auto kg = k1_gates_kernel<TA>;
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
    k1_leaf_kernel<<<(int)(ctas < MAX_LEAF_CTAS ? ctas : MAX_LEAF_CTAS),
                     NT_LEAF, 0, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launches;
  }
  return 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer but `launches`
// is a device pointer; `launches` is a host int that gets the number of
// CUDA launches made (at most 2); `stream` is a cudaStream_t.  `sentinel`:
// the zero row absent children point at.  `live`: slots [live, M) have no
// child other than the sentinel (M where the caller does not know).
// `split`: CTAs of a cluster splitting the product's depth (1, 2, 4 or
// 8).  `out_ids`: null, or [M] int32 destination rows (then `offset` is
// not read; the schedule contract above); `rows`: the buffer's rows.
// Returns the cudaError_t of the launches (0 on success);
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int treelstm_megastep_sm90_launch(
    void* buf, const void* child_ids, const void* ext_ids,
    const void* node_mask, const void* ext, const void* w, const void* bias,
    int M, int A, int H, int offset, int sentinel, int buf_stride,
    int ext_stride, int live, int split, const void* out_ids, int rows,
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
  a.out_ids = static_cast<const int*>(out_ids);
  a.rows = rows;
  a.buf_stride = buf_stride; a.ext_stride = ext_stride;
  // 16-byte copies need 16-byte aligned rows: H, the strides and the
  // bases of what is read or written (buf, ext, w, bias) a multiple of
  // 16 B.
  a.wide = H % 4 == 0 && buf_stride % 4 == 0 && ext_stride % 4 == 0 &&
           aligned16(buf) && aligned16(ext) && aligned16(w) &&
           aligned16(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (A) {
    case 1: return launch<1>(a, s, nl);
    case 2: return launch<2>(a, s, nl);
    case 3: return launch<3>(a, s, nl);
    default: return launch<4>(a, s, nl);
  }
}

// Dynamic shared memory a product CTA at arity A (for the report).
extern "C" int treelstm_megastep_smem_bytes(int A) {
  switch (A) {
    case 1: return Cfg<1>::SMEM;
    case 2: return Cfg<2>::SMEM;
    case 3: return Cfg<3>::SMEM;
    default: return Cfg<4>::SMEM;
  }
}
