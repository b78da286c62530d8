// The reverse level-megastep of every kind (treelstm, lstm, gru, treefc):
// one reverse batching task (one level) for Hopper (sm_90a).  Both of its
// products run on the TF32 tensor cores by `mma.sync`, each split into
// three TF32 products (3xTF32) accumulated in fp32.  The gradient buffer
// is updated in place.
//
// Replaces the TPU kernel src/repro/kernels/level_megastep_bwd.py:205
// `bwd_megastep` (its pallas_call at :276), all four kinds.  It computes
// what src/repro_torch/kernels/ref.py `bwd_megastep(kind, ...)` computes,
// the math of level_megastep.level_bwd: for each slot m of the level
// (rows [offset, offset+M) of g, only read), with g_s = g[offset + m] *
// node_mask[m], x = ext[ext_ids[m]] and the child rows re-gathered from
// the residual node buffer (an absent child, at the sentinel row, reads
// as zeros):
//
//   treelstm: recompute i, o, u from hsum = sum_k h_k and f_k from h_k
//             (no +1.0 on f); c = i*u + sum_k f_k c_k
//             gc = g_c + g_h o (1 - tanh(c)^2)
//             d_i = gc u i(1-i), d_o = g_h tanh(c) o(1-o), d_u = gc i(1-u^2)
//             d_fk = gc c_k f_k (1-f_k)
//             child k gets [gc f_k | d_i U_i^T + d_o U_o^T + d_u U_u^T
//                                    + d_fk U_f^T]
//   lstm:     recompute i, f (+1.0), o, u, c from the predecessor p
//             d = [gc u i(1-i) | gc p_c f(1-f) | g_h tc o(1-o) | gc i(1-u^2)]
//             each child gets [gc f | d W_h^T]
//   gru:      recompute z, r, rec_n = p W_hn + b_n, n
//             d_n = g_h(1-z)(1-n^2), d_z = g_h(p-n)z(1-z),
//             d_r = d_n rec_n r(1-r)
//             each child gets g_h z + [d_z | d_r | d_n r] W_h^T
//   treefc:   d_pre = g_s (1 - h^2), h recomputed; child a gets
//             d_pre wc[a*H:(a+1)*H]^T
//
// and g[child_ids[m, a]] += that cotangent for every child that exists.
// As in the reference, lstm and gru hand the slot's one cotangent to every
// existing child.  Children live at lower levels, so the rows written
// (< offset) never overlap the level's own block.  The sentinel row and
// every row no child points at come out bit-unchanged.
//
// Precision.  The reference computes in f32 and the card's bar is 1e-4 of
// max |plain|; a TF32 product keeps 11 bits of each operand.  So every
// operand x is split in registers into x_big = cvt.rna.tf32(x) and
// x_small = tf32(x - x_big), and each k-step of 8 runs as a_small b_big +
// a_big b_small + a_big b_big into an fp32 accumulator (about 21 bits of
// each operand), the split of flash_attention_tf32.cu.
//
// Design.  The host passes, per level, `live` (one past the last slot with
// a child other than the sentinel, counted from child_ids in numpy when
// the schedule is built) and whether every destination row receives one
// contribution (every tree and chain level).  The grid covers [0, live)
// only; a level with no live slot launches nothing.  Two launches a level,
// a third only where a destination has several contributions:
//   (a) k2_gates_kernel: a tile of BM = 64 slots x BJ hidden columns (BJ
//       16; 64 for treefc, whose product has one lane) recomputes every
//       gate lane of its columns -- X . W with X the gathered child rows
//       (treelstm: hsum for the i/o/u lanes and each h_k for its f lane,
//       one lane product per child), the `Product` of
//       gathered_product.cuh that the forward K1 runs too -- then runs the
//       column-local cotangent math and writes the gate cotangents to the
//       workspace.
//       The c half of the child cotangent (treelstm, lstm) is column-local
//       too: with one contribution a row it is added into g here, g[dest]
//       = g[dest] + c, the single fp32 add a sorted run of one makes;
//   (b) k2_hgrad_kernel: a tile of 64 slots x BN output columns (BN 64;
//       32 for treelstm, which keeps the shared d_i/d_o/d_u product and
//       one d_fk product per child in registers) forms D . W^T over the
//       gate depth and adds the result into g[dest] the same way;
//   (c) k2_runs_kernel, only on a level where a destination row has
//       several contributions (a DAG level): (a) and (b) write the child
//       cotangents to the workspace instead, and one CTA per destination
//       run (the host's list of run heads) seeds from g, adds the run's
//       contributions in sorted order and writes the row once.
// Filling the card: a level of Var-LSTM/GRU (128 slots) is 2 row tiles;
// a Tree-LSTM level has tens of tiles.  So both products are split over
// their depth (split-K) across a thread-block cluster of s = 1, 2, 4 or 8
// CTAs, chosen by the host (level_megastep.py `k2_split`): about
// eight warps an SM, then more while each rank keeps at least 8 chunks
// and the launch at most sixteen warps an SM.  Rank r takes the chunks
// [r n / s, (r+1) n / s) of the n chunks of BK = 32 along the depth.
// A CTA is eight warps, each 16 slots x half the tile's columns (the
// lstm, gru and treefc pass (a): four warps of 32 slots, which gives
// each operand split two products; treelstm's pass (a) and every pass
// (b) are quicker with more warps an SM).  The per-chunk instruction
// stream (copies, splits, fragment loads) is what a CTA waits on, not
// memory: so the split and the warps, not the tile, set a level's time.
// After its loop each CTA stores its partial tile in its own shared
// memory; after cluster.sync() rank r sums rows [r 64/s, (r+1) 64/s) of
// the tile over the ranks in rank order through distributed shared memory
// (every rank's load in flight before the first add) and runs the
// epilogue for them.  What that epilogue reads from global memory (ext
// lanes, the slot's g row, the children's c, the destination rows it adds
// into, the bias) is copied into shared memory by cp.async right after
// the loop, so it lands while the partials are stored and the cluster
// meets: one wait, not a global load an item.  Warps skip the mma of a
// 16-row block that holds no live slot.  No float atomics: two launches
// give the same bits.  Staging: child rows (gathered by the tile's child
// ids), workspace rows and weight tiles are copied by cp.async, 16 bytes
// a thread (4 bytes where H, a base or a stride is no multiple of 16
// bytes), into a ring of three chunk stages, so two chunks are in flight
// while one is multiplied; columns and depth past H are zero-filled, so
// any H takes this kernel.  A-operand fragments come by ldmatrix from
// raw f32 tiles (rows padded to BK + 4 words); the weight's fragments
// in pass (a), read along its rows, by scalar loads (rows padded to BJ +
// 8 words: the (t, g) pattern hits 32 banks).  A tile of slots none of
// which has a child other than the sentinel exits at once, in both passes
// (so no pass reads a workspace row that was not written), and writes
// nothing.  The workspace (level_megastep_bwd.py `workspace_numel`) is
// allocated by the caller once per backward.
//
// Bound on an H100 SXM (700 W): the multiply-adds that the level's slots
// with a child need (treelstm (A+3) H^2 a slot with A children for the
// recompute and as many for the child cotangents; lstm/gru NG H^2 twice;
// treefc H^2 per child twice), each as three TF32 products at 495 TFLOP/s,
// against each input read once and each touched row read and written
// once at 3.35 TB/s.  A Var-LSTM level (128 slots, H 512) is 0.54 GFLOP,
// 1.6 as TF32 products: 3.3 us, bound by operations; Tree-FC's level 1
// (8,192 slots, A 2) 17 GFLOP: 0.104 ms.

#include "gathered_product.cuh"

namespace {

constexpr int NT_RUN = 128;     // threads of a run CTA

enum Kind { TREELSTM = 0, LSTM = 1, GRU = 2, TREEFC = 3 };

struct Args : Level {
  float* g;
  const int* sort_perm;
  const int* scid;
  const int* heads;
  float* ws;
  int single, nruns, split_a, split_b;
  long long g_stride;
};

// Shapes of one kind.  TA: the arity the treelstm kernels are built for
// (the other kinds take A at run time).  After its depth loop a CTA keeps
// its partial tile P at the start of its shared memory and stages, past
// it, what its epilogue reads for its rank's rows ("side" rows, one a
// slot, so that the epilogue waits on one copy and not on a global load
// an item): pass (a) a slot's ext lanes, its g row (the state cotangent),
// the children's c (treelstm) or the predecessor's c / h (lstm / gru),
// the destinations' g rows it adds into (treelstm, lstm), and the bias;
// pass (b) the destinations' g rows and gru's g_h z.
template <int KIND, int TA>
struct Cfg {
  static constexpr int NQ = KIND == GRU ? 3 : (KIND == TREEFC ? 1 : 4);
  static constexpr int SW = (KIND == GRU || KIND == TREEFC) ? 1 : 2;
  // Threads a CTA (level_megastep_bwd.py K2_WARPS_A, K2_WARPS_B): pass
  // (b) and treelstm's pass (a) run eight warps of 16 slots x half the
  // tile's columns; the other kinds' pass (a) four warps of 32 slots,
  // twice the products for each operand split, and twice the CTAs a
  // launch (measured on an H100: PERF.md §6).
  static constexpr int NTA = KIND == TREELSTM ? 256 : 128;
  static constexpr int NTB = 256;
  static constexpr int MBB = BM / 16 / (NTB / 64);
  // pass (a): the gathered product of gathered_product.cuh, treelstm's in
  // its child-sum shape (the f lane, 1, on each child's h).
  static constexpr int BJ = KIND == TREEFC ? 64 : 16;
  using ProdA = Product<NTA, KIND == TREELSTM ? TA : 1, NQ,
                        KIND == TREELSTM ? 1 : -1, BJ>;
  static constexpr int NACC = ProdA::NACC;
  static constexpr int NCH = KIND == TREELSTM ? TA : (KIND == TREEFC ? 0 : 1);
  static constexpr int NDA = KIND == TREELSTM ? TA : (KIND == LSTM ? MAX_A : 0);
  static constexpr int SIDE_A = (NQ + SW + NCH + NDA) * BJ;  // floats a row
  static constexpr int P_A = ProdA::P;
  static constexpr int END_A = P_A + BM * SIDE_A + NQ * BJ;
  static constexpr int SMEM_A =
      4 * (ProdA::RING > END_A ? ProdA::RING : END_A);
  // pass (b)
  static constexpr int BN = KIND == TREELSTM ? 32 : 64;
  static constexpr int NB = BN / 16;       // n8 blocks a warp
  static constexpr int NXB = KIND == TREELSTM ? TA : 1;
  static constexpr int NSEG = KIND == GRU ? 3 : (KIND == TREEFC ? 1 : 4);
  static constexpr int NPL = KIND == TREELSTM ? 1 + TA : 1;
  static constexpr int STAGE_B = NXB * BM * LDA + BN * LDA;
  static constexpr int LDPB = BN + 4;
  static constexpr int NDB = KIND == TREELSTM ? TA : (KIND == TREEFC ? 1
                                                                       : MAX_A);
  static constexpr int SIDE_B = (NDB + (KIND == GRU ? 1 : 0)) * BN;
  static constexpr int P_B = NPL * BM * LDPB;
  static constexpr int END_B = P_B + BM * SIDE_B;
  static constexpr int SMEM_B =
      4 * (NSTAGE * STAGE_B > END_B ? NSTAGE * STAGE_B : END_B);
};

// The workspace of one kind (level_megastep_bwd.py `workspace_numel`):
// d, the gate cotangents [M, 3H | 4H | 3H | H]; df, treelstm's per-child
// d_f [M*A, H]; c, the child cotangents when a destination has several
// contributions [M*A, 2H] (treelstm), [M, 2H] (lstm), [M*A, H] (treefc),
// or gru's g_h*z and then its whole cotangent [M, H].
struct Ws {
  float* d;
  float* df;
  float* c;
};
template <int KIND>
__host__ __device__ __forceinline__ Ws workspace(const Args& a) {
  const size_t MH = (size_t)a.M * a.H;
  Ws w;
  w.d = a.ws;
  w.df = a.ws + 3 * MH;
  if (KIND == TREELSTM) w.c = w.df + (size_t)a.A * MH;
  else if (KIND == LSTM) w.c = a.ws + 4 * MH;
  else if (KIND == GRU) w.c = a.ws + 3 * MH;
  else w.c = a.ws + MH;
  return w;
}

// Pass (a)'s epilogue for slot gm (tile row `row`), column j = j0 + jj.
// v[q]: its gate lanes' products, reduced over the ranks; sr: its side
// row (C::SIDE_A floats: x lanes, g, children's c, destinations' g, each
// BJ wide); sb: the bias lanes.
template <int KIND, int TA>
__device__ __forceinline__ void epilogue_a(const Args& a, const Ws& ws,
                                           const float* v,
                                           int (*cid_s)[BM], int row,
                                           int gm, int j, int jj, float nm,
                                           const float* sr,
                                           const float* sb) {
  using C = Cfg<KIND, TA>;
  constexpr int BJ = C::BJ;
  const int H = a.H;
  const float* x = sr + jj;                       // lane q at x[q * BJ]
  const float* gr = sr + C::NQ * BJ + jj;         // g_s half h at gr[h BJ]
  const float* ch = gr + C::SW * BJ;              // child k at ch[k BJ]
  const float* old = ch + C::NCH * BJ;            // destination k's g
  const float* bias = sb + jj;
  if constexpr (KIND == TREELSTM) {
    const float ig = sigmoid_f(x[0] + v[0] + bias[0]);
    const float og = sigmoid_f(x[2 * BJ] + v[1] + bias[2 * BJ]);
    const float ug = tanhf(x[3 * BJ] + v[2] + bias[3 * BJ]);
    float fa[TA];
    float fc = 0.0f;
#pragma unroll
    for (int k = 0; k < TA; ++k) {
      fa[k] = sigmoid_f(x[BJ] + v[3 + k] + bias[BJ]);
      fc += fa[k] * ch[k * BJ];
    }
    const float c = ig * ug + fc;
    const float tc = tanhf(c);
    const float g_c = gr[0] * nm;
    const float g_h = gr[BJ] * nm;
    const float gc = g_c + g_h * og * (1.0f - tc * tc);
    float* d = ws.d + (size_t)gm * 3 * H;
    d[j] = gc * ug * ig * (1.0f - ig);
    d[H + j] = g_h * tc * og * (1.0f - og);
    d[2 * H + j] = gc * ig * (1.0f - ug * ug);
#pragma unroll
    for (int k = 0; k < TA; ++k) {
      const int r = cid_s[k][row];
      if (r < 0) continue;              // pass (b) zero-fills its d_f row
      ws.df[((size_t)gm * TA + k) * H + j] =
          gc * ch[k * BJ] * fa[k] * (1.0f - fa[k]);
      const float cc = gc * fa[k];
      if (a.single) a.g[(size_t)r * a.g_stride + j] = old[k * BJ] + cc;
      else ws.c[((size_t)gm * TA + k) * 2 * H + j] = cc;
    }
  } else if constexpr (KIND == LSTM) {
    const float c_prev = ch[0];
    const float ig = sigmoid_f(x[0] + v[0] + bias[0]);
    const float fg = sigmoid_f(x[BJ] + v[1] + bias[BJ] + 1.0f);
    const float og = sigmoid_f(x[2 * BJ] + v[2] + bias[2 * BJ]);
    const float ug = tanhf(x[3 * BJ] + v[3] + bias[3 * BJ]);
    const float c = fg * c_prev + ig * ug;
    const float tc = tanhf(c);
    const float g_c = gr[0] * nm;
    const float g_h = gr[BJ] * nm;
    const float gc = g_c + g_h * og * (1.0f - tc * tc);
    float* d = ws.d + (size_t)gm * 4 * H;
    d[j] = gc * ug * ig * (1.0f - ig);
    d[H + j] = gc * c_prev * fg * (1.0f - fg);
    d[2 * H + j] = g_h * tc * og * (1.0f - og);
    d[3 * H + j] = gc * ig * (1.0f - ug * ug);
    const float cc = gc * fg;
    if (a.single) {
      for (int k = 0; k < a.A; ++k)
        if (cid_s[k][row] >= 0)
          a.g[(size_t)cid_s[k][row] * a.g_stride + j] = old[k * BJ] + cc;
    } else {
      ws.c[(size_t)gm * 2 * H + j] = cc;
    }
  } else if constexpr (KIND == GRU) {
    const float h_prev = ch[0];
    const float z = sigmoid_f(x[0] + (v[0] + bias[0]));
    const float r = sigmoid_f(x[BJ] + (v[1] + bias[BJ]));
    const float hn = v[2] + bias[2 * BJ];
    const float n = tanhf(x[2 * BJ] + r * hn);
    const float g_h = gr[0] * nm;
    const float d_n = g_h * (1.0f - z) * (1.0f - n * n);
    const float d_z = g_h * (h_prev - n) * z * (1.0f - z);
    const float d_r = d_n * hn * r * (1.0f - r);
    float* d = ws.d + (size_t)gm * 3 * H;
    d[j] = d_z;
    d[H + j] = d_r;
    d[2 * H + j] = d_n * r;
    ws.c[(size_t)gm * H + j] = g_h * z;
  } else {
    const float hy = tanhf(v[0] + x[0] + bias[0]);
    ws.d[(size_t)gm * H + j] = gr[0] * nm * (1.0f - hy * hy);
  }
}

// Pass (a): recompute the gates of a tile of BM slots x BJ columns, its
// depth split over the cluster (the gathered product); the cotangent
// epilogue.
template <int KIND, int TA>
__global__ void __launch_bounds__(Cfg<KIND, TA>::NTA)
    k2_gates_kernel(const Args a) {
  using C = Cfg<KIND, TA>;
  using Prod = typename C::ProdA;
  extern __shared__ __align__(128) float smem[];
  __shared__ int cid_s[MAX_A][BM];
  __shared__ float nm_s[BM];
  __shared__ int eid_s[BM];
  cg::cluster_group cluster = cg::this_cluster();
  const int s = a.split_a;
  const int rank = (int)cluster.block_rank();
  const int j0 = (blockIdx.x / s) * C::BJ;
  const int m0 = blockIdx.y * BM;
  const int H = a.H;
  if (!load_ids<C::NTA>(cid_s, nm_s, eid_s, a, m0)) return;   // every rank alike

  const int cps = (H + BK - 1) / BK;             // chunks a segment
  const int nc = (KIND == TREEFC ? a.A : 1) * cps;
  const int c_lo = rank * nc / s, c_hi = (rank + 1) * nc / s;
  const bool wide = a.wide != 0;
  const int wrow = KIND == TREEFC ? H : C::NQ * H;  // floats a W row
  // The h half of a [c | h] row (treelstm, lstm); gru's and treefc's rows
  // are h alone.  Treelstm's operand x is child x; treefc's segment seg
  // reads child seg against wc's rows [seg H, (seg + 1) H).
  const int col = KIND == LSTM || KIND == TREELSTM ? H : 0;
  Prod prod;
  prod.run(smem, c_lo, c_hi, cps, H, H - j0, a.live - m0, wide, a.buf, a.w,
           [&](int x, int seg, int r) -> const float* {
             const int id =
                 cid_s[KIND == TREELSTM ? x : (KIND == TREEFC ? seg : 0)][r];
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
  const int tid = threadIdx.x;
  const int rows = BM / s, r0 = rank * rows;
  float* side = smem + C::P_A;
  float* sbias = side + BM * C::SIDE_A;
  {
    constexpr int BJ = C::BJ, SA = C::SIDE_A;
    auto live_row = [&](int r) { return m0 + r0 + r < a.live; };
#pragma unroll
    for (int q = 0; q < C::NQ; ++q)
      stage<C::NTA, BJ, SA>(side + q * BJ, rows, H - j0, wide, a.ext,
                    [&](int r, int cc) -> const float* {
                      return live_row(r)
                          ? a.ext + (size_t)eid_s[r0 + r] * a.ext_stride
                                + q * H + j0 + cc
                          : nullptr;
                    });
#pragma unroll
    for (int h = 0; h < C::SW; ++h)
      stage<C::NTA, BJ, SA>(side + (C::NQ + h) * BJ, rows, H - j0, wide, a.g,
                    [&](int r, int cc) -> const float* {
                      return live_row(r)
                          ? a.g + (size_t)(a.offset + m0 + r0 + r)
                                * a.g_stride + h * H + j0 + cc
                          : nullptr;
                    });
#pragma unroll
    for (int k = 0; k < C::NCH; ++k) {
      const int* ids = cid_s[k];
      stage<C::NTA, BJ, SA>(side + (C::NQ + C::SW + k) * BJ, rows, H - j0, wide,
                    a.buf, [&](int r, int cc) -> const float* {
                      const int id = ids[r0 + r];
                      return id >= 0 ? a.buf + (size_t)id * a.buf_stride
                                           + j0 + cc : nullptr;
                    });
    }
    if (a.single) {
#pragma unroll
      for (int k = 0; k < C::NDA; ++k) {
        if (k >= a.A) break;
        const int* ids = cid_s[k];
        stage<C::NTA, BJ, SA>(side + (C::NQ + C::SW + C::NCH + k) * BJ, rows,
                      H - j0, wide, a.g, [&](int r, int cc) -> const float* {
                        const int id = ids[r0 + r];
                        return id >= 0 ? a.g + (size_t)id * a.g_stride + j0
                                             + cc : nullptr;
                      });
      }
    }
    stage<C::NTA, BJ, BJ>(sbias, C::NQ, H - j0, wide, a.bias,
                  [&](int r, int cc) -> const float* {
                    return a.bias + r * H + j0 + cc;
                  });
    cp_commit();
  }

  prod.store(smem);
  cluster.sync();
  cp_wait<0>();                          // the side rows have landed
  __syncthreads();

  // Rank r: rows [r BM / s, (r + 1) BM / s) summed over the ranks in rank
  // order, then the epilogue.
  uint32_t pb[MAX_SPLIT];
  rank_bases(smem, s, pb);
  const Ws ws = workspace<KIND>(a);
  for (int i = tid; i < rows * C::BJ; i += C::NTA) {
    const int rr = i / C::BJ, jj = i % C::BJ;
    const int row = r0 + rr, gm = m0 + row, j = j0 + jj;
    if (gm >= a.live || j >= H) continue;
    float v[C::NACC];
#pragma unroll
    for (int q = 0; q < C::NACC; ++q) v[q] = Prod::value(pb, row, q, jj, s);
    epilogue_a<KIND, TA>(a, ws, v, cid_s, row, gm, j, jj, nm_s[row],
                         side + rr * C::SIDE_A, sbias);
  }
  cluster.sync();                        // no CTA leaves while read
}

// Pass (b): the product part of the child cotangents over a tile of BM
// slots x BN output columns, D . W^T along the gate depth in NSEG
// segments of H (lstm: d_i, d_f, d_o, d_u against W_h's column blocks;
// gru: d_z, d_r, d_n r; treefc: d_pre against wc, whose A*H rows are the
// output columns, child a's at [a H, (a+1) H); treelstm: d_i, d_o, d_u
// into the shared plane, then each d_fk against U_f into plane 1 + k).
template <int KIND, int TA>
__global__ void __launch_bounds__(Cfg<KIND, TA>::NTB)
    k2_hgrad_kernel(const Args a) {
  using C = Cfg<KIND, TA>;
  extern __shared__ __align__(128) float smem[];
  __shared__ int cid_s[MAX_A][BM];
  __shared__ float nm_s[BM];
  __shared__ int eid_s[BM];
  cg::cluster_group cluster = cg::this_cluster();
  const int s = a.split_b;
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / s) * C::BN;
  const int m0 = blockIdx.y * BM;
  const int H = a.H;
  if (!load_ids<C::NTB>(cid_s, nm_s, eid_s, a, m0)) return;

  const int ncols = KIND == TREEFC ? a.A * H : H;   // output columns
  const int cps = (H + BK - 1) / BK;
  const int nc = C::NSEG * cps;
  const int c_lo = rank * nc / s, c_hi = (rank + 1) * nc / s;
  const bool wide = a.wide != 0;
  const Ws ws = workspace<KIND>(a);
  // Floats a row of D and of W.
  const int drow = KIND == TREELSTM ? 3 * H : C::NQ * H;
  const int wrow = KIND == TREEFC ? H : C::NQ * H;

  auto issue = [&](int c) {
    if (c < c_hi) {
      const int seg = c / cps, k0 = (c - seg * cps) * BK;
      float* sa = smem + ((c - c_lo) % NSTAGE) * C::STAGE_B;
      float* sb = sa + C::NXB * BM * LDA;
      if (KIND == TREELSTM && seg == 3) {
#pragma unroll
        for (int xi = 0; xi < C::NXB; ++xi) {
          const int* ids = cid_s[xi];
          stage<C::NTB, BK, LDA>(sa + xi * BM * LDA, BM, H - k0, wide, a.ws,
                         [&](int r, int cc) -> const float* {
                           return ids[r] >= 0
                               ? ws.df + ((size_t)(m0 + r) * TA + xi) * H + k0
                                     + cc
                               : nullptr;
                         });
        }
      } else {
        const int col = seg * H + k0;
        stage<C::NTB, BK, LDA>(sa, BM, H - k0, wide, a.ws,
                       [&](int r, int cc) -> const float* {
                         return m0 + r < a.live
                             ? ws.d + (size_t)(m0 + r) * drow + col + cc
                             : nullptr;
                       });
      }
      // W^T's chunk as [n][k]: W row n, its segment's columns; treelstm's
      // packed U_i|U_f|U_o|U_u has d_i, d_o, d_u, d_f at blocks 0, 2, 3, 1.
      const int wcol = (KIND == TREELSTM ? (seg == 0 ? 0 : seg == 3 ? 1
                                                          : seg + 1)
                                         : seg) * H + k0;
      stage<C::NTB, BK, LDA>(sb, C::BN, H - k0, wide, a.w,
                     [&](int r, int cc) -> const float* {
                       return n0 + r < ncols
                           ? a.w + (size_t)(n0 + r) * wrow + wcol + cc
                           : nullptr;
                     });
    }
    cp_commit();
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int rw0 = 16 * C::MBB * (warp >> 1);
  const int nw0 = (warp & 1) * (C::BN / 2);
  const int aoff = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDA + 4 * (lane >> 4);
  // ldmatrix on [n][k]: rows (lane & 7) + 8 (lane >> 4) at column
  // 4 ((lane >> 3) & 1) give b0, b1 of two n8 blocks.
  const int boff = (nw0 + (lane & 7) + 8 * (lane >> 4)) * LDA +
                   4 * ((lane >> 3) & 1);

  float acc[C::NPL][C::MBB][C::NB][4];
#pragma unroll
  for (int p = 0; p < C::NPL; ++p)
#pragma unroll
    for (int mb = 0; mb < C::MBB; ++mb)
#pragma unroll
      for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][mb][nb][e] = 0.0f;

  issue(c_lo);
  issue(c_lo + 1);
  for (int c = c_lo; c < c_hi; ++c) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();
    issue(c + 2);
    const float* sa = smem + ((c - c_lo) % NSTAGE) * C::STAGE_B;
    const float* sb = sa + C::NXB * BM * LDA;
    const bool fseg = KIND == TREELSTM && c / cps == 3;
    const uint32_t aaddr = smem_addr(sa) + 4 * aoff;
    const uint32_t baddr = smem_addr(sb) + 4 * boff;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bg[C::NB][2], bs[C::NB][2];
#pragma unroll
      for (int nb = 0; nb < C::NB; nb += 2) {
        uint32_t r[4];
        ldsm_x4(baddr + 4 * (8 * nb * LDA + kk), r);
        split(__uint_as_float(r[0]), bg[nb][0], bs[nb][0]);
        split(__uint_as_float(r[1]), bg[nb][1], bs[nb][1]);
        split(__uint_as_float(r[2]), bg[nb + 1][0], bs[nb + 1][0]);
        split(__uint_as_float(r[3]), bg[nb + 1][1], bs[nb + 1][1]);
      }
#pragma unroll
      for (int mb = 0; mb < C::MBB; ++mb) {
        if (m0 + rw0 + 16 * mb >= a.live) continue;   // rows of no slot
        const uint32_t ra = aaddr + 4 * ((rw0 + 16 * mb) * LDA + kk);
        if (fseg) {
#pragma unroll
          for (int xi = 0; xi < C::NXB; ++xi) {
            uint32_t r[4], ag[4], as[4];
            ldsm_x4(ra + 4 * xi * BM * LDA, r);
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(r[e]);
            split4(v, ag, as);
#pragma unroll
            for (int nb = 0; nb < C::NB; ++nb)
              mma3(acc[C::NPL > 1 ? 1 + xi : 0][mb][nb], ag, as, bg[nb],
                   bs[nb]);
          }
        } else {
          uint32_t r[4], ag[4], as[4];
          ldsm_x4(ra, r);
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(r[e]);
          split4(v, ag, as);
#pragma unroll
          for (int nb = 0; nb < C::NB; ++nb)
            mma3(acc[0][mb][nb], ag, as, bg[nb], bs[nb]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // The destinations' g rows this rank's epilogue adds into (one
  // contribution a row) and gru's g_h z, past the partial tile: in
  // flight while the partials are stored and the cluster meets.
  const int rows = BM / s, r0 = rank * rows;
  float* side = smem + C::P_B;
  {
    constexpr int BN = C::BN, SB = C::SIDE_B;
    if (a.single) {
#pragma unroll
      for (int k = 0; k < C::NDB; ++k) {
        if (KIND != TREEFC && k >= a.A) break;
        stage<C::NTB, BN, SB>(side + k * BN, rows, ncols - n0, wide, a.g,
                      [&](int r, int cc) -> const float* {
                        int kk = k, col = n0 + cc;
                        if (KIND == TREEFC) {      // column n: child n / H
                          kk = col / H;
                          col -= kk * H;
                        } else {
                          col += (C::SW - 1) * H;  // the h half
                        }
                        const int id = cid_s[kk][r0 + r];
                        return id >= 0 ? a.g + (size_t)id * a.g_stride + col
                                       : nullptr;
                      });
      }
    }
    if (KIND == GRU)
      stage<C::NTB, BN, SB>(side + C::NDB * BN, rows, ncols - n0, wide, a.ws,
                    [&](int r, int cc) -> const float* {
                      return m0 + r0 + r < a.live
                          ? ws.c + (size_t)(m0 + r0 + r) * H + n0 + cc
                          : nullptr;
                    });
    cp_commit();
  }

  float* P = smem;                       // [plane][row][BN]
#pragma unroll
  for (int p = 0; p < C::NPL; ++p)
#pragma unroll
    for (int mb = 0; mb < C::MBB; ++mb)
#pragma unroll
      for (int nb = 0; nb < C::NB; ++nb) {
        const int row = p * BM + rw0 + 16 * mb + gq;
        const int col = nw0 + 8 * nb + 2 * t;
        *reinterpret_cast<float2*>(P + row * C::LDPB + col) =
            make_float2(acc[p][mb][nb][0], acc[p][mb][nb][1]);
        *reinterpret_cast<float2*>(P + (row + 8) * C::LDPB + col) =
            make_float2(acc[p][mb][nb][2], acc[p][mb][nb][3]);
      }
  cluster.sync();
  cp_wait<0>();                          // the side rows have landed
  __syncthreads();

  uint32_t pb[MAX_SPLIT];
  rank_bases(P, s, pb);
  auto reduce = [&](int plane, int row, int nn) {
    return rank_sum(pb, 4 * ((plane * BM + row) * C::LDPB + nn), s);
  };
  for (int i = tid; i < rows * C::BN; i += C::NTB) {
    const int rr = i / C::BN, nn = i % C::BN;
    const int row = r0 + rr, gm = m0 + row, n = n0 + nn;
    if (gm >= a.live || n >= ncols) continue;
    const float* old = side + rr * C::SIDE_B + nn;  // destination k's g
    if constexpr (KIND == TREELSTM) {
      const float shared = reduce(0, row, nn);
#pragma unroll
      for (int k = 0; k < TA; ++k) {
        const int r = cid_s[k][row];
        if (r < 0) continue;
        const float v = shared + reduce(1 + k, row, nn);
        if (a.single) a.g[(size_t)r * a.g_stride + H + n] = old[k * C::BN] + v;
        else ws.c[((size_t)gm * TA + k) * 2 * H + H + n] = v;
      }
    } else if constexpr (KIND == TREEFC) {
      const int k = n / H, col = n - k * H;
      const int r = cid_s[k][row];
      if (r < 0) continue;
      const float v = reduce(0, row, nn);
      if (a.single) a.g[(size_t)r * a.g_stride + col] = old[0] + v;
      else ws.c[((size_t)gm * a.A + k) * H + col] = v;
    } else {
      float v = reduce(0, row, nn);
      if (KIND == GRU) v = old[C::NDB * C::BN] + v;   // g_h z + d_rec W_h^T
      if (a.single) {
        for (int k = 0; k < a.A; ++k)
          if (cid_s[k][row] >= 0)
            a.g[(size_t)cid_s[k][row] * a.g_stride + (C::SW - 1) * H + n] =
                old[k * C::BN] + v;
      } else {
        ws.c[(size_t)gm * C::SW * H + (C::SW - 1) * H + n] = v;
      }
    }
  }
  cluster.sync();
}

// Pass (c): one CTA a destination run with several contributions, seeded
// from g, its contributions added in sorted order, written once.
// Contribution j is row sort_perm[j] / row_div of `contrib` (S floats a
// row): row_div A for lstm and gru, whose children share their slot's row.
__global__ void __launch_bounds__(NT_RUN)
k2_runs_kernel(float* __restrict__ g, long long g_stride,
               const float* __restrict__ contrib, int S, int row_div,
               const int* __restrict__ sort_perm,
               const int* __restrict__ scid, const int* __restrict__ heads) {
  const int lo = heads[blockIdx.x], hi = heads[blockIdx.x + 1];
  float* out = g + (size_t)scid[lo] * g_stride;
  for (int col = threadIdx.x; col < S; col += NT_RUN) {
    float acc = out[col];
    for (int j = lo; j < hi; ++j)
      acc += contrib[(size_t)(sort_perm[j] / row_div) * S + col];
    out[col] = acc;
  }
}

template <int KIND, int TA>
int launch(const Args& a, cudaStream_t stream, int* launches) {
  using C = Cfg<KIND, TA>;
  // The shared-memory opt-in is set once a device (it is per device).
  constexpr int MAX_DEVICES = 64;
  static bool ready[MAX_DEVICES] = {};
  auto ka = k2_gates_kernel<KIND, TA>;
  auto kb = k2_hgrad_kernel<KIND, TA>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES || !ready[dev]) {
    e = cudaFuncSetAttribute(
        ka, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_A);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kb, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_B);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 0 && dev < MAX_DEVICES) ready[dev] = true;
  }
  const int nm = (a.live + BM - 1) / BM;
  const int ncols = KIND == TREEFC ? a.A * a.H : a.H;
  e = launch_cluster(
      ka, dim3((a.H + C::BJ - 1) / C::BJ * a.split_a, nm), C::NTA,
      a.split_a, C::SMEM_A, a, stream);
  if (e != cudaSuccess) return (int)e;
  ++*launches;
  e = launch_cluster(kb, dim3((ncols + C::BN - 1) / C::BN * a.split_b, nm),
                     C::NTB, a.split_b, C::SMEM_B, a, stream);
  if (e != cudaSuccess) return (int)e;
  ++*launches;
  if (!a.single && a.nruns > 0) {
    const int row_div = (KIND == LSTM || KIND == GRU) ? a.A : 1;
    k2_runs_kernel<<<a.nruns, NT_RUN, 0, stream>>>(
        a.g, a.g_stride, workspace<KIND>(a).c, C::SW * a.H, row_div,
        a.sort_perm, a.scid, a.heads);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launches;
  }
  return 0;
}

template <int KIND>
int entry(void* g, const void* buf, const void* child_ids,
          const void* ext_ids, const void* node_mask, const void* ext,
          const void* w, const void* bias, const void* sort_perm,
          const void* sorted_child_ids, const void* heads, void* ws, int M,
          int A, int H, int offset, int sentinel, int g_stride,
          int buf_stride, int ext_stride, int live, int single, int nruns,
          int split_a, int split_b, void* launches, void* stream) {
  int* nl = static_cast<int*>(launches);
  *nl = 0;
  auto pow2 = [](int s) { return s == 1 || s == 2 || s == 4 || s == 8; };
  if (M <= 0 || H <= 0 || live <= 0) return 0;
  if (A < 1 || A > MAX_A || live > M || !pow2(split_a) || !pow2(split_b) ||
      (live + BM - 1) / BM > 65535 || (!single && nruns > 0 && !heads))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.g = static_cast<float*>(g);
  a.buf = static_cast<const float*>(buf);
  a.cid = static_cast<const int*>(child_ids);
  a.eid = static_cast<const int*>(ext_ids);
  a.nm = static_cast<const float*>(node_mask);
  a.ext = static_cast<const float*>(ext);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.sort_perm = static_cast<const int*>(sort_perm);
  a.scid = static_cast<const int*>(sorted_child_ids);
  a.heads = static_cast<const int*>(heads);
  a.ws = static_cast<float*>(ws);
  a.M = M; a.A = A; a.H = H; a.offset = offset; a.sentinel = sentinel;
  a.live = live; a.single = single; a.nruns = nruns;
  a.split_a = split_a; a.split_b = split_b;
  a.g_stride = g_stride; a.buf_stride = buf_stride;
  a.ext_stride = ext_stride;
  // 16-byte copies need 16-byte aligned rows: H, the strides and the
  // bases of what is staged (buf, g, ext, w, bias, the workspace) a
  // multiple of 16 B.
  a.wide = H % 4 == 0 && buf_stride % 4 == 0 && g_stride % 4 == 0 &&
           ext_stride % 4 == 0 && aligned16(buf) && aligned16(g) &&
           aligned16(ext) && aligned16(w) && aligned16(bias) &&
           aligned16(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KIND != TREELSTM) return launch<KIND, 1>(a, s, nl);
  switch (A) {
    case 1: return launch<TREELSTM, 1>(a, s, nl);
    case 2: return launch<TREELSTM, 2>(a, s, nl);
    case 3: return launch<TREELSTM, 3>(a, s, nl);
    default: return launch<TREELSTM, 4>(a, s, nl);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes), one per kind.  Every pointer
// but `launches` is a device pointer; `launches` is a host int that gets
// the number of CUDA launches made (2 a level, 3 with several
// contributions to a row, 0 for a level with no live slot); `stream` is a
// cudaStream_t.  `ws`: the workspace of `workspace_numel` floats.
// `live`: slots [0, live) are computed.  `single`: every destination row
// of the level receives one contribution; else `heads` holds the `nruns`
// + 1 sorted positions that start each destination run other than the
// sentinel's, then the end of the last.  `split_a`, `split_b`: CTAs a
// cluster splitting each pass's depth (1, 2, 4 or 8).  Each returns the
// cudaError_t of its launches (0 on success); cudaErrorInvalidValue for
// arguments the kernels do not take.
#define K2_ENTRY(NAME, KIND)                                                   \
  extern "C" int NAME(void* g, const void* buf, const void* child_ids,        \
                      const void* ext_ids, const void* node_mask,             \
                      const void* ext, const void* w, const void* bias,       \
                      const void* sort_perm, const void* sorted_child_ids,    \
                      const void* heads, void* ws, int M, int A, int H,       \
                      int offset, int sentinel, int g_stride, int buf_stride, \
                      int ext_stride, int live, int single, int nruns,        \
                      int split_a, int split_b, void* launches,               \
                      void* stream) {                                         \
    return entry<KIND>(g, buf, child_ids, ext_ids, node_mask, ext, w, bias,   \
                       sort_perm, sorted_child_ids, heads, ws, M, A, H,       \
                       offset, sentinel, g_stride, buf_stride, ext_stride,    \
                       live, single, nruns, split_a, split_b, launches,       \
                       stream);                                               \
  }

K2_ENTRY(treelstm_bwd_megastep_launch, TREELSTM)
K2_ENTRY(lstm_bwd_megastep_launch, LSTM)
K2_ENTRY(gru_bwd_megastep_launch, GRU)
K2_ENTRY(treefc_bwd_megastep_launch, TREEFC)

// Dynamic shared memory a CTA of each pass, for kind `kind` (0 treelstm,
// 1 lstm, 2 gru, 3 treefc) at arity A (for the report).
extern "C" int bwd_megastep_smem_bytes(int kind, int A, int pass) {
  switch (kind) {
    case TREELSTM:
      switch (A) {
        case 1: return pass ? Cfg<TREELSTM, 1>::SMEM_B : Cfg<TREELSTM, 1>::SMEM_A;
        case 2: return pass ? Cfg<TREELSTM, 2>::SMEM_B : Cfg<TREELSTM, 2>::SMEM_A;
        case 3: return pass ? Cfg<TREELSTM, 3>::SMEM_B : Cfg<TREELSTM, 3>::SMEM_A;
        default: return pass ? Cfg<TREELSTM, 4>::SMEM_B : Cfg<TREELSTM, 4>::SMEM_A;
      }
    case LSTM: return pass ? Cfg<LSTM, 1>::SMEM_B : Cfg<LSTM, 1>::SMEM_A;
    case GRU: return pass ? Cfg<GRU, 1>::SMEM_B : Cfg<GRU, 1>::SMEM_A;
    default: return pass ? Cfg<TREEFC, 1>::SMEM_B : Cfg<TREEFC, 1>::SMEM_A;
  }
}
