// The backward of blocked online-softmax attention (K10's backward) for
// Hopper (sm_90a): dQ, dK and dV of flash_attention_tf32.cu's forward,
// every product on the TF32 tensor cores by `mma.sync` with each f32
// product split into three TF32 products (3xTF32), fp32 accumulation.
//
// The TPU kernel this pairs with is src/repro/kernels/flash_attention.py:
//   K10 `flash_attention` (:88, its pallas_call at :109),
// which has no VJP: the reference never differentiates it.  This kernel
// replaces no TPU kernel; it was added so that an LM trains on the card
// with K10 in its attention layers.  It computes what
// src/repro_torch/kernels/ref.py `mha_bwd` computes:
//
//   q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] (G = Hq / Hkv), dO
//   [B, Hq, Sq, D], lse [B, Hq, Sq] (the forward's row log-sum-exp) ->
//   S = scale Q K^T, masked;  E = exp(S - lse);  P = E / rowsum(E);
//   dP = dO V^T;  Delta = rowsum(P o dP);  dS = P o (dP - Delta);
//   dQ = scale dS K;  dK = scale dSᵀ Q;  dV = Pᵀ dO,
//
// dK and dV summed over the G query heads of each KV head (GQA, no copy of
// K or V).  The mask is the forward's: query i sits at key position
// p = i + Sk - Sq; key j is valid for it where j < Sk, j <= p under
// `causal` and j > p - window under a window (`window` > 0).  A row with
// no valid key (lse = -inf) contributes nothing.  q, k, v and dO are read
// through their batch, head and row strides (unit stride along D); lse is
// the forward's contiguous output; dQ, dK and dV are written contiguous.
// Float32 operands only (the bf16 wgmma forward saves no log-sum-exp).
//
// Delta and the row sum.  The usual flash backward takes Delta =
// rowsum(dO o O) from the forward's output and P = exp(S - lse) as it
// stands.  Then a row of dS sums to the forward's rounding instead of to
// zero, and dQ = scale dS K and dK pick that up times the component the
// keys (queries) share.  On the 480 calls of examples/torch_train_lm.py's
// 30 trained steps (tools/k10b_precision.py, an H100) that formulation,
// with this kernel's 3xTF32 products, lands up to 3.0e-4 of max |grad|
// from an f64 evaluation, where autograd of the plain version at f32 is
// 2.2e-5 from it.  So this backward normalises P by its own row sum and
// takes Delta from its own P and dP, as autograd of a softmax does: a row
// of dS then sums to zero up to one rounding, and the kernel lands within
// 2.9e-5.  That costs one more pass of S and dP over the keys.
//
// Two launches, no float atomics, every sum in a fixed order (two runs
// are bitwise equal):
//   1. dq_kernel: a CTA owns (b, query head, a tile of BR queries), its
//      warps 16 queries each, and walks twice over the key tiles its
//      queries can see (as the forward does), K and V streaming through a
//      two-stage cp.async ring (the next tile's copies in flight during
//      this one's products).  Pass 1 recomputes S = Q K^T and dP = dO V^T
//      and sums, for each row, E and E o dP; it stores the row's 1 /
//      rowsum(E) and Delta to f32 [B, Hq, Sq] scratch.  Pass 2 recomputes
//      S and dP, forms P and dS in registers and adds dS K to dQ, held in
//      registers;
//   2. dkdv_kernel (after 1, which it reads): a CTA owns (b, KV head, a
//      tile of BR keys), its warps 16 keys each.  It walks over the G query
//      heads of its KV head and, for each, over the query rows that can see
//      one of its keys, BQ = BR / 2 rows a step, Q and dO streaming through
//      a two-stage cp.async ring.  A step recomputes S^T = K Q^T and
//      dP^T = V dO^T for its keys, forms P^T and dS^T in registers, and
//      adds P^T dO to dV and dS^T Q to dK, both in shared memory, each
//      element owned by one thread.
//   So S and dP are recomputed three times: nine products a pair of query
//   and key against the five the gradients need.
//
// Precision.  The products run as flash_attention_tf32.cu's do: each f32
// operand x is split in registers into x_big = tf32(x) and x_small =
// tf32(x - x_big), and a.b runs as a_small.b_big + a_big.b_small +
// a_big.b_big into fp32, about 21 bits of each operand, big.big and the
// cross terms in two accumulators.  The tensor core's fp32 accumulation
// truncates, so no sum is carried in an mma accumulator across tiles: each
// tile's product goes into a fresh pair of accumulators, added to the
// running dQ (registers) or dK, dV (shared memory) by an fp32 add, which
// rounds.
// E is recomputed from the f32 log-sum-exp as exp2(S scale log2(e) -
// lse log2(e)); the row sums of pass 1 are fp32 fmas in a fixed order.
//
// Fragments (per warp, g = lane / 4, t = lane % 4): A of m16n8k8 holds
// (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k, n) holds
// (t, g), (t + 4, g); the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).  dS (kernel 1), P^T and dS^T (kernel 2) are in the
// accumulator's layout, and are the A operands of the next products.  So
// each 8-wide block of their k index is read permuted, as the forward's
// PV reads P: A's column t is k = 2t and column t + 4 is k = 2t + 1, and
// B's rows are read in the same order.  P never leaves registers.
//
// Tiles.  BR = 64 rows a tile up to a head dim of 128 (four warps), 32 at
// 256 (two), the head dim in the class DMAX of 32, 64, 128 or 256 at or
// above it.  Staged rows hold DMAX + 4 floats (4 mod 32: the fragment
// reads of a warp hit 32 distinct banks), a head dim that is no multiple
// of 8 zero-filled to the end of its last 8-column block, rows past Sq or
// Sk zero-filled.  A head dim equal to its class (granite's 128, the LM
// example's 64) runs instantiations whose loops over the head dim have a
// constant length and no predicate, which ptxas schedules across
// iterations.  Staging is by 16-byte cp.async copies where D, the strides
// and the bases are multiples of 4 floats, else by plain loads.
// Both kernels hold 204 KB of shared memory at DMAX 128 (dq_kernel: Q, dO
// and two stages of K and V; dkdv_kernel: K, V, dK, dV and two stages of
// BQ-row Q and dO): one CTA, four warps, an SM, so a warp's products wait
// on their own latencies; more warps an SM, or wgmma, is a redesign's
// (ROADMAP.md queue 2).
//
// Bound on an H100 SXM (700 W): five products of 2 D FLOPs a head for each
// pair of a query and a key it sees, each f32 product as the three TF32
// products at 495 TFLOP/s, against q, k, v, o and dO read and dQ, dK and
// dV written once at 3.35 TB/s (o as the function's input, though this
// kernel does not read it).  granite-3-8b's training shape (B 2, Hq
// 32, Hkv 8, 1,024 causal tokens, D 128) is 42.9 GFLOP, 0.26 ms, bound by
// operations.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <int DMAX>
struct Cfg {
  static constexpr int BR = DMAX <= 128 ? 64 : 32;  // rows a CTA owns
  static constexpr int BQ = BR / 2;                 // query rows a dK/dV step
  static constexpr int NW = BR / 16;                // warps, 16 rows each
  static constexpr int NT = 32 * NW;                // threads a CTA
  static constexpr int LD = DMAX + 4;               // floats a staged row
  static constexpr int TILE = BR * LD;              // floats a BR-row tile
  static constexpr int QT = BQ * LD;                // floats a BQ-row tile
  static constexpr int NDB = DMAX / 8;              // 8-column blocks
  // dq_kernel: Q, dO, two stages of K and V; its rows' lse, 1 / rowsum(E)
  // and Delta.
  static constexpr int Q_BYTES = 4 * (6 * TILE + 3 * BR);
  // dkdv_kernel: K, V, dK, dV; two stages of Q, dO and their rows' lse,
  // 1 / rowsum(E) and Delta.
  static constexpr int KV_BYTES = 4 * (4 * TILE + 2 * (2 * QT + 3 * BQ));
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* lse;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  float* rsum;                       // [B, Hq, Sq] 1 / rowsum(E)
  float* delta;                      // [B, Hq, Sq] Delta
  int B, Hq, Hkv, Sq, Sk, D;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, dsb, dsh, dss;
  float scale, scale_log2;
  int causal, window;
  int vec4;                          // D, strides and bases allow 16 bytes
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 16-byte copy into shared memory; `in` false zero-fills.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small as TF32 operands (flash_attention_tf32.cu `split`).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// c += a b: a 16x8 TF32 (row), b 8x8 TF32 (col), c 16x8 fp32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [0, rows) of a [.., D] operand (row stride `rs` floats) into `dst`
// (LD floats a row), columns [0, DP) with DP = D rounded up to a multiple
// of 8: rows at and past `nvalid` and columns at and past D zero-filled.
// `vec4` (D, the strides and the bases multiples of 4 floats): by
// cp.async, 16 bytes a copy, in the caller's group; else by plain loads
// and stores, visible after the caller's next barrier.
template <int DMAX>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long rs, int rows, int nvalid,
                                      int D, bool vec4) {
  constexpr int LD = Cfg<DMAX>::LD, NT = Cfg<DMAX>::NT;
  const int DP = (D + 7) & ~7;
  if (vec4) {
    constexpr int C4 = DMAX / 4;     // 16-byte copies a row slot
    const uint32_t base = smem_addr(dst);
    for (int i = threadIdx.x; i < rows * C4; i += NT) {
      const int r = i / C4, c = 4 * (i % C4);
      if (c < DP) {
        const bool in = r < nvalid && c < D;
        cp16(base + 4 * (r * LD + c), src + (in ? r * rs + c : 0), in);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * DMAX; i += NT) {
    const int r = i / DMAX, c = i % DMAX;
    if (c < DP)
      dst[r * LD + c] = r < nvalid && c < D ? src[r * rs + c] : 0.f;
  }
}

// C = A B^T over the head dim for a warp's 16 rows: A's rows at `a`, B's
// 8 NB rows at `b` (both staged, LD floats a row), `nd` k-steps of 8
// columns.  big.big products in cb, the cross terms in cx.
template <int DMAX, int NB>
__device__ __forceinline__ void rows_dot(float (&cb)[NB][4],
                                         float (&cx)[NB][4], const float* a,
                                         const float* b, int nd, int g,
                                         int t) {
  constexpr int LD = Cfg<DMAX>::LD;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) cb[j][x] = cx[j][x] = 0.f;
#pragma unroll 4
  for (int kd = 0; kd < nd; ++kd) {
    const float* ap = a + g * LD + 8 * kd + t;
    uint32_t ag[4], as[4];
    split(ap[0], ag[0], as[0]);
    split(ap[8 * LD], ag[1], as[1]);
    split(ap[4], ag[2], as[2]);
    split(ap[8 * LD + 4], ag[3], as[3]);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float* bp = b + (8 * j + g) * LD + 8 * kd + t;
      uint32_t b0g, b0s, b1g, b1s;
      split(bp[0], b0g, b0s);
      split(bp[4], b1g, b1s);
      mma(cx[j], as, b0g, b1g);
      mma(cx[j], ag, b0s, b1s);
      mma(cb[j], ag, b0g, b1g);
    }
  }
}

// The tile product sum_k p[m][k] b[k][d] for a warp's 16 rows m and the
// column blocks [c0, c0 + CH) below nd: p a 16 x (8 NB) tile in the
// accumulator's layout, b's 8 NB rows staged (LD floats a row).  Each
// 8-wide block of k is read permuted (A's column t is k = 2t, t + 4 is
// 2t + 1; b's rows 2t, 2t + 1), so p is the A operand as it stands.
// Fresh accumulators: big.big in ob, the cross terms in ox.
template <int DMAX, int NB, int CH>
__device__ __forceinline__ void pv_chunk(float (&ob)[CH][4],
                                         float (&ox)[CH][4],
                                         const float (&p)[NB][4],
                                         const float* b, int c0, int nd,
                                         int g, int t) {
  constexpr int LD = Cfg<DMAX>::LD;
#pragma unroll
  for (int n = 0; n < CH; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) ob[n][x] = ox[n][x] = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    uint32_t pg[4], ps[4];
    split(p[j][0], pg[0], ps[0]);
    split(p[j][2], pg[1], ps[1]);
    split(p[j][1], pg[2], ps[2]);
    split(p[j][3], pg[3], ps[3]);
    const float* b0 = b + (8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      if (c0 + n < nd) {
        uint32_t b0g, b0s, b1g, b1s;
        split(b0[8 * (c0 + n)], b0g, b0s);
        split(b0[LD + 8 * (c0 + n)], b1g, b1s);
        mma(ox[n], ps, b0g, b1g);
        mma(ox[n], pg, b0s, b1s);
        mma(ob[n], pg, b0g, b1g);
      }
    }
  }
}

// acc += p b (pv_chunk) with acc the warp's 16 rows in shared memory (LD
// floats a row), added by fp32 adds; each element is this thread's alone.
template <int DMAX, int NB>
__device__ __forceinline__ void acc_pv(float* acc, const float (&p)[NB][4],
                                       const float* b, int nd, int g,
                                       int t) {
  constexpr int LD = Cfg<DMAX>::LD, NDB = Cfg<DMAX>::NDB;
  constexpr int CH = NDB < 8 ? NDB : 8;
#pragma unroll
  for (int c0 = 0; c0 < NDB; c0 += CH) {
    if (c0 >= nd) break;
    float ob[CH][4], ox[CH][4];
    pv_chunk<DMAX, NB, CH>(ob, ox, p, b, c0, nd, g, t);
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      if (c0 + n < nd) {
        float* r = acc + g * LD + 8 * (c0 + n) + 2 * t;
        r[0] += ob[n][0] + ox[n][0];
        r[1] += ob[n][1] + ox[n][1];
        r[8 * LD] += ob[n][2] + ox[n][2];
        r[8 * LD + 1] += ob[n][3] + ox[n][3];
      }
    }
  }
}

// acc += p b (pv_chunk) with acc in registers, the accumulator's layout
// over the head dim's column blocks.
template <int DMAX, int NB>
__device__ __forceinline__ void acc_pv_reg(float (&acc)[Cfg<DMAX>::NDB][4],
                                           const float (&p)[NB][4],
                                           const float* b, int nd, int g,
                                           int t) {
  constexpr int NDB = Cfg<DMAX>::NDB, CH = 4;
#pragma unroll
  for (int c0 = 0; c0 < NDB; c0 += CH) {
    if (c0 >= nd) break;
    float ob[CH][4], ox[CH][4];
    pv_chunk<DMAX, NB, CH>(ob, ox, p, b, c0, nd, g, t);
#pragma unroll
    for (int n = 0; n < CH; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[c0 + n][x] += ob[n][x] + ox[n][x];
  }
}

__device__ __forceinline__ bool valid(const Args& a, int qi, int kj) {
  const int p = qi + a.Sk - a.Sq;
  return qi < a.Sq && kj < a.Sk && (!a.causal || kj <= p) &&
         (a.window <= 0 || kj > p - a.window);
}

// E = exp2(S scale log2(e) - lse log2(e)) of a valid pair, else 0 (S as
// big.big + cross terms; l2 the lse in the exp2 domain, -inf for a row with
// no valid key).
__device__ __forceinline__ float expd(const Args& a, float sb, float sx,
                                      float l2, int qi, int kj) {
  return valid(a, qi, kj) && l2 != -INFINITY
             ? exp2f((sb + sx) * a.scale_log2 - l2)
             : 0.f;
}

// 1. dQ of one (b, query head, query tile), and its rows' 1 / rowsum(E)
// and Delta for dkdv_kernel; the tiles with the most keys take the lowest
// block indices, as the forward's.  K and V stream through a two-stage
// cp.async ring, the next tile's copies in flight during this one's
// products; dQ stays in registers.
template <int DMAX, bool EXACT>
__global__ void __launch_bounds__(Cfg<DMAX>::NT) dq_kernel(const Args a) {
  using C = Cfg<DMAX>;
  constexpr int BR = C::BR, LD = C::LD, NB = BR / 8, NDB = C::NDB;
  extern __shared__ __align__(16) float sm[];
  float* const sQ = sm;
  float* const sdO = sQ + C::TILE;
  float* const sKV = sdO + C::TILE;  // [stage][K, V][BR][LD]
  float* const sL = sKV + 4 * C::TILE;
  float* const sR = sL + BR;
  float* const sDl = sR + BR;

  const int nqt = (a.Sq + BR - 1) / BR;
  const int h = blockIdx.x % a.Hq;
  const int b = (blockIdx.x / a.Hq) % a.B;
  const int q0 = (nqt - 1 - (int)(blockIdx.x / (a.Hq * a.B))) * BR;
  const int hk = h / (a.Hq / a.Hkv);
  const int D = EXACT ? DMAX : a.D;  // EXACT: D == DMAX, every block full
  const int nd = (D + 7) / 8;
  const bool v4 = a.vec4;
  // The keys any row of the tile can see: [kbeg, kend), in nt tiles.
  const int off = a.Sk - a.Sq;
  const int plo = q0 + off;
  const int phi = min(q0 + BR, a.Sq) - 1 + off;
  const int kend = a.causal ? min(a.Sk, phi + 1) : a.Sk;
  const int kfirst = (a.window > 0 ? max(0, plo - a.window + 1) : 0) / BR *
                     BR;
  const int nt = kend > kfirst ? (kend - kfirst + BR - 1) / BR : 0;

  const long long r0 = ((long long)b * a.Hq + h) * a.Sq + q0;
  const int nv = a.Sq - q0;
  stage<DMAX>(sQ, a.q + b * a.qsb + h * a.qsh + (long long)q0 * a.qss,
              a.qss, BR, nv, D, v4);
  stage<DMAX>(sdO, a.dout + b * a.dsb + h * a.dsh + (long long)q0 * a.dss,
              a.dss, BR, nv, D, v4);
  for (int r = threadIdx.x; r < BR; r += C::NT)
    sL[r] = r < nv ? a.lse[r0 + r] * LOG2E : -INFINITY;
  cp_commit();
  const float* const kb = a.k + b * a.ksb + hk * a.ksh;
  const float* const vb = a.v + b * a.vsb + hk * a.vsh;
  // Tile `it` of the two passes' 2 nt (pass 1 the first nt), into stage
  // it & 1; one group each, empty past the last.
  auto issue = [&](int it) {
    if (it < 2 * nt) {
      const int k0 = kfirst + (it % nt) * BR;
      float* dst = sKV + 2 * (it & 1) * C::TILE;
      stage<DMAX>(dst, kb + (long long)k0 * a.kss, a.kss, BR, a.Sk - k0,
                  D, v4);
      stage<DMAX>(dst + C::TILE, vb + (long long)k0 * a.vss, a.vss, BR,
                  a.Sk - k0, D, v4);
    }
    cp_commit();
  };
  issue(0);
  issue(1);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qw = 16 * warp;          // the warp's first query row
  float dq[NDB][4];
#pragma unroll
  for (int n = 0; n < NDB; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) dq[n][x] = 0.f;
  // Pass 1 sums, for this thread's columns, each of its two rows' E and
  // E o dP in order; `finish` adds them over the quad and keeps 1 /
  // rowsum(E) and Delta in shared memory and in the scratch dkdv_kernel
  // reads.
  float se[2] = {0.f, 0.f}, sd[2] = {0.f, 0.f};
  auto finish = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int w = 1; w <= 2; w <<= 1) {
        se[i] += __shfl_xor_sync(FULL, se[i], w);
        sd[i] += __shfl_xor_sync(FULL, sd[i], w);
      }
      const int r = qw + g + 8 * i;
      const float rs = se[i] > 0.f ? 1.f / se[i] : 0.f;
      if (t == 0) {
        sR[r] = rs;
        sDl[r] = sd[i] * rs;
        if (r < nv) {
          a.rsum[r0 + r] = rs;
          a.delta[r0 + r] = sd[i] * rs;
        }
      }
    }
  };
  if (nt == 0) finish();

  for (int it = 0; it < 2 * nt; ++it) {
    cp_wait<1>();                    // Q, dO and this tile
    __syncthreads();
    const float* kt = sKV + 2 * (it & 1) * C::TILE;
    const float* vt = kt + C::TILE;
    const int k0 = kfirst + (it % nt) * BR;
    // S = Q K^T, E; dP = dO V^T: rows the warp's queries, columns the
    // tile's keys.
    float sb[NB][4], sx[NB][4], p[NB][4];
    rows_dot<DMAX, NB>(sb, sx, sQ + qw * LD, kt, nd, g, t);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = qw + g + 8 * (x >> 1);       // query in the tile
        p[j][x] = expd(a, sb[j][x], sx[j][x], sL[r], q0 + r,
                       k0 + 8 * j + 2 * t + (x & 1));
      }
    rows_dot<DMAX, NB>(sb, sx, sdO + qw * LD, vt, nd, g, t);
    if (it < nt) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          se[x >> 1] += p[j][x];
          sd[x >> 1] = fmaf(p[j][x], sb[j][x] + sx[j][x], sd[x >> 1]);
        }
      if (it == nt - 1) finish();    // read by the warp's own lanes
    } else {
      // P = E / rowsum(E), dS = P o (dP - Delta), dQ += dS K.
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = qw + g + 8 * (x >> 1);
          p[j][x] *= sR[r];
          p[j][x] *= (sb[j][x] + sx[j][x]) - sDl[r];
        }
      acc_pv_reg<DMAX, NB>(dq, p, kt, nd, g, t);
    }
    __syncthreads();                 // every warp is done with the stage
    issue(it + 2);
  }
  cp_wait<0>();                      // no copy outlives the CTA

  float* const dqb = a.dq + r0 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + g + 8 * i;
    if (r >= nv) continue;
#pragma unroll
    for (int n = 0; n < NDB; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < D) dqb[(long long)r * D + c] = dq[n][2 * i] * a.scale;
      if (c + 1 < D)
        dqb[(long long)r * D + c + 1] = dq[n][2 * i + 1] * a.scale;
    }
  }
}

// 2. dK and dV of one (b, KV head, key tile): the G query heads' query
// tiles that can see a key of the tile, BQ rows at a time, stream through
// a two-stage cp.async ring (Q, dO; their rows' lse, 1 / rowsum(E) and
// Delta by plain loads); dK and dV stay in shared memory.
template <int DMAX, bool EXACT>
__global__ void __launch_bounds__(Cfg<DMAX>::NT)
    dkdv_kernel(const Args a) {
  using C = Cfg<DMAX>;
  constexpr int BR = C::BR, BQ = C::BQ, LD = C::LD, NB = BQ / 8;
  extern __shared__ __align__(16) float sm[];
  float* const sK = sm;
  float* const sV = sK + C::TILE;
  float* const sdK = sV + C::TILE;
  float* const sdV = sdK + C::TILE;
  float* const sQD = sdV + C::TILE;  // [stage][Q, dO][BQ][LD]
  float* const sRows = sQD + 4 * C::QT;  // [stage][lse, 1/rowsum, Delta][BQ]

  const int nkt = (a.Sk + BR - 1) / BR;
  const int kt = blockIdx.x % nkt;
  const int hk = (blockIdx.x / nkt) % a.Hkv;
  const int b = blockIdx.x / (nkt * a.Hkv);
  const int k0 = kt * BR;
  const int G = a.Hq / a.Hkv;
  const int off = a.Sk - a.Sq;
  const int D = EXACT ? DMAX : a.D;  // EXACT: D == DMAX, every block full
  const int nd = (D + 7) / 8;
  const bool v4 = a.vec4;
  // The queries that may see a key of the tile: [qlo, qhi), in nq tiles
  // of BQ a head.
  const int klast = min(k0 + BR, a.Sk) - 1;
  const int qfirst = (a.causal ? max(0, k0 - off) : 0) / BQ * BQ;
  const int qhi = a.window > 0 ? max(0, min(a.Sq, klast - off + a.window))
                               : a.Sq;
  const int nq = qhi > qfirst ? (qhi - qfirst + BQ - 1) / BQ : 0;

  stage<DMAX>(sK, a.k + b * a.ksb + hk * a.ksh + (long long)k0 * a.kss,
              a.kss, BR, a.Sk - k0, D, v4);
  stage<DMAX>(sV, a.v + b * a.vsb + hk * a.vsh + (long long)k0 * a.vss,
              a.vss, BR, a.Sk - k0, D, v4);
  for (int i = threadIdx.x; i < 2 * C::TILE; i += C::NT) sdK[i] = 0.f;
  cp_commit();
  // Step `it` of the G nq (head, query tile) steps into stage it & 1.
  auto issue = [&](int it) {
    if (it < G * nq) {
      const int h = hk * G + it / nq, q0 = qfirst + (it % nq) * BQ;
      const int nv = a.Sq - q0;
      float* dst = sQD + 2 * (it & 1) * C::QT;
      stage<DMAX>(dst, a.q + b * a.qsb + h * a.qsh + (long long)q0 * a.qss,
                  a.qss, BQ, nv, D, v4);
      stage<DMAX>(dst + C::QT,
                  a.dout + b * a.dsb + h * a.dsh + (long long)q0 * a.dss,
                  a.dss, BQ, nv, D, v4);
      float* rows = sRows + 3 * BQ * (it & 1);
      const long long r0 = ((long long)b * a.Hq + h) * a.Sq + q0;
      for (int r = threadIdx.x; r < BQ; r += C::NT) {
        rows[r] = r < nv ? a.lse[r0 + r] * LOG2E : -INFINITY;
        rows[BQ + r] = r < nv ? a.rsum[r0 + r] : 0.f;
        rows[2 * BQ + r] = r < nv ? a.delta[r0 + r] : 0.f;
      }
    }
    cp_commit();
  };
  issue(0);
  issue(1);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kw = 16 * warp;          // the warp's first key row
  for (int it = 0; it < G * nq; ++it) {
    cp_wait<1>();                    // K, V and this step's Q, dO
    __syncthreads();
    const float* qt = sQD + 2 * (it & 1) * C::QT;
    const float* dot = qt + C::QT;
    const float* rows = sRows + 3 * BQ * (it & 1);
    const int q0 = qfirst + (it % nq) * BQ;
    // S^T = K Q^T: rows the warp's keys, columns the step's queries; then
    // P^T = E^T / rowsum(E), dP^T = V dO^T, dS^T = P^T o (dP^T - Delta).
    float sb[NB][4], sx[NB][4], p[NB][4], ds[NB][4];
    rows_dot<DMAX, NB>(sb, sx, sK + kw * LD, qt, nd, g, t);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int c = 8 * j + 2 * t + (x & 1);     // query in the step
        p[j][x] = expd(a, sb[j][x], sx[j][x], rows[c], q0 + c,
                       k0 + kw + g + 8 * (x >> 1)) * rows[BQ + c];
      }
    rows_dot<DMAX, NB>(sb, sx, sV + kw * LD, dot, nd, g, t);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        ds[j][x] = p[j][x] * ((sb[j][x] + sx[j][x]) -
                              rows[2 * BQ + 8 * j + 2 * t + (x & 1)]);
    acc_pv<DMAX, NB>(sdV + kw * LD, p, dot, nd, g, t);   // dV += P^T dO
    acc_pv<DMAX, NB>(sdK + kw * LD, ds, qt, nd, g, t);   // dK += dS^T Q
    __syncthreads();                 // every warp is done with the stage
    issue(it + 2);
  }
  cp_wait<0>();
  __syncthreads();
  const long long r0 = ((long long)b * a.Hkv + hk) * a.Sk + k0;
  const int n = min(BR, a.Sk - k0) * D;
  for (int i = threadIdx.x; i < n; i += C::NT) {
    const int r = i / D, c = i - r * D;
    a.dk[r0 * D + i] = sdK[r * LD + c] * a.scale;
    a.dv[r0 * D + i] = sdV[r * LD + c];
  }
}

template <int DMAX, bool EXACT>
int launch_e(const Args& a, cudaStream_t s) {
  using C = Cfg<DMAX>;
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_kernel<DMAX, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::KV_BYTES);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dq_kernel<DMAX, EXACT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::Q_BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long g1 = (long long)a.B * a.Hq * ((a.Sq + C::BR - 1) / C::BR);
  const long long g2 = (long long)a.B * a.Hkv * ((a.Sk + C::BR - 1) / C::BR);
  if (g1 > 0x7fffffffLL || g2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  dq_kernel<DMAX, EXACT><<<(unsigned)g1, C::NT, C::Q_BYTES, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || g2 == 0) return (int)e;
  dkdv_kernel<DMAX, EXACT><<<(unsigned)g2, C::NT, C::KV_BYTES, s>>>(a);
  return (int)cudaGetLastError();
}

// A head dim equal to its class runs the kernels with every column block
// full, their loops over the head dim of a constant length.
template <int DMAX>
int launch_t(const Args& a, cudaStream_t s) {
  return a.D == DMAX ? launch_e<DMAX, true>(a, s)
                     : launch_e<DMAX, false>(a, s);
}

}  // namespace

// Strides in elements: q, k, v and dout (batch, head, row); unit stride
// along D.  lse [B, Hq, Sq] contiguous, as the forward wrote it; dq [B, Hq,
// Sq, D] and dk, dv [B, Hkv, Sk, D] contiguous outputs; rsum and delta f32
// [B, Hq, Sq] scratch.  `window` <= 0: no window.  Two launches on
// `stream`.  Returns 0 or a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* rsum,
    void* delta, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long dsb, long long dsh, long long dss, float scale,
    int causal, int window, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D < 1 || D > 256 || Sk < 0)
    return (int)cudaErrorInvalidValue;
  Args a = {static_cast<const float*>(q),
            static_cast<const float*>(k),
            static_cast<const float*>(v),
            static_cast<const float*>(lse),
            static_cast<const float*>(dout),
            static_cast<float*>(dq),
            static_cast<float*>(dk),
            static_cast<float*>(dv),
            static_cast<float*>(rsum),
            static_cast<float*>(delta),
            B, Hq, Hkv, Sq, Sk, D,
            qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, dsb, dsh, dss,
            scale, scale * LOG2E, causal, window, 0};
  // float4 staging where every row starts on 16 bytes.
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, dsb, dsh, dss};
  a.vec4 = D % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) |
                           reinterpret_cast<uintptr_t>(dout)) % 16) == 0;
  for (int i = 0; i < 12; ++i) a.vec4 = a.vec4 && st[i] % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_t<32>(a, s);
  if (D <= 64) return launch_t<64>(a, s);
  if (D <= 128) return launch_t<128>(a, s);
  return launch_t<256>(a, s);
}

// Dynamic shared memory of a dK/dV CTA (`which` 0) or a dQ CTA (1) at head
// dim D (for the report).
extern "C" int flash_attention_bwd_smem_bytes(int D, int which) {
  if (D <= 32) return which ? Cfg<32>::Q_BYTES : Cfg<32>::KV_BYTES;
  if (D <= 64) return which ? Cfg<64>::Q_BYTES : Cfg<64>::KV_BYTES;
  if (D <= 128) return which ? Cfg<128>::Q_BYTES : Cfg<128>::KV_BYTES;
  return which ? Cfg<256>::Q_BYTES : Cfg<256>::KV_BYTES;
}
