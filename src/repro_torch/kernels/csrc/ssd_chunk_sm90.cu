// Mamba-2 SSD intra-chunk scan for Hopper (sm_90a): the three products on
// the TF32 tensor cores by `mma.sync.m16n8k8`, each split into three TF32
// products (3xTF32), fp32 accumulation; f32 or bf16 inputs widened to f32,
// f32 outputs.
//
// Replaces the TPU kernel of src/repro/kernels/mamba_ssd.py:
//   K12 `ssd_chunk_scan` (:62, its pallas_call at :106, body
//   `_ssd_chunk_kernel` at :29-59).
// It computes what src/repro_torch/kernels/ref.py `ssd_chunk_diag`
// computes.  For each sequence b, chunk c of Q <= 128 positions and head h,
// with a = A[h], cs the inclusive cumsum of dt a over the chunk:
//
//   y_diag[i, p] = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x[j, p]
//   state[p, n]  = sum_j exp(cs_{Q-1} - cs_j) dt_j x[j, p] B[j, n]
//
// x [Bt, L, H, P], B/C [Bt, L, N] (one B/C group) and dt [Bt, L, H] are
// read through their strides (unit stride along P and N): on the model's
// path x, B and C are views into the conv output, never copied.  y_diag
// [Bt, L, H, P] and states [Bt, L/Q, H, P, N] are contiguous f32.  The
// cross-chunk recurrence stays in plain PyTorch beside the launch
// (ref.ssd_combine), as the reference keeps it in jnp.
//
// Bound on an H100 SXM (700 W).  Over the Q (Q + 1) / 2 causal pairs j <= i
// of a chunk: G = C B^T once a chunk (2 N a pair) and, a head, y_diag (2 P
// a pair) and the state (2 Q P N), each operation as the three TF32
// products that keep f32 accuracy on the tensor cores at 495 TFLOP/s,
// against x, B, C and dt read once and y_diag and the states written once
// at 3.35 TB/s.  At a 1,024-token prefill of mamba2-370m (Q 128, nc 8, H
// 32, P 64, N 128) that is 0.824 GFLOP: 0.0050 ms as three TF32 products
// (0.0123 ms at the 67 TFLOP/s fp32-FMA rate), against 26.3 MB: 0.0079 ms.
// So a launch is bound by its bytes.
//
// The attention shape.  y_diag = (C B^T o L) (dt x) is causal attention
// with C's rows as the queries, B's rows as the keys (one "KV head" that
// every head shares), the decay L[i, j] = exp(cs_i - cs_j) (at most 1 for
// A < 0) in softmax's place, so no running max and no rescale, and x as
// V, dt folded into the decay.  flash_attention_tf32.cu's structure
// carries over: S = C B^T by ldmatrix fragments, the factor applied on the
// accumulator in registers, S's fragment the A operand of the next product
// through the permuted 8-key block.
//
// Design, by what held the SIMT kernel (ssd_chunk.cu, PR 19) back:
//   1. The grid.  The host plans the launch (mamba_ssd.py `ssd_plan`,
//      from Bt, nc, Q, H, P and N) as units of one CTA of four warps:
//        - y units: R (1 or 2) row blocks of 16 rows of a (sequence,
//          chunk, group of HG heads); warp w takes row block w % R and,
//          of each key tile, the 8-key blocks w / R + (4 / R) m (m < R),
//          so a row block's keys are dealt to 4 / R warps;
//        - state units: an N-range of 8 ceil(ceil(N / 8) / NS) columns
//          of one (sequence, chunk, head), all of P.
//      NS grows until the grid holds 132 CTAs, where the units allow; HG
//      is 2 and R is 2 where the grid still holds two CTAs an SM with
//      them.  The last row blocks of every chunk (the most keys) take the
//      lowest block indices, the state units come last.  71-105 KB of
//      shared memory a CTA: two or three CTAs an SM.
//   2. A short chunk does only its own work.  Its y units span
//      ceil(Q / 16) blocks of 16 rows; rows and keys past Q are never read
//      (zero-filled in shared memory), a unit's key tiles stop at its last
//      row and a warp's blocks at its row block's last row.
//   3. Only the causal blocks.  S = C B^T is formed only over the 8-key
//      blocks at or left of a row block's diagonal.  With HG 2 one S
//      serves a pair of heads: kept in registers, the decay applied again
//      for each head.  Above the diagonal the factor is expf(-inf) = 0,
//      exactly: no exp of a positive argument is ever taken, and no inf
//      meets a zero.
//   4. The tensor cores.  Every operand x is split into x_big =
//      cvt.rna.tf32(x) and x_small = tf32(x - x_big) and each k-step of 8
//      runs as small.big + big.small + big.big into fp32
//      (gathered_product.cuh `split`, `mma`): about 21 bits of each
//      operand.  C, which every key block of its row block reads, is split
//      once into big and small parts in shared memory; B, x, the decayed
//      S and the state's x are split in registers.  S keeps its big.big
//      products and its cross terms apart (R 1: of the even and of the odd
//      k-steps too, four sums for one block; R 2: two sums a block).  Each
//      block's y product goes to a fresh accumulator added to the warp's
//      partial in fp32 (the tensor core's sums are cut, not rounded:
//      flash_attention_tf32.cu); a row block's partials are summed in warp
//      order through shared memory and stored as rows of 16 bytes.  The
//      state's product over the Q keys reads x through the same permuted
//      key order, scaled in registers by exp(cs_{Q-1} - cs_j) dt_j.
//   Staging: a y unit's C, then its B and x by key tiles of 32 in a
//   two-stage ring; a state unit's x and B over all the chunk's keys at
//   once; all by cp.async of 16 bytes a thread where the bases, strides, P
//   and N allow (4 bytes otherwise: on the model's path x, B and C are
//   strided views of one xBC tensor); bf16 inputs are widened as they are
//   stored.  Rows of 132 floats for C and B (4 mod 32: the ldmatrix rows
//   and the B-operand reads of keys 2t and 2t + 1 hit 32 banks), P_MAX + 4
//   for x.  The cumsum is a warp scan a head (four positions a lane in
//   order, lane totals by shuffles).
// One launch a call, no atomics, every sum in a fixed order: two launches
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "gathered_product.cuh"

namespace {

constexpr int SSD_NT = 128;   // threads a CTA: four warps
constexpr int QMAX = 128;     // largest chunk
constexpr int RB = 16;        // rows a y unit
constexpr int KT = 32;        // keys a staged tile: a block of 8 a warp
constexpr int NC = 128;       // columns of C and B staged (zeros past N)
constexpr int LDN = NC + 4;   // floats a staged C or B row
constexpr unsigned FULL_MASK = 0xffffffffu;

// Shared memory of a CTA at head-dim class PMAX with HG heads and R row
// blocks a y unit.
// A y unit uses [C | ring of two key tiles (B, then x of each head)], its
// partial sums then taking the ring's place; a state unit [x | B] over all
// the chunk's keys.  The head vectors (cs, dt, w) follow.
template <int PMAX, int HG, int R>
struct Lay {
  static constexpr int LDX = PMAX + 4;                 // an x row
  static constexpr int LDP = PMAX + 8;                 // a partial y row
  static constexpr int LDS = PMAX <= 32 ? LDN : 68;    // a state B row
  static constexpr int C_FLOATS = R * RB * LDN;
  static constexpr int B_FLOATS = KT * LDN;
  static constexpr int X_FLOATS = KT * LDX;            // a head
  static constexpr int STAGE = B_FLOATS + HG * X_FLOATS;
  static constexpr int Y_FLOATS = 2 * C_FLOATS + 2 * STAGE;
  static constexpr int RED_FLOATS = 4 * HG * RB * LDP;
  static constexpr int ST_FLOATS = QMAX * (LDX + LDS);
  static constexpr int REGION = Y_FLOATS > ST_FLOATS ? Y_FLOATS : ST_FLOATS;
  static constexpr int VEC = HG * QMAX;                // cs, dt, w
  static constexpr int BYTES = 4 * (REGION + 3 * VEC);
  static_assert(RED_FLOATS <= 2 * STAGE, "partials fit in the ring");
};

struct Args {
  float* y;
  float* st;
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  int Bt, L, H, P, N, Q, NS, wide;
  long long xsb, xsl, xsh, dsb, dsl, dsh, bsb, bsl, csb, csl;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Rows [0, rows) x columns [0, COLS) (a multiple of 4) of a tile into
// `dst` (LD floats a row): element (r, k) from src[r * rs + k] where r <
// vrows and k < vcols, else 0.  f32: cp.async, 16 bytes a copy where
// `wide` (vcols, rs and src then multiples of 4 floats), else 4; bf16:
// loads widened and stored.
template <typename T, int COLS, int LD>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           long long rs, int rows, int vrows,
                                           int vcols, bool wide) {
  if constexpr (std::is_same<T, float>::value) {
    const uint32_t base = smem_addr(dst);
    if (wide) {
      constexpr int CPR = COLS / 4;
      for (int i = threadIdx.x; i < rows * CPR; i += SSD_NT) {
        const int r = i / CPR, k = 4 * (i % CPR);
        const bool in = r < vrows && k < vcols;
        cp16(base + 4 * (r * LD + k), in ? src + r * rs + k : src, in);
      }
    } else {
      for (int i = threadIdx.x; i < rows * COLS; i += SSD_NT) {
        const int r = i / COLS, k = i % COLS;
        const bool in = r < vrows && k < vcols;
        cp4(base + 4 * (r * LD + k), in ? src + r * rs + k : src, in);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * COLS; i += SSD_NT) {
      const int r = i / COLS, k = i % COLS;
      dst[r * LD + k] = r < vrows && k < vcols ? widen(src[r * rs + k])
                                               : 0.0f;
    }
  }
}

// dt, the inclusive cumsum cs of dt a and the state's weight w = exp(cs_last
// - cs) dt of one head over the chunk, by one warp: lane l sums positions
// 4l..4l+3 in order, the lane totals are scanned by shuffles (Hillis-
// Steele), and each lane adds the total before it.  Past Q: dt 0, cs
// cs_{Q-1}, w 0.
__device__ __forceinline__ void head_vectors(const float* db, long long dsl,
                                             float a, int Q, float* cs,
                                             float* dts, float* w) {
  const int lane = threadIdx.x & 31;
  float d[4], part[4], run = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 4 * lane + e;
    d[e] = j < Q ? db[(long long)j * dsl] : 0.0f;
    run += d[e] * a;
    part[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += up;
  }
  float excl = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) excl = 0.0f;
  float c[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = excl + part[e];
  const int le = (Q - 1) & 3;
  const float mine = le == 0 ? c[0] : le == 1 ? c[1] : le == 2 ? c[2] : c[3];
  const float last = __shfl_sync(FULL_MASK, mine, (Q - 1) >> 2);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 4 * lane + e;
    cs[j] = c[e];
    dts[j] = d[e];
    w[j] = j < Q ? expf(last - c[e]) * d[e] : 0.0f;
  }
}

// Fragments (per warp, g = lane / 4, t = lane % 4): A of m16n8k8 holds
// (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k, n) holds
// (t, g), (t + 4, g); the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).  An S accumulator becomes an A operand with its 8 keys
// permuted: A's column t is key 2t and column t + 4 is key 2t + 1, and the
// B operand reads rows 2t and 2t + 1 in the same order.  The state's
// product takes its keys in that order too.

// A y unit: rows [r0, r0 + 16 R) of heads [h0, h0 + nh) of one
// (sequence, chunk).  Warp w takes row block w % R and, of each key tile,
// the 8-key blocks w / R + (4 / R) m (m < R) up to its last row: S = C
// B^T for the block, the decay, S x into its partial y; the 4 / R
// partials of a row block are summed in warp order at the end.
template <typename T, int PMAX, int HG, int R>
__device__ __forceinline__ void y_unit(const Args& a, float* smem, int b,
                                       int c, int h0, int nh, int r0) {
  using LY = Lay<PMAX, HG, R>;
  constexpr int LDX = LY::LDX, LDP = LY::LDP;
  constexpr int PB = PMAX / 8;          // 8-column blocks of x and y
  constexpr int KS = 4 / R;             // warps a row block
  float* const sC = smem;                        // C, then its big parts
  float* const sCm = smem + LY::C_FLOATS;        // C's small parts
  float* const sKV = smem + 2 * LY::C_FLOATS;    // [stage][B | x heads]
  float* const sCs = smem + LY::REGION;          // [HG][QMAX]
  float* const sDt = sCs + LY::VEC;
  float* const sW = sDt + LY::VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rbl = warp % R, kp = warp / R;       // row block, key lane
  const int Q = a.Q, P = a.P, N = a.N;
  const int c0 = c * Q;
  const bool wide = a.wide != 0;
  const int rows = min(RB * R, Q - r0);          // live rows
  const int kend = min(Q, r0 + rows);            // keys [0, kend)
  const int nkt = (kend + KT - 1) / KT;
  const int n16 = (N + 15) & ~15;                // C, B columns read

  const T* Bb = static_cast<const T*>(a.B) + b * a.bsb +
                (long long)c0 * a.bsl;
  const T* xb = static_cast<const T*>(a.x) + b * a.xsb +
                (long long)c0 * a.xsl;
  stage_tile<T, NC, LDN>(sC,
                         static_cast<const T*>(a.C) + b * a.csb +
                             (long long)(c0 + r0) * a.csl,
                         a.csl, RB * R, rows, N, wide);
  cp_commit();
  // Groups in order: C, then B and x of every key tile (empty past the
  // last), so that before tile `it` at most tile it + 1's is in flight.
  auto issue = [&](int it) {
    if (it < nkt) {
      const int k0 = it * KT;
      const int kv = min(KT, Q - k0);
      float* dst = sKV + (it & 1) * LY::STAGE;
      stage_tile<T, NC, LDN>(dst, Bb + (long long)k0 * a.bsl, a.bsl, KT, kv,
                             N, wide);
      for (int k = 0; k < nh; ++k)
        stage_tile<T, PMAX, LDX>(dst + LY::B_FLOATS + k * LY::X_FLOATS,
                                 xb + (long long)k0 * a.xsl +
                                     (long long)(h0 + k) * a.xsh,
                                 a.xsl, KT, kv, P, wide);
    }
    cp_commit();
  };
  issue(0);
  issue(1);
  if (warp < nh) {
    const int h = h0 + warp;
    head_vectors(a.dt + b * a.dsb + (long long)c0 * a.dsl + h * a.dsh,
                 a.dsl, a.A[h], Q, sCs + warp * QMAX, sDt + warp * QMAX,
                 sW + warp * QMAX);
  }

  // C is split once, in place: its big parts in sC, small parts in sCm
  // (a warp reads each of its C fragments once a key block).
  cp_wait<2>();                    // C has landed
  __syncthreads();
  for (int e = threadIdx.x; e < RB * R * NC; e += SSD_NT) {
    const int r = e / NC, k = e % NC;
    uint32_t big, small;
    split(sC[r * LDN + k], big, small);
    sC[r * LDN + k] = __uint_as_float(big);
    sCm[r * LDN + k] = __uint_as_float(small);
  }

  const int rw = r0 + RB * rbl;                  // the warp's first row
  const bool active = RB * rbl < rows;
  // 8-key blocks the warp's rows need: to its last row, within the chunk.
  const int nkb = active ? min((Q + 7) / 8, (rw + 15) / 8 + 1) : 0;
  const int i0 = rw + g, i1 = i0 + 8;
  // ldmatrix: C's rows (lane & 7) + 8 ((lane >> 3) & 1) at column
  // 4 (lane >> 4) give a0..a3; a block's keys (lane & 7) at column
  // 4 (lane >> 3) give b0, b1 of two k-steps.
  const uint32_t caddr =
      smem_addr(sC) + 4 * ((RB * rbl + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                           LDN + 4 * (lane >> 4));
  const uint32_t cmoff = 4 * LY::C_FLOATS;       // sCm - sC, in bytes
  const int boff = (lane & 7) * LDN + 4 * (lane >> 3);
  const int nk2 = n16 / 16;
  float yacc[HG][PB][4];
#pragma unroll
  for (int k = 0; k < HG; ++k)
#pragma unroll
    for (int n = 0; n < PB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[k][n][e] = 0.0f;

  for (int it = 0; it < nkt; ++it) {
    cp_wait<1>();                  // C and this tile have landed
    __syncthreads();
    const float* sB = sKV + (it & 1) * LY::STAGE;
    // The warp's blocks of the tile: slot m is tile block kp + KS m.
    const int kb0 = it * (KT / 8) + kp;
    const int nm = kb0 < nkb ? min(R, (nkb - kb0 + KS - 1) / KS) : 0;
    if (nm > 0) {
      // S over the blocks.  R 1: big.big and the cross terms of the even
      // and of the odd k-steps in four sums; R 2: the two sums a block.
      float sb[2][4], sx[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) sb[q][e] = sx[q][e] = 0.0f;
      const uint32_t baddr = smem_addr(sB) + 4 * (boff + 8 * kp * LDN);
#pragma unroll 2
      for (int k2 = 0; k2 < nk2; ++k2) {
        uint32_t bg[R][4], bs[R][4];
#pragma unroll
        for (int m = 0; m < R; ++m) {
          uint32_t br[4];
          ldsm_x4(baddr + 4 * 8 * KS * m * LDN + 64 * k2, br);
#pragma unroll
          for (int e = 0; e < 4; ++e) split(__uint_as_float(br[e]), bg[m][e],
                                            bs[m][e]);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t cg[4], cm[4];
          ldsm_x4(caddr + 64 * k2 + 32 * q, cg);
          ldsm_x4(caddr + cmoff + 64 * k2 + 32 * q, cm);
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const int sl = R == 1 ? q : m;
            mma(sx[sl], cm, bg[m][2 * q], bg[m][2 * q + 1]);
            mma(sx[sl], cg, bs[m][2 * q], bs[m][2 * q + 1]);
            mma(sb[sl], cg, bg[m][2 * q], bg[m][2 * q + 1]);
          }
        }
      }
      float S[R][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (R == 1) {
          S[0][e] = (sb[0][e] + sb[1][e]) + (sx[0][e] + sx[1][e]);
        } else {
#pragma unroll
          for (int m = 0; m < R; ++m) S[m][e] = sb[m][e] + sx[m][e];
        }
      }

      // Each block and head: M = S o exp(cs_i - cs_j) dt_j (0 above the
      // diagonal) as the A operand, times x into a fresh sum added to y.
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (m < nm) {
          const int kb = kb0 + KS * m;
          const int j0 = 8 * kb + 2 * t, j1 = j0 + 1;
#pragma unroll
          for (int k = 0; k < HG; ++k) {
            if (k < nh) {
              const float* cs = sCs + k * QMAX;
              const float* dts = sDt + k * QMAX;
              const float ci0 = cs[i0], ci1 = cs[i1];
              const float cj0 = cs[j0], cj1 = cs[j1];
              const float d0 = dts[j0], d1 = dts[j1];
              uint32_t pg[4], ps[4];
              split(S[m][0] * (expf(j0 <= i0 ? ci0 - cj0 : -INFINITY) * d0),
                    pg[0], ps[0]);
              split(S[m][2] * (expf(j0 <= i1 ? ci1 - cj0 : -INFINITY) * d0),
                    pg[1], ps[1]);
              split(S[m][1] * (expf(j1 <= i0 ? ci0 - cj1 : -INFINITY) * d1),
                    pg[2], ps[2]);
              split(S[m][3] * (expf(j1 <= i1 ? ci1 - cj1 : -INFINITY) * d1),
                    pg[3], ps[3]);
              const float* xr = sB + LY::B_FLOATS + k * LY::X_FLOATS +
                                (8 * (kp + KS * m) + 2 * t) * LDX + g;
#pragma unroll
              for (int n = 0; n < PB; ++n) {
                uint32_t b0g, b0s, b1g, b1s;
                split(xr[8 * n], b0g, b0s);
                split(xr[LDX + 8 * n], b1g, b1s);
                float tmp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma(tmp, ps, b0g, b1g);
                mma(tmp, pg, b0s, b1s);
                mma(tmp, pg, b0g, b1g);
#pragma unroll
                for (int e = 0; e < 4; ++e) yacc[k][n][e] += tmp[e];
              }
            }
          }
        }
      }
    }
    __syncthreads();               // every warp is done with the stage
    issue(it + 2);
  }
  cp_wait<0>();                    // no copy outlives the loop

  // The partials, summed in warp order into y's live rows.
  float* red = sKV;                              // [warp][head][RB][LDP]
#pragma unroll
  for (int k = 0; k < HG; ++k)
#pragma unroll
    for (int n = 0; n < PB; ++n) {
      float* p = red + ((warp * HG + k) * RB + g) * LDP + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(yacc[k][n][0],
                                                  yacc[k][n][1]);
      *reinterpret_cast<float2*>(p + 8 * LDP) =
          make_float2(yacc[k][n][2], yacc[k][n][3]);
    }
  __syncthreads();
  constexpr int P4 = PMAX / 4;
  for (int e = threadIdx.x; e < nh * RB * R * P4; e += SSD_NT) {
    const int q = 4 * (e % P4), r = (e / P4) % (RB * R);
    const int k = e / (RB * R * P4);
    if (q >= P || r >= rows) continue;
    const int wr = r / RB, rr = r % RB;          // row block, its row
    float4 v = *reinterpret_cast<const float4*>(
        red + ((wr * HG + k) * RB + rr) * LDP + q);
#pragma unroll
    for (int s = 1; s < KS; ++s) {
      const float4 o = *reinterpret_cast<const float4*>(
          red + (((wr + R * s) * HG + k) * RB + rr) * LDP + q);
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    float* yr = a.y + (((long long)b * a.L + c0 + r0 + r) * a.H + h0 + k) *
                          P + q;
    if ((P & 3) == 0) {
      *reinterpret_cast<float4*>(yr) = v;
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
      for (int m = 0; m < 4 && q + m < P; ++m) yr[m] = vv[m];
    }
  }
}

// A state unit: columns [n0, n0 + nw) of head h's state of one (sequence,
// chunk), every key at once: state[p, n] = sum_j (w_j x[j, p]) B[j, n].
// Warps as WP p-warps by WN n-warps; a warp's p-blocks of 16 are wp (and
// wp + 4 where P > 64), its 8-column blocks the unit's [8 wn, 8 wn + 8).
template <typename T, int PMAX, int HG, int R>
__device__ __forceinline__ void state_unit(const Args& a, float* smem, int b,
                                           int c, int h, int n0, int nw) {
  using LY = Lay<PMAX, HG, R>;
  constexpr int LDX = LY::LDX, LDS = LY::LDS;
  constexpr int PPW = PMAX > 64 ? 2 : 1;
  float* const sX = smem;                        // [QMAX][LDX]
  float* const sB = smem + QMAX * LDX;           // [QMAX][LDS]
  const float* const sW = smem + LY::REGION + 2 * LY::VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Q = a.Q, P = a.P, N = a.N;
  const int c0 = c * Q;
  const int nc = a.L / Q;
  const bool wide = a.wide != 0;
  const int q8 = (Q + 7) & ~7;                   // keys staged
  const int npb = (P + 15) / 16;
  const int WP = min(4, npb), WN = 4 / WP;
  const int wp = warp % WP, wn = warp / WP;

  stage_tile<T, PMAX, LDX>(sX,
                           static_cast<const T*>(a.x) + b * a.xsb +
                               (long long)c0 * a.xsl + (long long)h * a.xsh,
                           a.xsl, q8, Q, P, wide);
  stage_tile<T, LDS - 4, LDS>(sB,
                              static_cast<const T*>(a.B) + b * a.bsb +
                                  (long long)c0 * a.bsl + n0,
                              a.bsl, q8, Q, nw, wide);
  cp_commit();
  if (warp == 0)
    head_vectors(a.dt + b * a.dsb + (long long)c0 * a.dsl + h * a.dsh,
                 a.dsl, a.A[h], Q, smem + LY::REGION,
                 smem + LY::REGION + LY::VEC,
                 smem + LY::REGION + 2 * LY::VEC);
  cp_wait<0>();
  __syncthreads();

  // n-warp wn takes the unit's 8-column blocks [8 wn, 8 wn + 8) (the plan
  // keeps a unit within 8 WN blocks).  Its loop runs all 8 blocks (zeros
  // past the unit's columns), so it has no branch; only the stores stop
  // at the unit's last column.
  const int nbt = (nw + 7) / 8;
  const int nb0 = 8 * wn;
  const int nbn = wn < WN ? max(0, min(8, nbt - nb0)) : 0;
  if (nbn == 0) return;
  float acc[PPW][8][4];
#pragma unroll
  for (int q = 0; q < PPW; ++q)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][n][e] = 0.0f;
#pragma unroll 2
  for (int k0 = 0; k0 < q8; k0 += 8) {
    const int kr0 = k0 + 2 * t, kr1 = kr0 + 1;
    const float w0 = sW[kr0], w1 = sW[kr1];
    uint32_t ag[PPW][4], as[PPW][4];
#pragma unroll
    for (int q = 0; q < PPW; ++q) {
      const int p = 16 * (wp + 4 * q) + g;
      const float* x0 = sX + kr0 * LDX + p;
      const float v[4] = {x0[0] * w0, x0[8] * w0, x0[LDX] * w1,
                          x0[LDX + 8] * w1};
      split4(v, ag[q], as[q]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* br = sB + kr0 * LDS + 8 * (nb0 + n) + g;
      uint32_t b0g, b0s, b1g, b1s;
      split(br[0], b0g, b0s);
      split(br[LDS], b1g, b1s);
#pragma unroll
      for (int q = 0; q < PPW; ++q) {
        mma(acc[q][n], as[q], b0g, b1g);
        mma(acc[q][n], ag[q], b0s, b1s);
        mma(acc[q][n], ag[q], b0g, b1g);
      }
    }
  }

  float* sbase = a.st + (((long long)b * nc + c) * a.H + h) * P * N + n0;
#pragma unroll
  for (int q = 0; q < PPW; ++q) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = 16 * (wp + 4 * q) + g + 8 * hr;
      if (p >= P) continue;
      float* row = sbase + (long long)p * N;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n < nbn) {
          const int col = 8 * (nb0 + n) + 2 * t;
          const float v0 = acc[q][n][2 * hr], v1 = acc[q][n][2 * hr + 1];
          if ((N & 1) == 0 && col + 1 < nw) {
            *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
          } else {
            if (col < nw) row[col] = v0;
            if (col + 1 < nw) row[col + 1] = v1;
          }
        }
      }
    }
  }
}

// One CTA a unit: y units first, the last row blocks of every (sequence,
// chunk, head group) at the lowest block indices, then the state units.
template <typename T, int PMAX, int HG, int R>
__global__ void __launch_bounds__(SSD_NT, 2)
    ssd_chunk_sm90_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int Q = a.Q, nc = a.L / Q;
  const int ngr = (a.H + HG - 1) / HG;
  const int nry = (Q + RB * R - 1) / (RB * R);
  const long long per_ry = (long long)a.Bt * nc * ngr;
  long long u = blockIdx.x;
  if (u < per_ry * nry) {
    const int r0 = (nry - 1 - (int)(u / per_ry)) * RB * R;
    long long r = u % per_ry;
    const int h0 = (int)(r % ngr) * HG;
    r /= ngr;
    y_unit<T, PMAX, HG, R>(a, smem, (int)(r / nc), (int)(r % nc), h0,
                           min(HG, a.H - h0), r0);
  } else {
    u -= per_ry * nry;
    const int nb = (a.N + 7) / 8;
    const int nbu = (nb + a.NS - 1) / a.NS;      // 8-column blocks a unit
    const int s = (int)(u % a.NS);
    u /= a.NS;
    const int h = (int)(u % a.H);
    u /= a.H;
    const int n0 = 8 * nbu * s;
    state_unit<T, PMAX, HG, R>(a, smem, (int)(u / nc), (int)(u % nc), h, n0,
                            min(8 * nbu, a.N - n0));
  }
}

template <typename T, int PMAX, int HG, int R>
int launch_t(const Args& a, long long grid, cudaStream_t stream) {
  auto kern = ssd_chunk_sm90_kernel<T, PMAX, HG, R>;
  const int smem = Lay<PMAX, HG, R>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)grid, SSD_NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int PMAX, int HG>
int launch_r(const Args& a, int R, long long grid, cudaStream_t stream) {
  return R == 2 ? launch_t<T, PMAX, HG, 2>(a, grid, stream)
                : launch_t<T, PMAX, HG, 1>(a, grid, stream);
}

template <typename T>
int launch_p(const Args& a, int HG, int R, long long grid,
             cudaStream_t stream) {
  if (a.P <= 32)
    return HG == 2 ? launch_r<T, 32, 2>(a, R, grid, stream)
                   : launch_r<T, 32, 1>(a, R, grid, stream);
  if (a.P <= 64)
    return HG == 2 ? launch_r<T, 64, 2>(a, R, grid, stream)
                   : launch_r<T, 64, 1>(a, R, grid, stream);
  if (HG != 1) return (int)cudaErrorInvalidValue;
  return launch_r<T, 128, 1>(a, R, grid, stream);
}

// CTAs of a launch planned with HG heads and R row blocks a y unit and NS
// state units a (sequence, chunk, head).
long long grid_size(int Bt, int L, int H, int Q, int HG, int R, int NS) {
  const long long nc = L / Q;
  return (long long)Bt * nc *
         ((long long)((H + HG - 1) / HG) * ((Q + RB * R - 1) / (RB * R)) +
          (long long)H * NS);
}

}  // namespace

// Strides in elements: x (batch, position, head), dt (batch, position,
// head), B and C (batch, position); unit stride along P and N.  dt and A
// are f32; x, B and C f32 (bf16 = 0) or bf16 (bf16 = 1).  HG (1 or 2; 1
// where P > 64) heads share a y unit's S; NS state units cover a (sequence,
// chunk, head)'s N columns (1 <= NS <= ceil(N / 8), a unit's share of the
// 8-column blocks at most 8 a warp).  y_diag is a contiguous [Bt, L, H, P]
// and states a contiguous [Bt, L/Q, H, P, N] f32 tensor.  Returns the CUDA
// error of the launch (0: in the stream).
extern "C" int ssd_chunk_sm90_launch(
    void* y, void* states, const void* x, const void* dt, const void* A,
    const void* B, const void* C, int Bt, int L, int H, int P, int N, int Q,
    int HG, int NS, int R, long long xsb, long long xsl, long long xsh,
    long long dsb, long long dsl, long long dsh, long long bsb,
    long long bsl, long long csb, long long csl, int bf16, void* stream) {
  if (Bt <= 0 || L <= 0 || H <= 0) return 0;
  const int nb = (N + 7) / 8;
  if (Q < 1 || Q > QMAX || L % Q != 0 || P < 1 || P > 128 || N < 1 ||
      N > 128 || HG < 1 || HG > 2 || (HG == 2 && P > 64) || NS < 1 ||
      NS > nb || R < 1 || R > 2)
    return (int)cudaErrorInvalidValue;
  const int nbu = (nb + NS - 1) / NS;
  const int wn = 4 / min(4, (P + 15) / 16);
  if ((nbu + wn - 1) / wn > 8 || (NS - 1) * nbu >= nb)
    return (int)cudaErrorInvalidValue;
  const long long grid = grid_size(Bt, L, H, Q, HG, R, NS);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const long long s[10] = {xsb, xsl, xsh, dsb, dsl, dsh, bsb, bsl, csb, csl};
  // 16-byte copies need f32, 16-byte aligned bases, strides and widths.
  bool wide = !bf16 && P % 4 == 0 && N % 4 == 0 &&
              (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B)
               | reinterpret_cast<uintptr_t>(C)) % 16 == 0;
  for (int i = 0; i < 10; ++i)
    if (i < 3 || i > 5) wide = wide && s[i] % 4 == 0;   // not dt's
  const Args a = {static_cast<float*>(y), static_cast<float*>(states), x,
                  static_cast<const float*>(dt),
                  static_cast<const float*>(A), B, C, Bt, L, H, P, N, Q, NS,
                  (int)wide, xsb, xsl, xsh, dsb, dsl, dsh, bsb, bsl, csb,
                  csl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_p<__nv_bfloat16>(a, HG, R, grid, st);
  return launch_p<float>(a, HG, R, grid, st);
}

// Dynamic shared memory of one CTA at head dim P with HG heads and R row
// blocks a y unit (for the report).
extern "C" int ssd_chunk_sm90_smem_bytes(int P, int HG, int R) {
  if (P <= 32) {
    if (HG == 2) return R == 2 ? Lay<32, 2, 2>::BYTES : Lay<32, 2, 1>::BYTES;
    return R == 2 ? Lay<32, 1, 2>::BYTES : Lay<32, 1, 1>::BYTES;
  }
  if (P <= 64) {
    if (HG == 2) return R == 2 ? Lay<64, 2, 2>::BYTES : Lay<64, 2, 1>::BYTES;
    return R == 2 ? Lay<64, 1, 2>::BYTES : Lay<64, 1, 1>::BYTES;
  }
  return R == 2 ? Lay<128, 1, 2>::BYTES : Lay<128, 1, 1>::BYTES;
}
