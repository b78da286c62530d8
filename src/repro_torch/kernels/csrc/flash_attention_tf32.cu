// Blocked online-softmax attention (flash attention, forward) for Hopper
// (sm_90a): QK^T and PV on the TF32 tensor cores by `mma.sync`, fp32
// accumulation, K/V staged by `cp.async` through a two-stage ring; f32
// operands with each product split into three TF32 products (3xTF32), or
// bf16 operands, exact in TF32.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   K10 `flash_attention` (:88, its pallas_call at :109).
// It computes what src/repro_torch/kernels/ref.py `mha` computes:
//
//   q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] (Hq % Hkv == 0) -> o [B, Hq, Sq, D]
//   o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
//
// over the keys j valid for query i, which sits at key position
// p = i + Sk - Sq (the ends aligned): j < Sk, and j <= p under `causal`,
// and j > p - window under a window (`window` > 0).  G = Hq / Hkv folds each
// query head onto its KV head (GQA) with no copy of K or V.  The output is
// at the operands' type; a query with no valid key gets a zero row.  q, k
// and v are read through their batch, head and row strides (unit stride
// along D).  This is the route for f32 operands at every head dim 1..256
// and for bf16 operands at the head dims the wgmma kernel does not take
// (D % 16 != 0); bf16 with D % 16 == 0 takes flash_attention_sm90.cu
// (flash_attention.py `route`).
//
// The row log-sum-exp.  Given a non-null `lse` (f32 [B, Hq, Sq],
// contiguous), the kernel also stores each live row's log-sum-exp of its
// scaled scores, m + log(l) in the natural log (-inf for a row with no
// valid key): what the backward (flash_attention_bwd.cu) recomputes the
// probabilities from.  The autograd forward asks for it; serving passes
// null, and the output's arithmetic is the same either way.
//
// Any head dim.  mma.sync.m16n8k8 steps the head dim 8 columns at a time:
// a head dim D that is no multiple of 8 is staged through the end of its
// last 8-column block, the columns [D, 8 ceil(D / 8)) zero-filled (by
// cp.async with a source size of 0, as rows past Sq or Sk are, or by plain
// stores where a bf16 copy is narrower than 4 bytes), so they add exact
// zeros to QK^T and to PV; O's stores stop at column D.  D runs in the
// class DMAX of 32, 64, 128 or 256 at or above it (D 20 in class 32, its
// third block zero-padded from column 20 to 24).
//
// Precision.  The reference computes QK^T and PV in f32; a TF32 product
// keeps 11 bits of each operand.  Each f32 operand x is split in registers
// into x_big = cvt.rna.tf32(x) and x_small = cvt.rna.tf32(x - x_big) (the
// tensor core ignores the low 13 bits of an f32 operand, so the big part
// is rounded explicitly and the small part is the remainder of what the
// instruction uses), and a.b runs as a_small.b_big + a_big.b_small +
// a_big.b_big into fp32: about 21 bits of each operand.  Q, K and V are
// split as their fragments are loaded; P, the fp32 probabilities, where
// the score fragment becomes the A operand of PV.  QK^T keeps the
// big.big products and the two cross terms in two accumulators, added
// once per key tile (twice the independent chains of mma.sync).  The
// tensor core's fp32 accumulation is not IEEE: the sum is aligned to the
// largest addend and cut, not rounded.  Carried over a whole row in the
// mma's accumulator, O drifts toward zero: 1.3e-5 of max |O| on granite
// prefills of 1,024 tokens on the H100, above the f32 bar of 1e-5.  So
// each key tile's P V goes into a fresh accumulator and is added to O by
// an fp32 fma (O alpha + tile), which rounds: 1.9e-6 on the same launches.
// QK^T's sums span one tile and D / 8 steps, and keeping them in the mma
// costs nothing measurable there.
//
// bf16 operands.  A bf16 value is exact in TF32 (8 bits of mantissa
// against 10): its small part is zero.  So the bf16 rows are staged raw
// (cp.async cannot widen; copies of 16, 8 or 4 bytes as D, the strides
// and the bases allow, plain 2-byte loads and stores for an odd head dim
// or stride), rows padded to DMAX + 8 halfwords, and each fragment
// element is widened by a shift at its load (ldmatrix's 32-bit view does
// not apply to 16-bit rows: scalar loads).  QK^T then needs only
// big.big, one product a k-step, and PV two
// (P_small.V + P_big.V): the three products' bits less a zero term.  O is
// narrowed to bf16 with round-to-nearest-even.
//
// Instruction.  `wgmma` with .tf32 operands takes only K-major tiles from
// shared memory and has no transpose: Q and K are K-major for QK^T, but V
// (keys x D, D contiguous) is MN-major for PV, TMA cannot transpose 32-bit
// data, and the small parts of the B operands would need tiles of their
// own (at D 128 a 64-key f32 tile is 32 KB).  `mma.sync.m16n8k8` TF32
// loads each fragment from raw tiles in shared memory, forms the split in
// registers and reads V in any layout, so it is the instruction here.
//
// Design.  The Pallas kernel walks a (B, Hq, Sq/bq, Sk/bk) grid in order,
// carrying the running max, sum and accumulator in VMEM scratch across the
// key axis.  Here one CTA of 128 threads (four warps) owns BM = 64 query
// rows of one (b, query head) and loops over the key tiles itself:
//   - shared memory holds the Q tile and a two-stage ring of K and V tiles
//     of BK keys (64 up to a head dim of 64, 32 above), raw, f32 rows
//     padded to LD = DMAX + 4 words (LD = 4 mod 32): eight rows read by
//     ldmatrix at one column hit eight 16-byte bank groups, and the PV
//     reads of V (rows 2t, 2t + 1, columns g) hit 32 banks; bf16 rows to
//     DMAX + 8 halfwords (4 mod 32 words above class 32), so a fragment's
//     eight rows fall on distinct banks.  DMAX sizes a thread's
//     accumulator; 101 KB a CTA at DMAX 128 in f32 (two CTAs an SM);
//   - cp.async copies of 16 bytes a thread (8 or 4 where a base, a stride
//     or a row of D elements is no multiple of 16 bytes: the widest copy
//     that divides them all; bf16 rows of an odd head dim or stride by
//     plain 2-byte loads), rows past Sq or Sk and columns past D
//     zero-filled; K and V of a tile are
//     separate groups, so QK^T starts before V has landed, and the next
//     tile's copies are in flight during this one;
//   - warp w owns query rows [16 w, 16 w + 16): S = Q K^T by m16n8k8,
//     Q's and K's fragments by ldmatrix (a 32-bit element is two b16
//     halves; bf16 by scalar loads), Q reloaded from shared memory each
//     tile (its split does not fit in registers beside O at D 128);
//   - the accumulator of S holds columns (2t, 2t + 1) of a thread's rows;
//     the A operand of m16n8k8 wants columns (t, t + 4).  So each 8-key
//     block is read permuted: A's column t is key 2t and column t + 4 is
//     key 2t + 1, and V's B fragment reads rows 2t and 2t + 1 in the same
//     order.  P never leaves registers;
//   - at f32 and a head dim below DMAX a warp skips the products of the
//     8-key blocks that none of its rows below Sq may see (past Sk or,
//     under `causal`, past its last row's position): they would add
//     exact zeros, so the output keeps its bits, and a short prefill (Sq
//     2-32 in a 64-row, 64-key tile) runs the blocks it needs, not the
//     whole tile.  A tile a warp sees whole runs the loop without the
//     test (qk_tile / pv_tile, FULL).  The other kernels keep no skip:
//     with it ptxas changed their register use (bf16 at DMAX 32: 133
//     registers against 162; f32 at D = DMAX 128: 230 against 255), and
//     on an H100 the bf16 cases of 1,024 tokens ran 25 % slower and
//     granite's f32 prefill launches (D 128) 8.7 % slower;
//   - the online softmax in the exp2 domain on the fragment (row max and
//     sum over the four threads of a quad); masked scores are -inf and
//     contribute exactly 0; a row with no key yet keeps a zero
//     accumulator; only tiles on the causal diagonal, the window's edge or
//     the end of the keys are masked, and tiles wholly above the diagonal
//     or before the window are never loaded;
//   - CTAs are issued longest first: the query tiles with the most key
//     tiles take the lowest block indices.
// No atomics; every sum in a fixed order: two launches are bitwise equal.
//
// Bound on an H100 SXM (700 W): 4 * D FLOPs a head for every pair of a
// query and a key it sees (QK^T and PV), each f32 product as the three
// TF32 products that keep f32 accuracy on the tensor cores at 495 TFLOP/s
// (bf16 operands: as what the bf16 tensor cores would take, 989 TFLOP/s),
// against q, k, v and o each moved once at 3.35 TB/s.  The granite-3-8b
// prefill of a 1,024-token bucket at f32 (Hq 32, Hkv 8, D 128, causal;
// 8.6 GFLOP, 25.8 as TF32 products, 42 MB) is 0.052 ms, bound by
// operations.  At the f32 rate of the CUDA cores, 67 TFLOP/s, the same
// work would take 0.128 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // query rows a CTA: four warps of 16
constexpr int NT = 128;      // threads a CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// Tile shapes and shared memory at head-dim class DMAX for operands of
// type TX (float, or uint16_t: bf16 bits).
template <int DMAX, typename TX>
struct Cfg {
  static constexpr bool BF16 = sizeof(TX) == 2;
  static constexpr int BK = DMAX <= 64 ? 64 : 32;   // keys a tile
  static constexpr int LD = DMAX + (BF16 ? 8 : 4);  // elements a staged row
  static constexpr int Q_ELEMS = BM * LD;
  static constexpr int KV_ELEMS = BK * LD;
  static constexpr int BYTES =
      (int)sizeof(TX) * (Q_ELEMS + 2 * 2 * KV_ELEMS);
};

struct Args {
  void* out;
  const void* q;
  const void* k;
  const void* v;
  int B, Hq, Hkv, Sq, Sk, D;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  float scale_log2;
  int causal, window;
  int vec;                   // bytes a staging copy: 16, 8, 4 or 2
  float* lse;                // [B, Hq, Sq] row log-sum-exp, or null
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies of 16 (or 4) bytes into shared memory; `in` false zero-fills.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp8(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies of BYTES (8 or 4) bytes, E elements each, of rows [0, rows)
// into `dst`, the columns [0, DP) of each (see `stage`).
template <int BYTES, int DMAX, typename TX>
__device__ __forceinline__ void stage_n(uint32_t base, const TX* src,
                                        long long rs, int rows, int nvalid,
                                        int D, int DP) {
  constexpr int LD = Cfg<DMAX, TX>::LD;
  constexpr int E = BYTES / (int)sizeof(TX);
  constexpr int CPR = DMAX / E;      // copies a row slot
  for (int i = threadIdx.x; i < rows * CPR; i += NT) {
    const int r = i / CPR, c = E * (i - r * CPR);
    if (c < DP) {
      const bool in = r < nvalid && c < D;
      const uint32_t d = base + sizeof(TX) * (r * LD + c);
      const TX* p = src + (in ? r * rs + c : 0);
      if constexpr (BYTES == 8) cp8(d, p, in); else cp4(d, p, in);
    }
  }
}

// Rows [0, rows) of a [.., D] operand (row stride `rs` elements) into
// `dst` (LD elements a row), columns [0, DP) with DP = D rounded up to a
// multiple of 8: rows at and past `nvalid` and columns at and past D are
// zero-filled.  EXACT: D == DMAX.  `vec`: the bytes of a copy, 16, 8 or 4
// by cp.async where D, the strides and the base are multiples of it, or 2
// (bf16 rows of an odd head dim or stride) by plain loads and stores.
template <int DMAX, bool EXACT, typename TX>
__device__ __forceinline__ void stage(TX* dst, const TX* src, long long rs,
                                      int rows, int nvalid, int D, int vec) {
  constexpr int LD = Cfg<DMAX, TX>::LD;
  constexpr int V = 16 / (int)sizeof(TX);     // elements a 16-byte copy
  const int DP = EXACT ? DMAX : (D + 7) & ~7;
  const uint32_t base = smem_addr(dst);
  if (vec == 16) {
    // A thread keeps one 16-byte column of the rows it copies.
    constexpr int CPR = DMAX / V;    // 16-byte chunks a row slot: 4..64
    constexpr int RPP = NT / CPR;    // rows a pass of the CTA
    const int c = V * (threadIdx.x % CPR);
    if (c < DP) {
      for (int r = threadIdx.x / CPR; r < rows; r += RPP) {
        const bool in = r < nvalid && (EXACT || c < D);
        cp16(base + sizeof(TX) * (r * LD + c), src + (in ? r * rs + c : 0),
             in);
      }
    }
  } else if (vec == 8) {
    stage_n<8, DMAX>(base, src, rs, rows, nvalid, D, DP);
  } else if (sizeof(TX) == 4 || vec == 4) {
    stage_n<4, DMAX>(base, src, rs, rows, nvalid, D, DP);
  } else {
    // bf16 rows no 16-byte copy takes: cp.async has no 2-byte copy, so
    // plain loads and stores (visible after the barrier before use).
    for (int i = threadIdx.x; i < rows * DMAX; i += NT) {
      const int r = i / DMAX, c = i % DMAX;
      if (c < DP) dst[r * LD + c] = r < nvalid && c < D ? src[r * rs + c] : 0;
    }
  }
}

// Four 8x4 blocks of 32-bit values (8x8 of b16) from shared memory.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// x = big + small as TF32 operands.  big is cvt.rna.tf32.f32(x): half a
// unit of the 13 dropped bits added to the magnitude, then the bits
// cleared.  For the finite values here that is two integer instructions;
// cvt.rna itself compiles to four (an inf test and a select beside the
// add and the mask).  small = x - big is exact in f32, and its rounding
// is the same add: the mma ignores an operand's 13 low bits, so the mask
// is not needed there (the compiler drops it too where a cvt.rna result
// only feeds an mma).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// A bf16 value (its bits) as a TF32 operand: exact, by a shift.
__device__ __forceinline__ uint32_t widen(uint16_t x) {
  return (uint32_t)x << 16;
}

// c += a b: a 16x8 TF32 (row), b 8x8 TF32 (col), c 16x8 fp32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two output values of a row at columns col, col + 1 (col even), the
// second only where it lies below D; a pair store where D is even.
template <bool EXACT>
__device__ __forceinline__ void put2(float* o, int col, int D, float v0,
                                     float v1) {
  if (EXACT || (D % 2 == 0 && col + 1 < D)) {
    *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
    return;
  }
  o[col] = v0;
  if (col + 1 < D) o[col + 1] = v1;
}
template <bool EXACT>
__device__ __forceinline__ void put2(uint16_t* o, int col, int D, float v0,
                                     float v1) {
  const __nv_bfloat16 b0 = __float2bfloat16_rn(v0);
  const __nv_bfloat16 b1 = __float2bfloat16_rn(v1);
  if (EXACT || (D % 2 == 0 && col + 1 < D)) {
    __nv_bfloat162 p;
    p.x = b0;
    p.y = b1;
    *reinterpret_cast<__nv_bfloat162*>(o + col) = p;
    return;
  }
  o[col] = __bfloat16_as_ushort(b0);
  if (col + 1 < D) o[col + 1] = __bfloat16_as_ushort(b1);
}

// S = Q K^T on one key tile for a warp's 16 rows (g = lane / 4, t = lane
// % 4): the big.big products in sb, the cross terms in sx (f32 only).
// FULL: every 8-key block of the tile; else only the blocks below jn.
// Two instantiations, so that a tile a warp sees whole keeps the
// unpredicated loop.
template <int DMAX, bool EXACT, typename TX, bool FULL>
__device__ __forceinline__ void qk_tile(float (&sb)[Cfg<DMAX, TX>::BK / 8][4],
                                        float (&sx)[Cfg<DMAX, TX>::BK / 8][4],
                                        const TX* kt, const TX* qg0,
                                        uint32_t qaddr, uint32_t kaddr, int g,
                                        int t, int nd, int jn) {
  constexpr int LD = Cfg<DMAX, TX>::LD;
  constexpr int NKB = Cfg<DMAX, TX>::BK / 8;
  constexpr int NDB = DMAX / 8;
  if (!FULL && jn == 0) return;
#pragma unroll
  for (int kd = 0; kd < NDB; ++kd) {
    if (EXACT || kd < nd) {
      if constexpr (Cfg<DMAX, TX>::BF16) {
        const TX* qa = qg0 + 8 * kd;
        const uint32_t qg[4] = {widen(qa[0]), widen(qa[8 * LD]),
                                widen(qa[4]), widen(qa[8 * LD + 4])};
#pragma unroll
        for (int j = 0; j < NKB; ++j) {
          if (FULL || j < jn) {
            const TX* kr = kt + (8 * j + g) * LD + 8 * kd + t;
            mma(sb[j], qg, widen(kr[0]), widen(kr[4]));
          }
        }
      } else {
        uint32_t qr[4], qg[4], qs[4];
        ldsm_x4(qaddr + 32 * kd, qr);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split(__uint_as_float(qr[x]), qg[x], qs[x]);
#pragma unroll
        for (int j = 0; j < NKB; j += 2) {
          if (FULL || j < jn) {
            uint32_t kr[4], kg[4], ks[4];
            ldsm_x4(kaddr + 4 * 8 * j * LD + 32 * kd, kr);
#pragma unroll
            for (int x = 0; x < 4; ++x)
              split(__uint_as_float(kr[x]), kg[x], ks[x]);
            mma(sx[j], qs, kg[0], kg[1]);
            mma(sx[j], qg, ks[0], ks[1]);
            mma(sb[j], qg, kg[0], kg[1]);
            mma(sx[j + 1], qs, kg[2], kg[3]);
            mma(sx[j + 1], qg, ks[2], ks[3]);
            mma(sb[j + 1], qg, kg[2], kg[3]);
          }
        }
      }
    }
  }
}

// O = alpha O + P V on one key tile (see the kernel), the blocks as
// qk_tile takes them: every one (FULL) or those below jn.
template <int DMAX, bool EXACT, typename TX, bool FULL>
__device__ __forceinline__ void pv_tile(
    float (&o)[DMAX / 8][4], const float (&sc)[Cfg<DMAX, TX>::BK / 8][4],
    const float (&alpha)[2], const TX* vt, int g, int t, int nd, int jn) {
  constexpr int LD = Cfg<DMAX, TX>::LD;
  constexpr int NKB = Cfg<DMAX, TX>::BK / 8;
  constexpr int NDB = DMAX / 8;
  constexpr int PVC = NDB <= 16 ? NDB : 8;   // blocks a PV accumulator
#pragma unroll
  for (int c0 = 0; c0 < NDB; c0 += PVC) {
    float ot[PVC][4];
#pragma unroll
    for (int n = 0; n < PVC; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) ot[n][x] = 0.f;
#pragma unroll
    for (int j = 0; j < NKB; ++j) {
      if (FULL || j < jn) {
        uint32_t pg[4], ps[4];
        split(sc[j][0], pg[0], ps[0]);
        split(sc[j][2], pg[1], ps[1]);
        split(sc[j][1], pg[2], ps[2]);
        split(sc[j][3], pg[3], ps[3]);
        const TX* v0 = vt + (8 * j + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < PVC; ++n) {
          if (EXACT || c0 + n < nd) {
            if constexpr (Cfg<DMAX, TX>::BF16) {
              const uint32_t b0 = widen(v0[8 * (c0 + n)]);
              const uint32_t b1 = widen(v0[LD + 8 * (c0 + n)]);
              mma(ot[n], ps, b0, b1);
              mma(ot[n], pg, b0, b1);
            } else {
              uint32_t b0g, b0s, b1g, b1s;
              split(v0[8 * (c0 + n)], b0g, b0s);
              split(v0[LD + 8 * (c0 + n)], b1g, b1s);
              mma(ot[n], ps, b0g, b1g);
              mma(ot[n], pg, b0s, b1s);
              mma(ot[n], pg, b0g, b1g);
            }
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < PVC; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        o[c0 + n][x] = fmaf(o[c0 + n][x], alpha[x >> 1], ot[n][x]);
  }
}

// Fragments (per warp, g = lane / 4, t = lane % 4): A of m16n8k8 holds
// (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k, n) holds
// (t, g), (t + 4, g); the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).  EXACT: D == DMAX, so no head-dim block is skipped or
// padded.  TX: float, or uint16_t (bf16 bits).
template <int DMAX, bool EXACT, typename TX>
__global__ void __launch_bounds__(NT, DMAX <= 128 ? 2 : 1)
    flash_attention_tf32_kernel(const Args a) {
  using C = Cfg<DMAX, TX>;
  constexpr bool BF16 = C::BF16;
  constexpr int BK = C::BK, LD = C::LD;
  constexpr int NKB = BK / 8;        // 8-key blocks a tile
  constexpr int NDB = DMAX / 8;      // 8-column blocks of the head dim
  extern __shared__ __align__(16) float smem_f[];
  TX* const sQ = reinterpret_cast<TX*>(smem_f);
  TX* const sKV = sQ + C::Q_ELEMS;   // [stage][K, V][BK][LD]

  const int D = EXACT ? DMAX : a.D;
  const int nd = (D + 7) / 8;        // 8-column blocks, the last padded
  // Longest first: block 0 takes the last query tile of (b 0, head 0).
  const int nqt = (a.Sq + BM - 1) / BM;
  const int h = blockIdx.x % a.Hq;
  const int b = (blockIdx.x / a.Hq) % a.B;
  const int q0 = (nqt - 1 - (int)(blockIdx.x / (a.Hq * a.B))) * BM;
  const int hk = h / (a.Hq / a.Hkv);
  const int off = a.Sk - a.Sq;       // query i sits at key position i + off

  // The keys any row of the tile can see: [kbeg, kend), in key tiles.
  const int plo = q0 + off;
  const int phi = min(q0 + BM, a.Sq) - 1 + off;
  const int kend = a.causal ? min(a.Sk, phi + 1) : a.Sk;
  const int kbeg = a.window > 0 ? max(0, plo - a.window + 1) : 0;
  const int t0 = kbeg / BK;
  const int ntiles = kend > kbeg ? (kend + BK - 1) / BK - t0 : 0;

  const TX* kb = static_cast<const TX*>(a.k) + b * a.ksb + hk * a.ksh;
  const TX* vb = static_cast<const TX*>(a.v) + b * a.vsb + hk * a.vsh;
  const int vec = a.vec;

  // Groups in order: Q, then K and V of every tile (empty past the last),
  // so that before tile `it` the three newest groups are V_it, K_it+1 and
  // V_it+1.
  stage<DMAX, EXACT>(sQ, static_cast<const TX*>(a.q) + b * a.qsb +
                             h * a.qsh + (long long)q0 * a.qss,
                     a.qss, BM, a.Sq - q0, D, vec);
  cp_commit();
  auto issue = [&](int it) {
    if (it < ntiles) {
      const int k0 = (t0 + it) * BK;
      const int nv = min(BK, a.Sk - k0);
      TX* dst = sKV + 2 * (it & 1) * C::KV_ELEMS;
      stage<DMAX, EXACT>(dst, kb + k0 * a.kss, a.kss, BK, nv, D, vec);
      cp_commit();
      stage<DMAX, EXACT>(dst + C::KV_ELEMS, vb + k0 * a.vss, a.vss, BK, nv,
                         D, vec);
      cp_commit();
    } else {
      cp_commit();
      cp_commit();
    }
  };
  issue(0);
  issue(1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = q0 + 16 * warp + g + off;   // row g's key position
  // ldmatrix row addresses (f32): Q's rows (lane & 7) + 8 ((lane >> 3) &
  // 1) at column 4 (lane >> 4) give a0..a3; K's keys (lane & 7) + 8 (lane
  // >> 4) at column 4 ((lane >> 3) & 1) give b0, b1 of two 8-key blocks.
  const uint32_t qaddr =
      smem_addr(sQ) + 4 * ((16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                               LD + 4 * (lane >> 4));
  const int koff = ((lane & 7) + 8 * (lane >> 4)) * LD + 4 * ((lane >> 3) & 1);
  // bf16: row g of the warp's Q rows at column t, and key g of a block.
  const TX* const qg0 = sQ + (16 * warp + g) * LD + t;
  // The keys the warp's live rows may see end at wkend (0 for a warp with
  // no row below Sq): an 8-key block at or past it is masked for every
  // such row, its P is 0, and (f32, D < DMAX) its products are skipped.
  const int wfirst = q0 + 16 * warp;
  const int wlast = min(wfirst + 15, a.Sq - 1);
  const int wkend = wlast < wfirst ? 0
                    : a.causal ? min(a.Sk, wlast + off + 1) : a.Sk;

  float o[NDB][4];
#pragma unroll
  for (int n = 0; n < NDB; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[n][x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};           // this thread's part of the row sums

  for (int it = 0; it < ntiles; ++it) {
    const TX* kt = sKV + 2 * (it & 1) * C::KV_ELEMS;
    const TX* vt = kt + C::KV_ELEMS;
    const int k0 = (t0 + it) * BK;
    // Blocks with a key a live row of the warp may see (all but at f32
    // below DMAX, the kernel that skips).
    const int jn = BF16 || EXACT ? NKB
                                 : max(0, min(NKB, (wkend - k0 + 7) / 8));
    cp_wait<3>();                    // Q and this tile's K
    __syncthreads();

    // S = Q K^T: big.big in sb, the cross terms in sx (f32 only).
    float sb[NKB][4], sx[NKB][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) sb[j][x] = sx[j][x] = 0.f;
    const uint32_t kaddr = smem_addr(kt) + 4 * koff;
    if (jn == NKB)
      qk_tile<DMAX, EXACT, TX, true>(sb, sx, kt, qg0, qaddr, kaddr, g, t, nd,
                                     jn);
    else
      qk_tile<DMAX, EXACT, TX, false>(sb, sx, kt, qg0, qaddr, kaddr, g, t,
                                      nd, jn);

    // Scale into the exp2 domain, then mask where the tile needs it.
    float sc[NKB][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        sc[j][x] = (sb[j][x] + sx[j][x]) * a.scale_log2;
    const bool edge = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > plo) ||
                      (a.window > 0 && k0 <= phi - a.window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int key = k0 + 8 * j + 2 * t + (x & 1);
          const int p = p0 + 8 * (x >> 1);
          const bool ok = key < a.Sk && (!a.causal || key <= p) &&
                          (a.window <= 0 || key > p - a.window);
          if (!ok) sc[j][x] = -INFINITY;
        }
    }

    // Online softmax on rows g (i = 0) and g + 8 (i = 1).
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NKB; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * i], sc[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float mnew = fmaxf(m[i], mx);
      // While no key is seen, mnew is -inf: every p and alpha is 0.
      const float mref = mnew == -INFINITY ? 0.f : mnew;
      alpha[i] = exp2f(m[i] - mref);
      m[i] = mnew;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[j][2 * i + e] - mref);
          sc[j][2 * i + e] = p;
          sum += p;
        }
      l[i] = l[i] * alpha[i] + sum;
    }

    // O = alpha O + P V, block j's keys read permuted: A's column t is key
    // 2t and t + 4 is key 2t + 1, and V's rows 2t, 2t + 1 give b0, b1.
    // The tile's P V goes to a fresh accumulator (PVC column blocks at a
    // time), added to O by an fma.
    cp_wait<2>();                    // this tile's V
    __syncthreads();
    if (jn == NKB)
      pv_tile<DMAX, EXACT, TX, true>(o, sc, alpha, vt, g, t, nd, jn);
    else
      pv_tile<DMAX, EXACT, TX, false>(o, sc, alpha, vt, g, t, nd, jn);
    __syncthreads();                 // every warp is done with the stage
    issue(it + 2);
  }
  cp_wait<0>();                      // no copy outlives the CTA

  // Normalise by the row sums and store the live rows' first D columns.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
  }
  // m is the row max in the exp2 domain and l the row sum of exp2(s - m):
  // the natural log-sum-exp is (m + log2 l) ln 2.  One lane of a quad
  // stores it (the quad's four lanes hold the same m and l).
  if (a.lse != nullptr && t == 0) {
    float* lrow = a.lse + ((long long)b * a.Hq + h) * a.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 16 * warp + g + 8 * i;
      if (row < a.Sq)
        lrow[row] = l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2 : -INFINITY;
    }
  }
  TX* ob = static_cast<TX*>(a.out) + ((long long)b * a.Hq + h) * a.Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    if (row >= a.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    TX* orow = ob + (long long)row * D;
#pragma unroll
    for (int n = 0; n < NDB; ++n) {
      const int col = 8 * n + 2 * t;
      if (EXACT || col < D)
        put2<EXACT>(orow, col, D, o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

template <int DMAX, typename TX>
int launch_t(const Args& a, cudaStream_t stream) {
  // bf16 at a head dim of 32, 64, 128 or 256 takes the wgmma route, so
  // only f32 has a kernel for D == DMAX; the other one takes any D.
  auto kern = flash_attention_tf32_kernel<DMAX, false, TX>;
  if constexpr (sizeof(TX) == 4)
    if (a.D == DMAX) kern = flash_attention_tf32_kernel<DMAX, true, TX>;
  const int smem = Cfg<DMAX, TX>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)((a.Sq + BM - 1) / BM) * a.Hq * a.B;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_d(const Args& a, cudaStream_t s) {
  if (a.D <= 32) return launch_t<32, TX>(a, s);
  if (a.D <= 64) return launch_t<64, TX>(a, s);
  if (a.D <= 128) return launch_t<128, TX>(a, s);
  return launch_t<256, TX>(a, s);
}

}  // namespace

// Strides in elements: q (batch, head, row), k and v likewise; unit stride
// along D.  `window` <= 0: no window.  `bf16`: the operands and the output
// are bf16, else f32.  The output is a contiguous [B, Hq, Sq, D] tensor;
// `lse`, if not null, a contiguous f32 [B, Hq, Sq] tensor that takes the
// rows' log-sum-exp.  Returns 0 or a cudaError_t.
extern "C" int flash_attention_tf32_launch(
    void* out, const void* q, const void* k, const void* v, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int causal,
    int window, int bf16, void* lse, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D < 1 || D > 256 || Sk < 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  // The widest copy (16, 8, 4 bytes; 2 for bf16 by plain loads) that
  // divides a row of D elements, every stride and the bases.
  const int es = bf16 ? 2 : 4;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  int vec = 16;
  for (;; vec /= 2) {
    bool ok = vec == es || ((long long)D * es % vec == 0 && bases % vec == 0);
    for (int i = 0; i < 9 && ok && vec > es; ++i)
      ok = st[i] * es % vec == 0;
    if (ok) break;
  }
  const Args a = {out, q, k, v, B, Hq, Hkv, Sq, Sk, D, qsb, qsh, qss, ksb,
                  ksh, kss, vsb, vsh, vss, scale * LOG2E, causal, window,
                  vec, static_cast<float*>(lse)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<uint16_t>(a, s) : launch_d<float>(a, s);
}

// Dynamic shared memory of one CTA at head dim D, f32 operands or bf16
// (`bf16`; for the report).
extern "C" int flash_attention_tf32_smem_bytes(int D, int bf16) {
  if (bf16) {
    if (D <= 32) return Cfg<32, uint16_t>::BYTES;
    if (D <= 64) return Cfg<64, uint16_t>::BYTES;
    if (D <= 128) return Cfg<128, uint16_t>::BYTES;
    return Cfg<256, uint16_t>::BYTES;
  }
  if (D <= 32) return Cfg<32, float>::BYTES;
  if (D <= 64) return Cfg<64, float>::BYTES;
  if (D <= 128) return Cfg<128, float>::BYTES;
  return Cfg<256, float>::BYTES;
}
