// Blocked online-softmax attention (flash attention, forward) for Hopper
// (sm_90a): f32 operands, QK^T and PV on the TF32 tensor cores by
// `mma.sync`, each product split into three TF32 products (3xTF32), fp32
// accumulation, K/V staged by `cp.async` through a two-stage ring.
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
// f32; a query with no valid key gets a zero row.  q, k and v are read
// through their batch, head and row strides (unit stride along D).  This
// is the route for f32 operands with D % 8 == 0 and D <= 256; other f32
// head dims take flash_attention.cu (fp32 SIMT), bf16 operands
// flash_attention_sm90.cu or flash_attention.cu (flash_attention.py
// `route`).
//
// Precision.  The reference computes QK^T and PV in f32; a TF32 product
// keeps 11 bits of each operand.  Each operand x is split in registers
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
// an fp32 fma (O alpha + tile), which rounds: 1.9e-6 on the same launches
// (the SIMT kernel: 2.2e-6).  QK^T's sums span one tile and D / 8 steps,
// and keeping them in the mma costs nothing measurable there.
//
// Instruction.  `wgmma` with .tf32 operands takes only K-major tiles from
// shared memory and has no transpose: Q and K are K-major for QK^T, but V
// (keys x D, D contiguous) is MN-major for PV, TMA cannot transpose 32-bit
// data, and the small parts of the B operands would need tiles of their
// own (at D 128 a 64-key f32 tile is 32 KB).  `mma.sync.m16n8k8` TF32
// loads each fragment from raw f32 tiles in shared memory, forms the split
// in registers and reads V in any layout, so it is the instruction here.
//
// Design.  The Pallas kernel walks a (B, Hq, Sq/bq, Sk/bk) grid in order,
// carrying the running max, sum and accumulator in VMEM scratch across the
// key axis.  Here one CTA of 128 threads (four warps) owns BM = 64 query
// rows of one (b, query head) and loops over the key tiles itself:
//   - shared memory holds the Q tile and a two-stage ring of K and V tiles
//     of BK keys (64 up to a head dim of 64, 32 above), raw f32, rows
//     padded to LD = DMAX + 4 words (LD = 4 mod 32): eight rows read by
//     ldmatrix at one column hit eight 16-byte bank groups, and the PV
//     reads of V (rows 2t, 2t + 1, columns g) hit 32 banks.  DMAX, the
//     head dim rounded up to 32, 64, 128 or 256, sizes a thread's
//     accumulator; 101 KB a CTA at DMAX 128 (two CTAs an SM);
//   - cp.async copies of 16 bytes a thread (4 bytes where a base or a
//     stride is no multiple of 16 bytes), rows past Sq or Sk zero-filled;
//     K and V of a tile are separate groups, so QK^T starts before V has
//     landed, and the next tile's copies are in flight during this one;
//   - warp w owns query rows [16 w, 16 w + 16): S = Q K^T by m16n8k8,
//     Q's and K's fragments by ldmatrix (a 32-bit element is two b16
//     halves), Q reloaded from shared memory each tile (its split does
//     not fit in registers beside O at D 128);
//   - the accumulator of S holds columns (2t, 2t + 1) of a thread's rows;
//     the A operand of m16n8k8 wants columns (t, t + 4).  So each 8-key
//     block is read permuted: A's column t is key 2t and column t + 4 is
//     key 2t + 1, and V's B fragment reads rows 2t and 2t + 1 in the same
//     order.  P never leaves registers;
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
// query and a key it sees (QK^T and PV), each as the three TF32 products
// that keep f32 accuracy on the tensor cores at 495 TFLOP/s, against q,
// k, v and o each moved once at 3.35 TB/s.  The granite-3-8b prefill of a
// 1,024-token bucket (Hq 32, Hkv 8, D 128, causal; 8.6 GFLOP, 25.8 as
// TF32 products, 42 MB) is 0.052 ms, bound by operations.  At the f32
// rate of the CUDA cores, 67 TFLOP/s, the same work would take 0.128 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // query rows a CTA: four warps of 16
constexpr int NT = 128;      // threads a CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Tile shapes and shared memory at head-dim class DMAX.
template <int DMAX>
struct Cfg {
  static constexpr int BK = DMAX <= 64 ? 64 : 32;   // keys a tile
  static constexpr int LD = DMAX + 4;               // floats a staged row
  static constexpr int Q_FLOATS = BM * LD;
  static constexpr int KV_FLOATS = BK * LD;
  static constexpr int BYTES = 4 * (Q_FLOATS + 2 * 2 * KV_FLOATS);
};

struct Args {
  float* out;
  const float* q;
  const float* k;
  const float* v;
  int B, Hq, Hkv, Sq, Sk, D;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  float scale_log2;
  int causal, window, wide;
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

// Rows [0, rows) of a [.., D] operand (row stride `rs` elements) into
// `dst` (LD floats a row); rows at and past `nvalid` are zero-filled.
// EXACT: D == DMAX.
template <int DMAX, bool EXACT>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long rs, int rows, int nvalid,
                                      int D, bool wide) {
  constexpr int LD = Cfg<DMAX>::LD;
  const uint32_t base = smem_addr(dst);
  if (wide) {
    // A thread keeps one 16-byte column of the rows it copies.
    constexpr int CPR = DMAX / 4;    // 16-byte chunks a row slot: 8..64
    constexpr int RPP = NT / CPR;    // rows a pass of the CTA
    const int c = 4 * (threadIdx.x % CPR);
    if (EXACT || c < D) {
      for (int r = threadIdx.x / CPR; r < rows; r += RPP) {
        const bool in = r < nvalid;
        cp16(base + 4 * (r * LD + c), src + (in ? r * rs : 0) + c, in);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * DMAX; i += NT) {
      const int r = i / DMAX, c = i % DMAX;
      if (c < D) {
        const bool in = r < nvalid;
        cp4(base + 4 * (r * LD + c), src + (in ? r * rs : 0) + c, in);
      }
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

// c += a b: a 16x8 TF32 (row), b 8x8 TF32 (col), c 16x8 fp32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments (per warp, g = lane / 4, t = lane % 4): A of m16n8k8 holds
// (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k, n) holds
// (t, g), (t + 4, g); the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).  EXACT: D == DMAX, so no head-dim block is skipped.
template <int DMAX, bool EXACT>
__global__ void __launch_bounds__(NT, DMAX <= 128 ? 2 : 1)
    flash_attention_tf32_kernel(const Args a) {
  using C = Cfg<DMAX>;
  constexpr int BK = C::BK, LD = C::LD;
  constexpr int NKB = BK / 8;        // 8-key blocks a tile
  constexpr int NDB = DMAX / 8;      // 8-column blocks of the head dim
  constexpr int PVC = NDB <= 16 ? NDB : 8;   // blocks a PV accumulator
  extern __shared__ __align__(16) float smem[];
  float* const sQ = smem;
  float* const sKV = smem + C::Q_FLOATS;   // [stage][K, V][BK][LD]

  const int D = EXACT ? DMAX : a.D;
  const int nd = D / 8;
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

  const float* kb = a.k + b * a.ksb + hk * a.ksh;
  const float* vb = a.v + b * a.vsb + hk * a.vsh;
  const bool wide = a.wide != 0;

  // Groups in order: Q, then K and V of every tile (empty past the last),
  // so that before tile `it` the three newest groups are V_it, K_it+1 and
  // V_it+1.
  stage<DMAX, EXACT>(sQ, a.q + b * a.qsb + h * a.qsh + (long long)q0 * a.qss,
              a.qss, BM, a.Sq - q0, D, wide);
  cp_commit();
  auto issue = [&](int it) {
    if (it < ntiles) {
      const int k0 = (t0 + it) * BK;
      const int nv = min(BK, a.Sk - k0);
      float* dst = sKV + 2 * (it & 1) * C::KV_FLOATS;
      stage<DMAX, EXACT>(dst, kb + k0 * a.kss, a.kss, BK, nv, D, wide);
      cp_commit();
      stage<DMAX, EXACT>(dst + C::KV_FLOATS, vb + k0 * a.vss, a.vss, BK, nv, D,
                  wide);
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
  // ldmatrix row addresses: Q's rows (lane & 7) + 8 ((lane >> 3) & 1) at
  // column 4 (lane >> 4) give a0..a3; K's keys (lane & 7) + 8 (lane >> 4)
  // at column 4 ((lane >> 3) & 1) give b0, b1 of two 8-key blocks.
  const uint32_t qaddr =
      smem_addr(sQ) + 4 * ((16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                               LD + 4 * (lane >> 4));
  const int koff = ((lane & 7) + 8 * (lane >> 4)) * LD + 4 * ((lane >> 3) & 1);

  float o[NDB][4];
#pragma unroll
  for (int n = 0; n < NDB; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[n][x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};           // this thread's part of the row sums

  for (int it = 0; it < ntiles; ++it) {
    const float* kt = sKV + 2 * (it & 1) * C::KV_FLOATS;
    const float* vt = kt + C::KV_FLOATS;
    const int k0 = (t0 + it) * BK;
    cp_wait<3>();                    // Q and this tile's K
    __syncthreads();

    // S = Q K^T: big.big in sb, the cross terms in sx.
    float sb[NKB][4], sx[NKB][4];
#pragma unroll
    for (int j = 0; j < NKB; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) sb[j][x] = sx[j][x] = 0.f;
    const uint32_t kaddr = smem_addr(kt) + 4 * koff;
#pragma unroll
    for (int kd = 0; kd < NDB; ++kd) {
      if (EXACT || kd < nd) {
        uint32_t qr[4], qg[4], qs[4];
        ldsm_x4(qaddr + 32 * kd, qr);
#pragma unroll
        for (int x = 0; x < 4; ++x) split(__uint_as_float(qr[x]), qg[x], qs[x]);
#pragma unroll
        for (int j = 0; j < NKB; j += 2) {
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
#pragma unroll
    for (int c0 = 0; c0 < NDB; c0 += PVC) {
      float ot[PVC][4];
#pragma unroll
      for (int n = 0; n < PVC; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) ot[n][x] = 0.f;
#pragma unroll
      for (int j = 0; j < NKB; ++j) {
        uint32_t pg[4], ps[4];
        split(sc[j][0], pg[0], ps[0]);
        split(sc[j][2], pg[1], ps[1]);
        split(sc[j][1], pg[2], ps[2]);
        split(sc[j][3], pg[3], ps[3]);
        const float* v0 = vt + (8 * j + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < PVC; ++n) {
          if (EXACT || c0 + n < nd) {
            uint32_t b0g, b0s, b1g, b1s;
            split(v0[8 * (c0 + n)], b0g, b0s);
            split(v0[LD + 8 * (c0 + n)], b1g, b1s);
            mma(ot[n], ps, b0g, b1g);
            mma(ot[n], pg, b0s, b1s);
            mma(ot[n], pg, b0g, b1g);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < PVC; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          o[c0 + n][x] = fmaf(o[c0 + n][x], alpha[x >> 1], ot[n][x]);
    }
    __syncthreads();                 // every warp is done with the stage
    issue(it + 2);
  }
  cp_wait<0>();                      // no copy outlives the CTA

  // Normalise by the row sums and store the live rows.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
  }
  float* ob = a.out + ((long long)b * a.Hq + h) * a.Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    if (row >= a.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = ob + (long long)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NDB; ++n)
      if (EXACT || n < nd)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int DMAX>
int launch_t(const Args& a, cudaStream_t stream) {
  auto kern = a.D == DMAX ? flash_attention_tf32_kernel<DMAX, true>
                          : flash_attention_tf32_kernel<DMAX, false>;
  const int smem = Cfg<DMAX>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)((a.Sq + BM - 1) / BM) * a.Hq * a.B;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides in elements: q (batch, head, row), k and v likewise; unit stride
// along D.  `window` <= 0: no window.  The output is a contiguous
// [B, Hq, Sq, D] f32 tensor.  Returns 0 or a cudaError_t.
extern "C" int flash_attention_tf32_launch(
    void* out, const void* q, const void* k, const void* v, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int causal,
    int window, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D < 8 || D > 256 || D % 8 != 0 ||
      Sk < 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  // 16-byte copies need 16-byte aligned bases and strides.
  bool wide = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
               | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (int i = 0; i < 9; ++i) wide = wide && st[i] % 4 == 0;
  const Args a = {static_cast<float*>(out), static_cast<const float*>(q),
                  static_cast<const float*>(k), static_cast<const float*>(v),
                  B, Hq, Hkv, Sq, Sk, D, qsb, qsh, qss, ksb, ksh, kss, vsb,
                  vsh, vss, scale * LOG2E, causal, window, (int)wide};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_t<32>(a, s);
  if (D <= 64) return launch_t<64>(a, s);
  if (D <= 128) return launch_t<128>(a, s);
  return launch_t<256>(a, s);
}

// Dynamic shared memory of one CTA at head dim D (for the report).
extern "C" int flash_attention_tf32_smem_bytes(int D) {
  if (D <= 32) return Cfg<32>::BYTES;
  if (D <= 64) return Cfg<64>::BYTES;
  if (D <= 128) return Cfg<128>::BYTES;
  return Cfg<256>::BYTES;
}
