// Blocked online-softmax attention (flash attention, forward) for Hopper
// (sm_90a): bf16 operands, QK^T and PV on the tensor cores by `wgmma`,
// fp32 accumulation, operands staged by TMA.
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
// bf16; a query with no valid key gets a zero row.  q, k and v are read
// through their batch, head and row strides (unit stride along D), which
// TMA needs to be multiples of 16 bytes (the wrapper checks).  This is the
// route for bf16 operands with D % 16 == 0 and D <= 256; f32 operands and
// the other bf16 head dims take flash_attention_tf32.cu (TF32 mma.sync).
//
// Precision.  The reference widens q, k, v to f32 and computes QK^T and PV
// in f32.  A bf16 x bf16 product is exact in fp32, so QK^T by a bf16
// `wgmma` accumulating in fp32 is the reference's, up to summation order.
// The probabilities P are fp32; rounding them to bf16 for PV would keep 8
// bits.  Each P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// and PV runs twice, on P_hi and on P_lo, into one fp32 accumulator: about
// 16 bits of each probability, for 1.5x the tensor-core work of QK^T + PV.
// The output is normalised by the fp32 row sum and rounded to bf16 once.
//
// Design.  The Pallas kernel walks a (B, Hq, Sq/bq, Sk/bk) grid in order,
// carrying the running max, sum and accumulator in VMEM scratch across the
// key axis.  Here one CTA of 384 threads owns 128 query rows of one
// (b, query head) and loops over the key tiles itself:
//   - warpgroups 0 and 1 are consumers, each owning 64 query rows; the
//     third warpgroup is the producer, one thread of which issues every
//     TMA copy.  `setmaxnreg` gives the consumers 240 registers and the
//     producer 24;
//   - the Q tile (128 rows) is copied once; K and V tiles of BK = 64 keys
//     go through a ring of two stages, each with its own full barriers
//     (K and V apart, so QK^T starts before V lands) and an empty barrier
//     that both consumers arrive on when their products are done;
//   - shared tiles are 64 bf16 columns (128 bytes) wide, in the 128-byte
//     swizzle that TMA writes and the `wgmma` descriptors read; a head dim
//     of D is held as DP = D rounded up to 64 (D = 80 as 128, D = 32 as
//     64), the columns past D zero-filled by TMA's out-of-bounds fill, so
//     they add nothing to QK^T and give output columns that are not stored;
//   - S = Q K^T is a chain of m64n64k16 `wgmma`s, both operands in shared
//     memory (K-major); the online softmax (row max, exp2 of the scaled
//     scores, rescale by exp2(m_old - m_new), row sum) runs on the fp32
//     accumulator fragment, a row spread over the four threads of a quad;
//   - P never goes through shared memory: the accumulator fragment of S
//     has the layout of the A operand of the next `wgmma`, so P_hi and P_lo
//     are packed in registers and O += P V runs as m64n64k16 `wgmma`s with
//     A from registers and V (MN-major, transposed by the instruction) from
//     shared memory, one per 64 output columns;
//   - TMA's out-of-bounds zero fill stands in for padding the ragged ends
//     (Sq, Sk not multiples of a tile; the head past D); key tiles wholly
//     above the causal diagonal or wholly before the window are never
//     loaded, and only tiles on the diagonal, the window's edge or the end
//     of the keys are masked.  Masked scores are -inf and contribute
//     exactly 0; a row with no key yet keeps a zero accumulator;
//   - CTAs are issued longest first: the query tiles with the most key
//     tiles (the last, under `causal`) take the lowest block indices, so
//     the second wave on the 132 SMs is made of short tiles.
//
// Bound on an H100 SXM: 4 * D FLOPs a head for every pair of a query and
// a key it sees (QK^T and PV) at 989 TFLOP/s, the bf16 tensor-core rate,
// against q, k, v and o each moved once at 3.35 TB/s.  A granite-3-8b
// prefill of a 1,024-token bucket (Hq 32, Hkv 8, D 128, causal) is 8.6
// GFLOP, 8.7 us, against 21 MB of bytes, 6.3 us: bound by operations.
// This kernel executes 1.5x those operations (the P split) and, on the
// diagonal tiles, the masked half of each tile.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // query rows a CTA: two consumer warpgroups
constexpr int BK = 64;       // keys a tile
constexpr int STAGES = 2;    // K/V ring
constexpr int NT = 384;      // two consumer warpgroups and the producer
constexpr int CHUNK = 64;    // bf16 columns in one 128-byte swizzled row
constexpr int ROW = 128;     // bytes of one swizzled row
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of a CTA at padded head dim DP: the Q tile, STAGES K and V
// tiles, each as DP / 64 column chunks of (rows x 128 bytes), and the
// barriers; 1,024 bytes of slack to align the swizzled tiles.
template <int DP>
struct Layout {
  static constexpr int NC = DP / CHUNK;
  static constexpr int Q_BYTES = NC * BM * ROW;
  static constexpr int KV_BYTES = NC * BK * ROW;
  static constexpr int TILES = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BARS = 1 + 3 * STAGES;   // Q, K full, V full, empty
  static constexpr int BYTES = TILES + 8 * BARS + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait that lasts 2^34 cycles (~10 s) traps: a fault in the barrier
// protocol then fails the launch instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// One TMA copy of a box of the 4-D map {D, rows, heads, batch} into shared
// memory, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// `wgmma` shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1,024-byte aligned atoms of 8 rows x 128 bytes): start address, leading
// and stride byte offsets of one atom (1,024 bytes; only one of the two is
// read for these shapes), layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous `wgmma` that owns it.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WG_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define WG_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, fp32) = or += A (64 x 16) B (16 x 64): A and B bf16 in
// shared memory, both K-major (D contiguous).  `accumulate` 0 overwrites.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16) B (16 x 64): A bf16 from registers (the
// layout of an accumulator fragment), B bf16 in shared memory, MN-major
// (the 64 output columns contiguous; transposed by the instruction).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// An accumulator fragment of m64nN (per warp: rows 16w + lane/4 + 8i,
// columns 8c + 2(lane%4) + j) holds element (i, c, j) in register
// 4c + 2i + j.  The same thread's registers 8kk + 2r, 8kk + 2r + 1 are
// register r of the A fragment of keys 16kk..16kk+15 for the next product.
template <int DP>
__global__ void __launch_bounds__(NT, 1)
    flash_attention_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                                __grid_constant__ const CUtensorMap tk,
                                __grid_constant__ const CUtensorMap tv,
                                __nv_bfloat16* __restrict__ out, int B,
                                int Hq, int Hkv, int Sq, int Sk, int D,
                                float scale_log2, int causal, int window) {
  using L = Layout<DP>;
  constexpr int NC = L::NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + L::Q_BYTES;                 // [STAGES] tiles
  const uint32_t sV = sK + STAGES * L::KV_BYTES;       // [STAGES] tiles
  const uint32_t bars = sV + STAGES * L::KV_BYTES;
  const uint32_t barQ = bars;
  auto barK = [&](int s) { return bars + 8u * (1 + s); };
  auto barV = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto barE = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  // Longest first: block 0 takes the last query tile of (b 0, head 0).
  const int nqt = (Sq + BM - 1) / BM;
  const int h = blockIdx.x % Hq;
  const int b = (blockIdx.x / Hq) % B;
  const int q0 = (nqt - 1 - blockIdx.x / (Hq * B)) * BM;
  const int hk = h / (Hq / Hkv);
  const int off = Sk - Sq;           // query i sits at key position i + off

  // The keys any row of the tile can see: [kbeg, kend), in key tiles.
  const int plo = q0 + off;
  const int phi = min(q0 + BM, Sq) - 1 + off;
  const int kend = causal ? min(Sk, phi + 1) : Sk;
  const int kbeg = window > 0 ? max(0, plo - window + 1) : 0;
  const int t0 = kbeg / BK;
  const int ntiles = kend > kbeg ? (kend + BK - 1) / BK - t0 : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    bar_init(barQ, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(barK(s), 1);
      bar_init(barV(s), 1);
      bar_init(barE(s), 2);        // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // Producer: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 256 && ntiles > 0) {
      bar_expect_tx(barQ, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load(sQ + c * BM * ROW, &tq, barQ, c * CHUNK, q0, h, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        bar_wait(barE(s), ((it / STAGES) & 1) ^ 1);
        const int k0 = (t0 + it) * BK;
        bar_expect_tx(barK(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sK + s * L::KV_BYTES + c * BK * ROW, &tk, barK(s),
                   c * CHUNK, k0, hk, b);
        bar_expect_tx(barV(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sV + s * L::KV_BYTES + c * BK * ROW, &tv, barV(s),
                   c * CHUNK, k0, hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int lane = tid % 32;
    const int r0 = q0 + 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
    const int cq = 2 * (lane % 4);   // this thread's column pair in each 8
    float o[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int x = 0; x < 32; ++x) o[c][x] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};         // this thread's part of the row sums
    float sc[32];                    // S, then P, of the current tile
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = 0.f;
    const uint32_t qrows = sQ + wg * 64 * ROW;
    if (ntiles > 0) bar_wait(barQ, 0);

    for (int it = 0; it < ntiles; ++it) {
      const int s = it % STAGES;
      const uint32_t phase = (it / STAGES) & 1;
      const int k0 = (t0 + it) * BK;
      const uint32_t kt = sK + s * L::KV_BYTES;
      const uint32_t vt = sV + s * L::KV_BYTES;

      // S = Q K^T over DP / 16 steps of k16.
      bar_wait(barK(s), phase);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sc, sw128(qrows + c * BM * ROW + kk * 32),
                   sw128(kt + c * BK * ROW + kk * 32), (c | kk) != 0);
      wg_commit();
      wg_wait_all();
      pin(sc);

      // Scale into the exp2 domain, then mask where the tile needs it.
#pragma unroll
      for (int x = 0; x < 32; ++x) sc[x] *= scale_log2;
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > plo) ||
                        (window > 0 && k0 <= phi - window);
      if (edge) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int key = k0 + 8 * (x / 4) + cq + (x & 1);
          const int p = r0 + 8 * ((x >> 1) & 1) + off;
          const bool ok = key < Sk && (!causal || key <= p) &&
                          (window <= 0 || key > p - window);
          if (!ok) sc[x] = -INFINITY;
        }
      }

      // Online softmax on rows r0 (i = 0) and r0 + 8 (i = 1).
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * i], sc[4 * c + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mnew = fmaxf(m[i], mx);
        // While no key is seen, mnew is -inf: every p and alpha is 0.
        const float mref = mnew == -INFINITY ? 0.f : mnew;
        alpha[i] = exp2f(m[i] - mref);
        m[i] = mnew;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p = exp2f(sc[4 * c + 2 * i + j] - mref);
            sc[4 * c + 2 * i + j] = p;
            sum += p;
          }
        l[i] = l[i] * alpha[i] + sum;
      }

      // P = P_hi + P_lo, both bf16, packed as A fragments.
      uint32_t phi_a[4][4], plo_a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hi);
          phi_a[kk][r] = bf16x2_bits(hi);
          plo_a[kk][r] =
              bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
        }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int x = 0; x < 32; ++x) o[c][x] *= alpha[(x >> 1) & 1];

      // O += P_hi V + P_lo V.
      bar_wait(barV(s), phase);
#pragma unroll
      for (int c = 0; c < NC; ++c) pin(o[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pin(phi_a[kk]);
        pin(plo_a[kk]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint64_t dv = sw128(vt + c * BK * ROW + kk * 16 * ROW);
          wgmma_rs(o[c], phi_a[kk], dv);
          wgmma_rs(o[c], plo_a[kk], dv);
        }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) pin(o[c]);
      // Both products of this warpgroup have read the stage: release it.
      if (tid % 128 == 0) bar_arrive(barE(s));
    }

    // Normalise by the row sums, round once, store the live rows.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    __nv_bfloat16* ob = out + ((long long)b * Hq + h) * Sq * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= Sq) continue;
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      __nv_bfloat16* orow = ob + (long long)row * D;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int col = CHUNK * c + 8 * g + cq;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[c][4 * g + 2 * i] * inv,
                                      o[c][4 * g + 2 * i + 1] * inv);
        }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime so the
// library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map {D, S, H, B} of one operand, boxes of 64 columns x `rows`
// rows of one head, 128-byte swizzle, zero fill out of bounds.  Strides
// in elements.  Returns 0 or the CUresult of the encoder.
int encode(EncodeTiled enc, CUtensorMap* map, const void* base, int D, int S,
           int H, int B, long long ss, long long sh, long long sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {CHUNK, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return (int)enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
int launch_t(const CUtensorMap& tq, const CUtensorMap& tk,
             const CUtensorMap& tv, void* out, int B, int Hq, int Hkv,
             int Sq, int Sk, int D, float scale, int causal, int window,
             cudaStream_t stream) {
  auto kern = flash_attention_sm90_kernel<DP>;
  const int smem = Layout<DP>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)((Sq + BM - 1) / BM) * Hq * B;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)grid, NT, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), B, Hq, Hkv, Sq, Sk, D,
      scale * LOG2E, causal, window);
  return (int)cudaGetLastError();
}

bool tma_ok(const void* p, long long a, long long b, long long c) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && a > 0 && b > 0 &&
         c > 0 && a % 8 == 0 && b % 8 == 0 && c % 8 == 0;
}

}  // namespace

// Strides in elements: q (batch, head, row), k and v likewise; unit stride
// along D, each other stride a positive multiple of 8 elements (16 bytes)
// and the base pointers 16-byte aligned, as TMA needs.  `window` <= 0: no
// window.  The output is a contiguous [B, Hq, Sq, D] bf16 tensor.  Returns
// 0, a cudaError_t, or minus the CUresult of a refused tensor map.
extern "C" int flash_attention_sm90_launch(
    void* out, const void* q, const void* k, const void* v, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int causal,
    int window, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D < 16 || D > 256 || D % 16 != 0 ||
      Sk < 0 || !tma_ok(q, qsb, qsh, qss) || !tma_ok(k, ksb, ksh, kss) ||
      !tma_ok(v, vsb, vsh, vss))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sk == 0)   // no key at all: every row is zero
    return (int)cudaMemsetAsync(out, 0, (size_t)B * Hq * Sq * D * 2, s);
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  int r = encode(enc, &tq, q, D, Sq, Hq, B, qss, qsh, qsb, BM);
  if (r == 0) r = encode(enc, &tk, k, D, Sk, Hkv, B, kss, ksh, ksb, BK);
  if (r == 0) r = encode(enc, &tv, v, D, Sk, Hkv, B, vss, vsh, vsb, BK);
  if (r != 0) return -r;
  if (D <= 64)
    return launch_t<64>(tq, tk, tv, out, B, Hq, Hkv, Sq, Sk, D, scale,
                        causal, window, s);
  if (D <= 128)
    return launch_t<128>(tq, tk, tv, out, B, Hq, Hkv, Sq, Sk, D, scale,
                         causal, window, s);
  if (D <= 192)
    return launch_t<192>(tq, tk, tv, out, B, Hq, Hkv, Sq, Sk, D, scale,
                         causal, window, s);
  return launch_t<256>(tq, tk, tv, out, B, Hq, Hkv, Sq, Sk, D, scale,
                       causal, window, s);
}

// Dynamic shared memory of one CTA at head dim D (for the report).
extern "C" int flash_attention_sm90_smem_bytes(int D) {
  if (D <= 64) return Layout<64>::BYTES;
  if (D <= 128) return Layout<128>::BYTES;
  if (D <= 192) return Layout<192>::BYTES;
  return Layout<256>::BYTES;
}
