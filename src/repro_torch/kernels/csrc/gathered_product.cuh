// The gathered product of the level megasteps on Hopper (sm_90a), on the
// TF32 tensor cores with the 3xTF32 split: the one copy that the forward
// megasteps (K1, treelstm_megastep_sm90.cu; K3, K4 and K5,
// cell_megastep_sm90.cu), the fused LSTM level step (K9, the same file)
// and the reverse megastep's pass (a) (K2, bwd_megastep_sm90.cu) run.
//
// `Product` forms X . W for a tile of BM = 64 slots x BJ columns of NQ
// weight lanes over a range of the depth's chunks, X rows gathered by the
// slots' child ids:
//   - staging: the gathered rows and the weight's BK-deep tiles are copied
//     by cp.async, 16 bytes a thread (4 where H, a base or a stride is no
//     multiple of 16 bytes), into a ring of NSTAGE chunk stages, so two
//     chunks are in flight while one is multiplied; columns and depth past
//     H are zero-filled, so any H takes it;
//   - fragments: the A operand by ldmatrix from raw f32 rows padded to
//     BK + 4 words; the weight's, read along its rows, by scalar loads
//     (rows padded to BJ + 8 words: the (t, g) pattern hits 32 banks);
//   - precision: every operand x is split in registers into x_big =
//     cvt.rna.tf32(x) and x_small = tf32(x - x_big), and each k-step of 8
//     runs as small.big + big.small + big.big, three TF32
//     mma.sync.m16n8k8 into an fp32 accumulator: about 21 bits of each
//     operand, which holds the fp32 bar of 1e-4 (one TF32 product keeps
//     11 bits and misses it).  A chunk's k-steps accumulate from zero and
//     the chunk's sum is added to the running one by a rounded fp32 add:
//     the tensor core cuts the fp32 sums it accumulates, so one chain of
//     every k-step of a deep product (Tree-FC's depth of 1,024 is 384
//     mma a sum) drifts by as many cuts;
//   - bf16 operand rows (TX = uint16_t, a bf16 value's bits; K9's bf16
//     state): cp.async cannot widen, so the raw bf16 rows are staged (16
//     bytes a thread where it can, else by plain 2-byte loads and stores,
//     cp.async having no 2-byte copy) into rows of BK + 8 halfwords, and
//     each fragment element is widened at its load by a shift.  A bf16
//     value is exact in TF32 (8 bits of mantissa against 10), so its
//     small part is zero and a k-step runs two products, big.small +
//     big.big: the bits the three would give.  Staging raw rows keeps the
//     copies asynchronous and halves their bytes; widening while staging
//     would need plain loads through registers on every chunk;
//   - the depth split: the host splits the depth over a thread-block
//     cluster of s = 1, 2, 4 or 8 CTAs (level_megastep.py `k2_split`);
//     rank r runs chunks [r n / s, (r + 1) n / s).  After its loop each
//     rank stores its partial tile in its own shared memory (`store`);
//     after cluster.sync() the ranks' partials of an element are added in
//     rank order through distributed shared memory (`value`, every rank's
//     load in flight before the first add).  No float atomics: two
//     launches give the same bits.
// A CTA of NT threads is NT / 32 warps, each 16 * MB slots x BJ / 2
// columns; a warp skips the mma of a 16-row block that holds no live slot.
//
// Shapes are the caller's: NX gathered operands a chunk and NQ lanes.
// With PER < 0 one operand feeds every lane (an LSTM or GRU cell, NX 1);
// with PER >= 0 each operand feeds lane PER on its own and their sum, in
// operand order, feeds the other lanes (an N-ary child-sum Tree-LSTM of
// arity NX, whose f lane PER = 1 takes each child's h).  A depth of
// several segments (a Tree-FC cell's one per child) is cut into chunks
// segment by segment.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int BM = 64;          // slots a tile
constexpr int BK = 32;          // depth of a staged chunk
constexpr int NSTAGE = 3;       // chunks in the ring
constexpr int MAX_SPLIT = 8;    // the portable cluster size
constexpr int MAX_A = 4;        // largest arity taken
constexpr int LDA = BK + 4;     // floats a staged A row (4 mod 32)

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

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

// Four 8x4 blocks of 32-bit values (8x8 of b16) from shared memory.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// x = big + small as TF32 operands (flash_attention_tf32.cu): big is
// cvt.rna.tf32.f32(x) as two integer instructions; small = x - big is
// exact in f32, rounded by the same add (the mma ignores an operand's 13
// low bits).
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

// The three TF32 products of one k-step: small.big, big.small, big.big.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ag)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bg)[2],
                                     const uint32_t (&bs)[2]) {
  mma(c, as, bg[0], bg[1]);
  mma(c, ag, bs[0], bs[1]);
  mma(c, ag, bg[0], bg[1]);
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&g)[4],
                                       uint32_t (&s)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], g[e], s[e]);
}

// A shared-memory address of this CTA as the same address in CTA `rank`
// of the cluster, and a load from such an address.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// Rows [0, rows) of a tile of COLS elements of T a row into `dst` (LD
// elements a row): columns [c, c + 16 / sizeof(T)) (or element c) of row
// r from ptr(r, c) (nullptr: zeros), columns at and past `cvalid`
// zero-filled.  `fallback` is a readable address for the copies that read
// nothing.  T is float, or uint16_t for a bf16 value's bits: cp.async has
// no 2-byte copy, so a narrow bf16 tile is staged by plain loads and
// stores, which the CTA sees after its next barrier as it sees a landed
// copy.
template <int NT, int COLS, int LD, typename T, typename F>
__device__ __forceinline__ void stage(T* dst, int rows, int cvalid,
                                      bool wide, const T* fallback, F ptr) {
  constexpr int E = sizeof(T);
  const uint32_t base = smem_addr(dst);
  if (wide) {
    constexpr int V = 16 / E, CPR = COLS / V;
    for (int i = threadIdx.x; i < rows * CPR; i += NT) {
      const int r = i / CPR, c = V * (i - r * CPR);
      const T* p = c < cvalid ? ptr(r, c) : nullptr;
      cp16(base + E * (r * LD + c), p ? p : fallback, p != nullptr);
    }
  } else if constexpr (E == 4) {
    for (int i = threadIdx.x; i < rows * COLS; i += NT) {
      const int r = i / COLS, c = i - r * COLS;
      const T* p = c < cvalid ? ptr(r, c) : nullptr;
      cp4(base + 4 * (r * LD + c), p ? p : fallback, p != nullptr);
    }
  } else {
    for (int i = threadIdx.x; i < rows * COLS; i += NT) {
      const int r = i / COLS, c = i - r * COLS;
      const T* p = c < cvalid ? ptr(r, c) : nullptr;
      dst[r * LD + c] = p ? *p : T(0);
    }
  }
}

// The addresses of a partial tile `P` in each rank of a cluster of s
// (rank 0's past s, never read).
__device__ __forceinline__ void rank_bases(const float* P, int s,
                                           uint32_t (&pb)[MAX_SPLIT]) {
#pragma unroll
  for (int r = 0; r < MAX_SPLIT; ++r) pb[r] = map_rank(P, r < s ? r : 0);
}

// The sum over the cluster's s ranks, in rank order, of the float at
// `off` bytes into each rank's partial tile (`pb`: its address in each
// rank); every load is issued before the first add.
__device__ __forceinline__ float rank_sum(const uint32_t (&pb)[MAX_SPLIT],
                                          uint32_t off, int s) {
  float v[MAX_SPLIT];
#pragma unroll
  for (int r = 0; r < MAX_SPLIT; ++r)
    v[r] = r < s ? ld_cluster(pb[r] + off) : 0.0f;
  float sum = v[0];
#pragma unroll
  for (int r = 1; r < MAX_SPLIT; ++r)
    if (r < s) sum += v[r];
  return sum;
}

// One level's schedule and inputs, as both megasteps read them: slots
// [0, M) with A children each (absent ones at row `sentinel`), a child
// other than the sentinel only in slots [0, live).
struct Level {
  const int* cid;
  const int* eid;
  const float* nm;
  const float* buf;
  const float* ext;
  const float* w;
  const float* bias;
  int M, A, H, offset, sentinel, live, wide;
  long long buf_stride, ext_stride;
};

// A forward megastep's launch (K1, K3-K5): the level, the buffer it
// writes in place and where each slot's row goes.
struct FwdLevel : Level {
  float* out;                   // the buffer itself, written in place
  const int* out_ids;           // [M] destination rows, or nullptr
  int rows;                     // rows of the buffer
  int split;                    // CTAs of a cluster splitting the depth
};

// Where slot gm's row is stored, or nullptr where it is stored nowhere:
// row out_ids[gm] where the caller gave destinations (the continuous
// frontier; an id outside [0, rows) is a pad lane and is dropped, as K6b
// drops it), else row offset + gm (the level's block).  Every store path
// of K1 and K3-K5 goes through it.
__device__ __forceinline__ float* dest_row(const FwdLevel& a, int gm) {
  long long r = a.offset + gm;
  if (a.out_ids != nullptr) {
    r = a.out_ids[gm];
    if (r < 0 || r >= a.rows) return nullptr;
  }
  return a.out + r * a.buf_stride;
}

// Loads the tile's child rows (-1 for the sentinel or a slot at or past
// `live`), node mask and ext rows (of slots below `live`); returns whether
// a slot of the tile has a child other than the sentinel.  Every thread of
// the CTA must call it; every rank of a cluster gets the same answer.
template <int NT>
__device__ __forceinline__ int load_ids(int (*cid_s)[BM], float* nm_s,
                                        int* eid_s, const Level& a, int m0) {
  for (int i = threadIdx.x; i < BM * a.A; i += NT) {
    const int m = i / a.A, x = i - m * a.A, gm = m0 + m;
    const int row = gm < a.live ? a.cid[(size_t)gm * a.A + x] : a.sentinel;
    cid_s[x][m] = row == a.sentinel ? -1 : row;
  }
  for (int i = threadIdx.x; i < BM; i += NT) {
    nm_s[i] = m0 + i < a.M ? a.nm[m0 + i] : 0.0f;
    eid_s[i] = m0 + i < a.live ? a.eid[m0 + i] : 0;
  }
  __syncthreads();
  int kid = 0;
  if (threadIdx.x < BM)
    for (int x = 0; x < a.A; ++x) kid |= cid_s[x][threadIdx.x] >= 0;
  return __syncthreads_or(kid);
}

// X . W over chunks [c_lo, c_hi) for a tile of BM slots x BJ columns, in
// a CTA of NT threads (see the head of this file for NX, NQ and PER), X's
// rows of TX (float, or uint16_t: bf16 bits).  acc[q] holds lane q's sums
// (PER < 0), or the operands' sum against lane q (q < PER) or q + 1 (q >=
// PER, up to NQ - 2) and operand x against lane PER at acc[NQ - 1 + x].
template <int NT, int NX, int NQ, int PER, int BJ, typename TX = float>
struct Product {
  static_assert(PER >= 0 || NX == 1, "one operand feeds every lane");
  static_assert(sizeof(TX) == 4 || PER < 0, "bf16 rows: one operand");
  static constexpr bool BF16 = sizeof(TX) == 2;
  static constexpr int MB = BM / 16 / (NT / 64);   // 16-row blocks a warp
  static constexpr int JB = BJ / 16;               // n8 blocks a warp, a lane
  static constexpr int NACC = PER >= 0 ? NQ - 1 + NX : NQ;
  static constexpr int LDW = BJ + 8;               // 8 mod 32
  // Elements of a staged X row: f32 rows padded to 4 mod 32 words for
  // ldmatrix; bf16 rows to 20 words (16-byte copies, and the eight rows
  // of a fragment's scalar loads on distinct banks).
  static constexpr int LDX = BF16 ? BK + 8 : LDA;
  static constexpr int XF = NX * BM * LDX * (int)sizeof(TX) / 4;  // floats
  static constexpr int STAGE = XF + NQ * BK * LDW;                // floats
  static constexpr int RING = NSTAGE * STAGE;
  static constexpr int LDP = NACC * BJ + 4;        // a partial tile's row
  static constexpr int P = BM * LDP;               // floats of the tile

  float acc[NACC][MB][JB][4];

  __device__ __forceinline__ static void zero(float (&a)[NACC][MB][JB][4]) {
#pragma unroll
    for (int q = 0; q < NACC; ++q)
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int jb = 0; jb < JB; ++jb)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[q][mb][jb][e] = 0.0f;
  }

  // The loop.  `smem`: the ring (RING floats).  The depth is cut into
  // segments of H, each into `cps` chunks of BK.  `ncols`: the tile's
  // columns that exist (past them, zeros).  `nlive`: tile rows at and
  // past it hold no live slot.  xrow(x, seg, r): operand x's row for
  // tile row r in segment seg, at depth 0 (nullptr: zeros); wlane(q,
  // seg): lane q's weight in segment seg at depth row 0 and the tile's
  // first column, `wstride` floats a depth row.  `xfb`, `wfb`: readable
  // addresses for the copies that read nothing.  Returns with no copy in
  // flight and every warp past its last read of the ring.
  template <typename XR, typename WL>
  __device__ __forceinline__ void run(float* smem, int c_lo, int c_hi,
                                      int cps, int H, int ncols, int nlive,
                                      bool wide,
                                      const TX* xfb, const float* wfb,
                                      XR xrow, WL wlane, long long wstride) {
    auto issue = [&](int c) {
      if (c < c_hi) {
        const int seg = c / cps, k0 = (c - seg * cps) * BK;
        float* sxf = smem + ((c - c_lo) % NSTAGE) * STAGE;
        TX* sx = reinterpret_cast<TX*>(sxf);
        float* sw = sxf + XF;
#pragma unroll
        for (int x = 0; x < NX; ++x)
          stage<NT, BK, LDX>(sx + x * BM * LDX, BM, H - k0, wide, xfb,
                             [&](int r, int cc) -> const TX* {
                               const TX* p = xrow(x, seg, r);
                               return p ? p + k0 + cc : nullptr;
                             });
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float* wq = wlane(q, seg);
          stage<NT, BJ, LDW>(sw + q * BK * LDW, BK, ncols, wide, wfb,
                             [&](int r, int cc) -> const float* {
                               return k0 + r < H
                                   ? wq + (size_t)(k0 + r) * wstride + cc
                                   : nullptr;
                             });
        }
      }
      cp_commit();
    };

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gq = lane >> 2, t = lane & 3;
    const int rw0 = 16 * MB * (warp >> 1);
    const int jw0 = (warp & 1) * (BJ / 2);
    // ldmatrix: rows (lane & 7) + 8 ((lane >> 3) & 1) at column
    // 4 (lane >> 4) give a0..a3 of a 16-row block.
    const int aoff =
        ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDA + 4 * (lane >> 4);

    zero(acc);
    issue(c_lo);
    issue(c_lo + 1);
    for (int c = c_lo; c < c_hi; ++c) {
      float part[NACC][MB][JB][4];          // the chunk's sums (see head)
      zero(part);
      cp_wait<NSTAGE - 2>();               // chunk c has landed
      __syncthreads();                     // and every warp is done with c - 1
      issue(c + 2);
      const float* sx = smem + ((c - c_lo) % NSTAGE) * STAGE;
      const float* sw = sx + XF;
      const uint32_t xaddr = smem_addr(sx) + 4 * aoff;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t bg[NQ][JB][2], bs[NQ][JB][2];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int jb = 0; jb < JB; ++jb) {
            const float* p = sw + q * BK * LDW + (kk + t) * LDW + jw0 +
                             8 * jb + gq;
            split(p[0], bg[q][jb][0], bs[q][jb][0]);
            split(p[4 * LDW], bg[q][jb][1], bs[q][jb][1]);
          }
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          if (rw0 + 16 * mb >= nlive) continue;   // rows of no slot
          const uint32_t ra = xaddr + 4 * ((rw0 + 16 * mb) * LDA + kk);
          if constexpr (BF16) {
            // a0..a3 of the block: rows gq, gq + 8 at columns t, t + 4,
            // each bf16 widened by a shift: a TF32 value with no small
            // part, so big.small + big.big.
            const uint16_t* xa = reinterpret_cast<const uint16_t*>(sx) +
                                 (rw0 + 16 * mb + gq) * LDX + kk + t;
            const uint32_t ag[4] = {
                (uint32_t)xa[0] << 16, (uint32_t)xa[8 * LDX] << 16,
                (uint32_t)xa[4] << 16, (uint32_t)xa[8 * LDX + 4] << 16};
#pragma unroll
            for (int q = 0; q < NQ; ++q)
#pragma unroll
              for (int jb = 0; jb < JB; ++jb) {
                mma(part[q][mb][jb], ag, bs[q][jb][0], bs[q][jb][1]);
                mma(part[q][mb][jb], ag, bg[q][jb][0], bg[q][jb][1]);
              }
          } else if constexpr (PER >= 0) {
            // Each operand feeds lane PER; their sum, in operand order,
            // the other lanes.
            float hs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int x = 0; x < NX; ++x) {
              uint32_t r[4], ag[4], as[4];
              ldsm_x4(ra + 4 * x * BM * LDA, r);
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                v[e] = __uint_as_float(r[e]);
                hs[e] = x == 0 ? v[e] : hs[e] + v[e];
              }
              split4(v, ag, as);
#pragma unroll
              for (int jb = 0; jb < JB; ++jb)
                mma3(part[NQ - 1 + x][mb][jb], ag, as, bg[PER][jb],
                     bs[PER][jb]);
            }
            uint32_t hg[4], hsm[4];
            split4(hs, hg, hsm);
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              if (q == PER) continue;
#pragma unroll
              for (int jb = 0; jb < JB; ++jb)
                mma3(part[q < PER ? q : q - 1][mb][jb], hg, hsm, bg[q][jb],
                     bs[q][jb]);
            }
          } else {
            uint32_t r[4], ag[4], as[4];
            ldsm_x4(ra, r);
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(r[e]);
            split4(v, ag, as);
#pragma unroll
            for (int q = 0; q < NQ; ++q)
#pragma unroll
              for (int jb = 0; jb < JB; ++jb)
                mma3(part[q][mb][jb], ag, as, bg[q][jb], bs[q][jb]);
          }
        }
      }
    #pragma unroll
      for (int q = 0; q < NACC; ++q)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int jb = 0; jb < JB; ++jb)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][mb][jb][e] += part[q][mb][jb][e];
    }
    cp_wait<0>();                          // no copy outlives the loop
    __syncthreads();
  }

  // This rank's partial tile, lane-major columns: P[row][q * BJ + jj].
  __device__ __forceinline__ void store(float* P) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gq = lane >> 2, t = lane & 3;
    const int rw0 = 16 * MB * (warp >> 1);
    const int jw0 = (warp & 1) * (BJ / 2);
#pragma unroll
    for (int q = 0; q < NACC; ++q)
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int jb = 0; jb < JB; ++jb) {
          const int row = rw0 + 16 * mb + gq;
          const int col = q * BJ + jw0 + 8 * jb + 2 * t;
          *reinterpret_cast<float2*>(P + row * LDP + col) =
              make_float2(acc[q][mb][jb][0], acc[q][mb][jb][1]);
          *reinterpret_cast<float2*>(P + (row + 8) * LDP + col) =
              make_float2(acc[q][mb][jb][2], acc[q][mb][jb][3]);
        }
  }

  // Accumulator q of tile row `row`, column jj, summed over the s ranks
  // in rank order (after cluster.sync(); `pb` from rank_bases).
  __device__ __forceinline__ static float value(
      const uint32_t (&pb)[MAX_SPLIT], int row, int q, int jj, int s) {
    return rank_sum(pb, 4 * (row * LDP + q * BJ + jj), s);
  }
};

template <typename K, typename A>
cudaError_t launch_cluster(K kern, dim3 grid, int threads, int cluster_x,
                           int smem, const A& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
