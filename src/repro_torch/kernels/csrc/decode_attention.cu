// Single-token decode attention over a KV cache (split-KV flash-decode)
// for Hopper (sm_90a), f32 or bf16 operands, fp32 accumulation.
//
// Replaces the TPU kernel of src/repro/kernels/decode_attention.py:
//   K11 `decode_attention` (:70, its pallas_call at :108).
// It computes what src/repro_torch/kernels/ref.py `decode_attention`
// computes:
//
//   q [B, Hq, D], cache k/v [B, Hkv, S, D], kv_len [B] int32 -> o [B, Hq, D]
//   o[b, h] = softmax_r(scale * q[b, h] . k[b, h / G, r]) v[b, h / G, r]
//
// over the cache rows lo <= r < min(kv_len[b], S), lo = max(0, kv_len[b] -
// window) under a window (`window` > 0) and 0 without.  G = Hq / Hkv query
// heads share one KV head (GQA).  kv_len stays on the card (the engine's
// per-slot fill levels), so a launch never waits for the host.  A sequence
// with no valid row gets a zero row.  The output is at q's type; q and
// the cache are read through their strides (unit stride along D).
//
// Bound on an H100 SXM: bytes.  A cache row of one KV head is 4D bytes of
// K and V at bf16 and carries 4GD FLOPs (QK and PV for G heads): G FLOPs a
// byte.  A granite-3-8b decode layer (8 slots, Hkv 8, D 128) reads 4 KB a
// filled row a slot: 10.5 MB at 320 rows, 3.1 us at 3.35 TB/s.  Below the
// fp32 ridge on paper (67 TFLOP/s / 3.35 TB/s = 20 FLOPs a byte), but on
// the CUDA cores each FMA brings a bf16 unpack, a shared-memory load and a
// share of the shuffles and barriers, and a CTA's tile of fp32 FMAs took
// longer than its bytes (PERF.md, PR 23): the bf16 route takes QK and PV
// to the tensor cores (below), at about fp32 precision.
//
// Design.
// - Split-KV over a thread-block cluster.  The grid is (B, Hkv, ngc * NS)
//   with cluster dims (1, 1, NS), NS <= 8 (the portable cluster size).  A
//   cluster owns one (slot, KV head) and GC of its query heads (a larger
//   group is split over ngc = ceil(G / GC) clusters), so every K/V row is
//   read once for the whole group.  NS is chosen on the host from the
//   static shape (decode_split.py `split_count`), the most splits that
//   keep every CTA resident at once: granite's 64 (slot, KV head) pairs
//   take NS 4, 256 CTAs on 132 SMs (NS 8's second wave of CTAs measured
//   slower).  Each CTA reads kv_len[b] itself and takes an equal share
//   of [lo, len): c = ceil((len - lo) / NS) rounded up to 8 rows, rank r
//   the rows [lo + r c, lo + (r + 1) c) cut at len (decode_split.py
//   `row_range` and `split_rows`, mirrored in `row_share` below), so the
//   work balances within each slot whatever S is.  A CTA with an empty
//   share keeps an empty partial (m = -inf, l = 0).
// - Bytes in flight.  A CTA stages K and V in shared memory in tiles of
//   TR rows (16 KB each: 64 rows at bf16 D 128), through a two-stage ring
//   of cp.async copies, 16 bytes a thread: tiles t and t + 1 are in
//   flight while tile t is consumed.  K's tile and V's tile are separate
//   cp.async groups, so the scores start once K has landed.  Each smem
//   row is padded to an odd number of 16-byte units, so 16-byte reads
//   (and ldmatrix) of eight rows at one column hit eight bank groups.
//   Rows or bases that are not 16-byte aligned (a view whose row stride
//   is no multiple of 16 B) are staged by plain element loads in the same
//   kernel; a head dim whose rows are no multiple of 16 B reads its tiles
//   element by element (the DV = false instantiations).
// - Compute on the tile.  bf16 with D % 16 == 0 (MMA): the scores
//   S = K q^T by mma.sync m16n8k16 (K by ldmatrix, q as B: bf16 holds q
//   exactly; fp32 accumulation), warp w taking rows [16 w, 16 w + 16) for
//   8 heads; PV as O^T += V^T P (V^T by transposing ldmatrix, P split
//   into bf16 P_hi + P_lo, about fp32, as K10's PV), warp w owning the
//   column blocks w and w + 8.  Otherwise (f32, narrow rows) on the CUDA
//   cores: a thread a (row, head) pair for the scores, a full fp32 dot
//   product over D from shared memory; a thread CW columns (8 bytes of a
//   V row) of all GC heads and one of RG row groups for PV, the groups
//   summed in order at the end.  Online softmax once a tile a head: warp
//   h takes head h, the tile's max and sum by warp reductions, and the
//   rescale factor alpha.
// - Combine in the same launch, in a fixed order.  Each CTA leaves
//   (m, l, acc[GC][D]) in its own shared memory; cluster.sync(); rank r
//   combines the columns [r ceil(D / NS), (r + 1) ceil(D / NS)) of every
//   head, reading the NS partials through distributed shared memory in
//   rank order 0..NS-1:
//     m = max_i m_i,  l = sum_i l_i e^(m_i - m),
//     o = sum_i acc_i e^(m_i - m) / l,
//   zeros where l = 0; a second cluster.sync() before exit.  One launch a
//   call, no float atomics, no global workspace: bitwise repeatable.
// D lives in shared memory, not in a lane's registers, so the layout does
// not preclude wider heads (MLA's 576); the wrapper takes D <= 256 today.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;            // threads a CTA
constexpr int NW = NT / 32;        // warps a CTA (>= GC: warp h owns head h)
constexpr int MAX_SPLITS = 8;      // the portable cluster size
constexpr int MAX_TR = 64;         // tile rows (the softmax takes 2 a lane)
constexpr int TILE_BYTES = 16384;  // target bytes of one K (or V) tile
constexpr int NSTAGE = 2;          // tiles of K and V in flight a CTA
constexpr unsigned FULL = 0xffffffffu;
static_assert(NW >= 8, "warp h owns head h of up to 8 a CTA");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The query heads a cluster serves (mirrored by decode_split.py
// `heads_per_cta`).
__host__ __device__ constexpr int heads_per_cta(int G) {
  return G == 1 ? 1 : (G <= 4 ? 4 : 8);
}

// Shared-memory layout of one CTA, in bytes (16-byte aligned regions):
//   ring   [NSTAGE][K, V][tr][ldb]    (after the loop: the row groups'
//                                      acc [rg][GC][D], then the CTA's acc
//                                      [GC][D], all f32)
//   q      [8][ldq] f32               (unscaled; zero rows past ng)
//   p      [tr][GC] f32               (scores, then probabilities)
//   state  m[GC], l[GC], alpha[GC] f32
struct Layout {
  int ldb;       // bytes a staged row
  int ldq;       // floats a q row (= 8 mod 32: conflict-free reads)
  int tr;        // rows a tile: 16, 32 or 64
  int cw;        // V columns a PV thread
  int ncc;       // column chunks (D / cw)
  int rg;        // row groups of the PV phase
  int ring;      // bytes of the ring region
  int qoff, poff, soff, total;
};

constexpr int QR = 8;  // q rows staged (the n of the score mma)

__host__ __device__ inline int up16(int x) { return (x + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(int D, int E, int GC, bool dv) {
  Layout L;
  const int unit = dv ? 16 : 4;
  L.ldb = (((D * E + unit - 1) / unit) | 1) * unit;
  L.ldq = (D + 23) / 32 * 32 + 8;
  L.tr = MAX_TR;
  while (L.tr > 16 && L.tr * D * E > TILE_BYTES) L.tr /= 2;
  L.cw = dv ? 8 / E : 1;
  L.ncc = D / L.cw;
  L.rg = NT / L.ncc;
  const int ring = 2 * NSTAGE * L.tr * L.ldb;
  const int fin = (L.rg + 1) * GC * D * 4;
  L.ring = up16(ring > fin ? ring : fin);
  L.qoff = L.ring;
  L.poff = L.qoff + up16(QR * L.ldq * 4);
  L.soff = L.poff + up16(L.tr * GC * 4);
  L.total = L.soff + up16(3 * GC * 4);
  return L;
}

// Rank `rank`'s rows [r0, r1) of the valid rows [lo, hi) of a slot split
// NS ways (decode_split.py `row_range` and `split_rows`).
struct Share {
  long long r0, r1;
};
__device__ __forceinline__ Share row_share(long long kvl, int S, int window,
                                           int ns, int rank) {
  const long long lo = window > 0 ? max(0LL, kvl - window) : 0LL;
  const long long hi = max(lo, min(kvl, (long long)S));
  const long long c = ((hi - lo + ns - 1) / ns + 7) / 8 * 8;
  Share s;
  s.r0 = min(lo + rank * c, hi);
  s.r1 = min(s.r0 + c, hi);
  return s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [0, nr) of a strided [.., D] block into `dst` (row stride
// ldb bytes): cp.async of 16 bytes a thread where `wide`, else plain
// element loads.
template <typename T, bool DV>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const T* src,
                                           long long stride, int nr, int D,
                                           int ldb, bool wide) {
  if (DV && wide) {
    const int cpr = D * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < nr * cpr; i += NT) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async16(dst + r * ldb + c * 16,
                 reinterpret_cast<const unsigned char*>(src + r * stride) +
                     c * 16);
    }
  } else {
    for (int i = threadIdx.x; i < nr * D; i += NT) {
      const int r = i / D, d = i - r * D;
      reinterpret_cast<T*>(dst + r * ldb)[d] = src[r * stride + d];
    }
  }
}

// The values of a 16-byte chunk of a staged row as floats.
__device__ __forceinline__ void unpack16(const uint4 w, float* f,
                                         __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(u[j] << 16);
    f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4 w, float* f, float) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

// q . k over D in fp32 FMAs: k a staged row of T, q an f32 row.
template <typename T, bool DV>
__device__ __forceinline__ float dot_row(const unsigned char* k,
                                         const float* q, int D) {
  if constexpr (DV) {
    constexpr int V = 16 / sizeof(T);  // values a chunk
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < D / V; ++c) {
      float kf[V];
      unpack16(reinterpret_cast<const uint4*>(k)[c], kf, T());
#pragma unroll
      for (int e = 0; e < V / 4; ++e) {
        const float4 qq = reinterpret_cast<const float4*>(q + c * V)[e];
        a[0] = fmaf(qq.x, kf[4 * e], a[0]);
        a[1] = fmaf(qq.y, kf[4 * e + 1], a[1]);
        a[2] = fmaf(qq.z, kf[4 * e + 2], a[2]);
        a[3] = fmaf(qq.w, kf[4 * e + 3], a[3]);
      }
    }
    return (a[0] + a[1]) + (a[2] + a[3]);
  } else {
    const T* kt = reinterpret_cast<const T*>(k);
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(q[d], to_f(kt[d]), s);
    return s;
  }
}

// The four 8x8 bf16 blocks of a 16x16 A fragment from shared memory.
__device__ __forceinline__ void ldmatrix_x4(const void* p, uint32_t* a) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// The same ldmatrix with each 8x8 block transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(const void* p, uint32_t* a) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// A shared-memory address of this CTA as the same address in CTA `rank`
// of the cluster, and a load from such an address.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(s), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// CW values of a staged V row from column c0 (8 bytes where DV).
template <typename T, bool DV, int CW>
__device__ __forceinline__ void load_v(const unsigned char* row, int c0,
                                       float* out) {
  const T* t = reinterpret_cast<const T*>(row) + c0;
  if constexpr (DV) {
    const uint2 w = *reinterpret_cast<const uint2*>(t);
    if constexpr (sizeof(T) == 2) {
      out[0] = __uint_as_float(w.x << 16);
      out[1] = __uint_as_float(w.x & 0xffff0000u);
      out[2] = __uint_as_float(w.y << 16);
      out[3] = __uint_as_float(w.y & 0xffff0000u);
    } else {
      out[0] = __uint_as_float(w.x);
      out[1] = __uint_as_float(w.y);
    }
  } else {
    out[0] = to_f(t[0]);
  }
}

struct Args {
  void* out;
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  int Hq, Hkv, S, D, ns, window, wide;
  long long qsb, qsh, ksb, ksh, kss, vsb, vsh, vss;
  float scale;
};

// GC: query heads a cluster; DV: D * sizeof(T) a multiple of 16 (16-byte
// staging and reads); MMA: bf16 with D a multiple of 16 (QK^T and PV on
// the tensor cores).
template <typename T, int GC, bool DV, bool MMA>
__global__ void __launch_bounds__(NT, MMA ? 3 : 2)
    decode_attention_kernel(Args a) {
  constexpr int E = sizeof(T);
  constexpr int CW = DV ? 8 / E : 1;
  static_assert(!MMA || (DV && E == 2), "the score mma takes bf16 rows");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int D = a.D, ns = a.ns;
  const Layout L = layout(D, E, GC, DV);
  const int ldb = L.ldb, ldq = L.ldq, tr = L.tr;
  const int tile = tr * ldb;
  float* qs = reinterpret_cast<float*>(smem + L.qoff);
  float* ps = reinterpret_cast<float*>(smem + L.poff);
  float* sm = reinterpret_cast<float*>(smem + L.soff);  // running max
  float* sl = sm + GC;                                    // running sum
  float* sa = sl + GC;                                    // this tile's alpha

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int G = a.Hq / a.Hkv;
  const int g0 = (blockIdx.z / ns) * GC;
  const int ng = min(GC, G - g0);
  const int h0 = hk * G + g0;  // the cluster's first query head

  // q's loads go out first; they land in shared memory after the copies
  // are issued.
  constexpr int QPT = QR * 256 / NT;  // q values a thread (D <= 256)
  const T* qg = static_cast<const T*>(a.q) + b * a.qsb;
  float qv[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int i = tid + j * NT, h = i / D, d = i - h * D;
    qv[j] = i < QR * D && h < ng ? to_f(qg[(long long)(h0 + h) * a.qsh + d])
                                 : 0.f;
  }

  const Share sh = row_share(a.kv_len[b], a.S, a.window, ns, rank);
  const int rows = (int)(sh.r1 - sh.r0);
  const int nt = (rows + tr - 1) / tr;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh +
                sh.r0 * a.kss;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh +
                sh.r0 * a.vss;
  const bool wide = a.wide != 0;

  // Tile t's K (or V) into stage t % NSTAGE: one cp.async group each,
  // committed (empty) past the last tile, so the group count stays fixed.
  auto issue = [&](int t, int which) {
    unsigned char* dst = smem + (2 * (t % NSTAGE) + which) * tile;
    const int nr = t < nt ? min(tr, rows - t * tr) : 0;
    const long long st = which ? a.vss : a.kss;
    stage_rows<T, DV>(dst, (which ? vb : kb) + t * tr * st, st, nr, D, ldb,
                      wide);
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < NSTAGE; ++t) {
    issue(t, 0);
    issue(t, 1);
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int i = tid + j * NT, h = i / D, d = i - h * D;
    if (i < QR * D) qs[h * ldq + d] = qv[j];
  }
  if (tid < GC) {
    sm[tid] = -INFINITY;
    sl[tid] = 0.f;
  }

  const int cc = tid % L.ncc, rg = tid / L.ncc;
  float acc[GC][CW];
#pragma unroll
  for (int h = 0; h < GC; ++h)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[h][c] = 0.f;
  // MMA: warp w owns the column blocks w and w + 8 of O^T [D][8 heads].
  constexpr int MB = 2;  // D <= 256: 16 blocks of 16 columns, 8 warps
  float oacc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[m][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int nr = min(tr, rows - t * tr);
    const unsigned char* ks = smem + 2 * (t % NSTAGE) * tile;
    const unsigned char* vs = ks + tile;
    cp_async_wait<2 * NSTAGE - 1>();  // this tile's K
    __syncthreads();
    if constexpr (MMA) {
      // Warp w: the scores of rows [16 w, 16 w + 16) for 8 heads (past GC
      // zero), S = K q^T: K from shared memory by ldmatrix, q^T as the
      // mma's B (bf16 holds q exactly), fp32 accumulation.
      if (warp * 16 < nr) {
        const int g = lane >> 2, t4 = lane & 3;
        const unsigned char* ar =
            ks + (warp * 16 + (lane & 15)) * ldb + (lane >> 4) * 16;
        const float* qn = qs + g * ldq + 2 * t4;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(ar + kk * 32, af);
          const float2 q0 = *reinterpret_cast<const float2*>(qn + kk * 16);
          const float2 q1 =
              *reinterpret_cast<const float2*>(qn + kk * 16 + 8);
          mma_bf16(c, af, bf16x2(q0.x, q0.y), bf16x2(q1.x, q1.y));
        }
        const int r0 = warp * 16 + g;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int h = 2 * t4 + e;
          if (h < GC) {
            if (r0 < nr) ps[r0 * GC + h] = c[e] * a.scale;
            if (r0 + 8 < nr) ps[(r0 + 8) * GC + h] = c[2 + e] * a.scale;
          }
        }
      }
    } else {
      for (int p = tid; p < nr * GC; p += NT) {
        const int r = p / GC, h = p - r * GC;
        ps[p] = dot_row<T, DV>(ks + r * ldb, qs + h * ldq, D) * a.scale;
      }
    }
    __syncthreads();
    if (warp < GC) {
      const int h = warp;
      const float s0 = lane < nr ? ps[lane * GC + h] : -INFINITY;
      const float s1 = lane + 32 < nr ? ps[(lane + 32) * GC + h] : -INFINITY;
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));
      const float mo = sm[h];
      const float mn = fmaxf(mo, mt);
      const float al = mo == -INFINITY ? 0.f : expf(mo - mn);
      const float p0 = lane < nr ? expf(s0 - mn) : 0.f;
      const float p1 = lane + 32 < nr ? expf(s1 - mn) : 0.f;
      if (lane < nr) ps[lane * GC + h] = p0;
      if (lane + 32 < nr) ps[(lane + 32) * GC + h] = p1;
      float su = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) su += __shfl_xor_sync(FULL, su, o);
      __syncwarp();
      if (lane == 0) {
        sm[h] = mn;
        sl[h] = sl[h] * al + su;
        sa[h] = al;
      }
    }
    cp_async_wait<2 * NSTAGE - 2>();  // this tile's V
    __syncthreads();
    if constexpr (MMA) {
      // O^T += V^T P over this tile: V^T by transposing ldmatrix (a row
      // past nr reads row 0, which P's zero cancels), P as the B operand
      // split into bf16 P_hi + P_lo (about fp32), fp32 accumulation.
      const int g = lane >> 2, t4 = lane & 3;
      const float al0 = 2 * t4 < GC ? sa[2 * t4] : 0.f;
      const float al1 = 2 * t4 + 1 < GC ? sa[2 * t4 + 1] : 0.f;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        oacc[m][0] *= al0;
        oacc[m][1] *= al1;
        oacc[m][2] *= al0;
        oacc[m][3] *= al1;
      }
      for (int k0 = 0; k0 < nr; k0 += 16) {
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = k0 + 2 * t4 + 8 * e;
          const float p0 = g < GC && r < nr ? ps[r * GC + g] : 0.f;
          const float p1 = g < GC && r + 1 < nr ? ps[(r + 1) * GC + g] : 0.f;
          bh[e] = bf16x2(p0, p1);
          const __nv_bfloat162 hi =
              *reinterpret_cast<const __nv_bfloat162*>(&bh[e]);
          bl[e] = bf16x2(p0 - __low2float(hi), p1 - __high2float(hi));
        }
        const int mi = lane >> 3;
        const int vr = k0 + (lane & 7) + (mi >> 1) * 8;
        const unsigned char* vrow = vs + (vr < nr ? vr : 0) * ldb;
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const int d0 = (warp + 8 * m) * 16;
          if (d0 < D) {
            uint32_t af[4];
            ldmatrix_x4_trans(vrow + (d0 + (mi & 1) * 8) * 2, af);
            mma_bf16(oacc[m], af, bh[0], bh[1]);
            mma_bf16(oacc[m], af, bl[0], bl[1]);
          }
        }
      }
    } else if (rg < L.rg) {
#pragma unroll
      for (int h = 0; h < GC; ++h) {
        const float al = sa[h];
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[h][c] *= al;
      }
      for (int r = rg; r < nr; r += L.rg) {
        float vv[CW], pr[GC];
        load_v<T, DV, CW>(vs + r * ldb, cc * CW, vv);
        if constexpr (GC % 4 == 0) {
#pragma unroll
          for (int h = 0; h < GC; h += 4) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(ps + r * GC + h);
            pr[h] = p4.x;
            pr[h + 1] = p4.y;
            pr[h + 2] = p4.z;
            pr[h + 3] = p4.w;
          }
        } else {
#pragma unroll
          for (int h = 0; h < GC; ++h) pr[h] = ps[r * GC + h];
        }
#pragma unroll
        for (int h = 0; h < GC; ++h)
#pragma unroll
          for (int c = 0; c < CW; ++c)
            acc[h][c] = fmaf(pr[h], vv[c], acc[h][c]);
      }
    }
    __syncthreads();  // stage t % NSTAGE and the probabilities are free
    issue(t + NSTAGE, 0);
    issue(t + NSTAGE, 1);
  }
  cp_async_wait<0>();
  __syncthreads();

  // The row groups' partials, then the CTA's acc in group order; both in
  // the ring, which is idle now.
  float* part = reinterpret_cast<float*>(smem);
  float* cacc = part + L.rg * GC * D;
  if constexpr (MMA) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const int d = (warp + 8 * m) * 16 + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 2 * t4 + (e & 1);
        if (d < D && h < GC) cacc[h * D + d + (e >> 1) * 8] = oacc[m][e];
      }
    }
  } else {
    if (rg < L.rg) {
#pragma unroll
      for (int h = 0; h < GC; ++h)
#pragma unroll
        for (int c = 0; c < CW; ++c)
          part[(rg * GC + h) * D + cc * CW + c] = acc[h][c];
    }
    __syncthreads();
    for (int i = tid; i < GC * D; i += NT) {
      float v = 0.f;
      for (int g = 0; g < L.rg; ++g) v += part[g * GC * D + i];
      cacc[i] = v;
    }
  }
  cluster.sync();

  // Rank `rank` combines its columns of every head over the NS partials,
  // in rank order.
  const int cwid = (D + ns - 1) / ns;
  const int d0 = rank * cwid;
  const int w = max(0, min(D, d0 + cwid) - d0);
  T* out = static_cast<T*>(a.out) + ((long long)b * a.Hq + h0) * D;
  uint32_t base[MAX_SPLITS];  // this CTA's smem in each rank
#pragma unroll
  for (int j = 0; j < MAX_SPLITS; ++j)
    base[j] = map_rank(smem, j < ns ? j : 0);
  const uint32_t moff = L.soff, loff = L.soff + 4 * GC;
  const uint32_t aoff = static_cast<uint32_t>(
      reinterpret_cast<unsigned char*>(cacc) - smem);
  for (int i = tid; i < ng * w; i += NT) {
    const int h = i / w, d = d0 + (i - h * w);
    float mj[MAX_SPLITS], lj[MAX_SPLITS], aj[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {  // every load in flight at once
      mj[j] = j < ns ? ld_cluster(base[j] + moff + 4 * h) : -INFINITY;
      lj[j] = j < ns ? ld_cluster(base[j] + loff + 4 * h) : 0.f;
      aj[j] = j < ns ? ld_cluster(base[j] + aoff + 4 * (h * D + d)) : 0.f;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) mx = fmaxf(mx, mj[j]);
    float lt = 0.f, at = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int j = 0; j < MAX_SPLITS; ++j) {
        if (mj[j] == -INFINITY) continue;
        const float e = expf(mj[j] - mx);
        lt = fmaf(lj[j], e, lt);
        at = fmaf(aj[j], e, at);
      }
    }
    out[h * D + d] = from_f<T>(lt > 0.f ? at / lt : 0.f);
  }
  cluster.sync();  // no CTA leaves while another reads its partials
}

template <typename T, int GC, bool DV, bool MMA>
int launch_t(const Args& a, int B, int ngc, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, GC, DV, MMA>;
  const Layout L = layout(a.D, (int)sizeof(T), GC, DV);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, a.Hkv, ngc * a.ns);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.ns;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int GC>
int launch_dv(const Args& a, int B, int ngc, cudaStream_t stream) {
  const int rb = a.D * (int)sizeof(T);
  if (rb % 16) return launch_t<T, GC, false, false>(a, B, ngc, stream);
  if (sizeof(T) == 2 && a.D % 16 == 0)
    return launch_t<T, GC, true, sizeof(T) == 2>(a, B, ngc, stream);
  return launch_t<T, GC, true, false>(a, B, ngc, stream);
}

template <typename T>
int launch_g(const Args& a, int B, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv, gc = heads_per_cta(G);
  const int ngc = (G + gc - 1) / gc;
  if ((long long)ngc * a.ns > 65535) return (int)cudaErrorInvalidValue;
  if (gc == 1) return launch_dv<T, 1>(a, B, ngc, stream);
  if (gc == 4) return launch_dv<T, 4>(a, B, ngc, stream);
  return launch_dv<T, 8>(a, B, ngc, stream);
}

// 16-byte staging needs 16-byte aligned bases and row, head and batch
// strides (those of dims longer than 1).
bool aligned16(const void* p, int E, const long long* st, const int* n) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && (st[i] * E) % 16) return false;
  return true;
}

}  // namespace

// Strides in elements: q (batch, head), k (batch, head, row), v (batch,
// head, row); unit stride along D.  kv_len: [B] int32 on the card.
// `window` <= 0: no window.  `ns`: CTAs a cluster splitting each slot's
// rows, 1..8 (decode_split.py `split_count`).  The output is a
// contiguous [B, Hq, D] tensor of q's type.
extern "C" int decode_attention_launch(
    void* out, const void* q, const void* k, const void* v,
    const void* kv_len, int B, int Hq, int Hkv, int S, int D, long long qsb,
    long long qsh, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int window,
    int ns, int bf16, void* stream) {
  if (B <= 0 || Hq <= 0 || D <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D > 256 || S < 0 || Hkv > 65535 ||
      ns < 1 || ns > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int E = bf16 ? 2 : 4;
  const int n[3] = {B, Hkv, S};
  const long long kst[3] = {ksb, ksh, kss}, vst[3] = {vsb, vsh, vss};
  Args a;
  a.out = out;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_len = static_cast<const int*>(kv_len);
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.D = D;
  a.ns = ns;
  a.window = window;
  a.wide = aligned16(k, E, kst, n) && aligned16(v, E, vst, n);
  a.qsb = qsb;
  a.qsh = qsh;
  a.ksb = ksb;
  a.ksh = ksh;
  a.kss = kss;
  a.vsb = vsb;
  a.vsh = vsh;
  a.vss = vss;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_g<__nv_bfloat16>(a, B, s) : launch_g<float>(a, B, s);
}

// The launch's plan for head dim D, group G and type (bf16 or f32):
// out[0..5] = heads a cluster, rows a tile, bytes a staged row, PV row
// groups (CUDA-core route), dynamic shared memory bytes a CTA, and the
// route: 2 tensor cores (bf16, D % 16 == 0), 1 CUDA cores on 16-byte
// rows, 0 CUDA cores on narrow rows.
extern "C" void decode_attention_plan(int D, int G, int bf16, int* out) {
  const int E = bf16 ? 2 : 4, gc = heads_per_cta(G);
  const bool dv = D * E % 16 == 0;
  const Layout L = layout(D, E, gc, dv);
  out[0] = gc;
  out[1] = L.tr;
  out[2] = L.ldb;
  out[3] = L.rg;
  out[4] = L.total;
  out[5] = dv ? (bf16 && D % 16 == 0 ? 2 : 1) : 0;
}
