// Flash equivariant cross attention: K6 (stats) and K7 (apply).
//
// Same functions as the TPU kernels se3et_tpu/ops/pallas/eq_attention.py
// eq_attention_stats (_stats_kernel) and eq_attention_apply (_apply_kernel).
// With s_aeh[n, m] = scale * q[a,h,n] . k[e,h,m] (float32 sums):
//   K6: rowmax/rowsum[a,e,h,n] of the key-masked s (masked s = -1e9, its
//       exp weighted by 0); per block of rows the partial sum over its rows
//       of positive(mean_h s) * qmask[n] * kmask[m], and with sup_q/sup_k
//       the partial max over valid (n, m) of mean_h s * sup_q[a,h] *
//       sup_k[e,h] (-1e9 if none).  The caller reduces the partials in a
//       fixed order.
//   K7: out[a,h,n] = sum_e w[a,e] / rowsum[a,e,h,n]
//                    * sum_m round_T(exp(s - rowmax) * kmask[m]) v[e,h,m]
//
// At the serving shape (A=E=6, H=4, N=M=1024, c=64, bf16) K6 is 19.3 GFLOP
// and 151 M exps on inputs of 6 MB; K7 twice the products.  The TPU grid
// walks e sequentially into a VMEM accumulator and carries the pooled sum
// across query blocks; blocks here carry no state, so K7 loops e inside the
// block and K6 writes per-block partials.
//
// Two implementations of each, chosen by shape (the wrapper's
// eq_attention_stats_form and eq_attention_apply_form name them):
// * bf16, H = 4, head width 64 (the serving path): the "tc" forms below,
//   K6 eq_stats_tc_kernel (TMA key tiles, mma.sync, base-2 softmax) and K7
//   eq_apply_tc_kernel (TMA key and value tiles of one head, wgmma for
//   q k^T and p v, base-2 exps);
// * float32, and head widths 16 and 32 in either type (32: the wide-head
//   family se3ete2): the CUDA-core kernels, one block per (a[, e], 8 query
//   rows), one warp per query row, one lane per key of a 32-key tile, key
//   rows read through L1 (the block's warps walk the same tile), the query
//   row as warp-wide broadcasts, K6's softmax statistics online (running
//   max and rescaled sum), K7's tile probabilities staged in shared memory
//   for a lane-per-value-pair p . v (below head width 64 the lanes from
//   HC / 2 on hold no pair).
#include <algorithm>
#include <type_traits>

#include <cuda.h>

#include "async_copy.cuh"
#include "attention_common.cuh"

namespace {

using namespace se3et;

constexpr int kWarps = 8;  // query rows per block
constexpr int kThreads = kWarps * 32;

// positive() modes, in the order of ops/kernels/eq_attention.POSITIVE_MODES
__device__ __forceinline__ float positive(float x, int mode) {
  switch (mode) {
    case 1: return x * x;                                      // sq
    case 2: return fabsf(x);                                   // abs
    case 3: return fmaxf(x, 0.f);                              // relu
    case 4: return 1.f / (1.f + expf(-x));                     // sigmoid
    case 5: return x >= 0.f ? x : 0.1f * x;                    // leakyrelu
    case 6: return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));    // softplus
    case 7: return (x + 1.f) * 0.5f;                           // minus
    default: return x;                                         // none
  }
}

// s[h] = scale * q[a,h,row] . k[e,h,m] for one lane's key m.
template <typename T, int H, int HC>
__device__ __forceinline__ void head_scores(const T* qa, const T* ke, int n, int mlen,
                                            int row, int m, float scale, float* s) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const T* qr = qa + ((long long)h * n + row) * HC;
    const T* kr = ke + ((long long)h * mlen + m) * HC;
    float t = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < HC; c0 += 8) {
      float qv[8], kv[8];
      Elem<T>::load8(qr + c0, qv);
      Elem<T>::load8(kr + c0, kv);
#pragma unroll
      for (int j = 0; j < 8; ++j) t = fmaf(qv[j], kv[j], t);
    }
    s[h] = t * scale;
  }
}

// q (A,H,N,HC), k (E,H,M,HC), qmask (N), kmask (M), sup_q (A,H), sup_k (E,H)
// or null; rowmax/rowsum (A,E,H,N); gpart/spart (A,E,nblk).
template <typename T, int H, int HC>
__global__ void __launch_bounds__(kThreads)
eq_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const uint8_t* __restrict__ qmask, const uint8_t* __restrict__ kmask,
                const float* __restrict__ sup_q, const float* __restrict__ sup_k,
                float* __restrict__ rowmax, float* __restrict__ rowsum,
                float* __restrict__ gpart, float* __restrict__ spart, int na, int ne,
                int n, int mlen, int mode) {
  __shared__ float red_g[kWarps];
  __shared__ float red_s[kWarps];
  const int nblk = (n + kWarps - 1) / kWarps;
  const int blk = blockIdx.x % nblk;
  const int ae = blockIdx.x / nblk;
  const int a = ae / ne;
  const int e = ae - a * ne;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blk * kWarps + warp;
  const float scale = 1.f / sqrtf((float)HC);
  const bool with_sup = sup_q != nullptr;

  float g_lane = 0.f;
  float sup_lane = kNeg;
  if (row < n) {
    const T* qa = q + (long long)a * H * n * HC;
    const T* ke = k + (long long)e * H * mlen * HC;
    const bool qv = qmask[row] != 0;
    float wsup[H];
#pragma unroll
    for (int h = 0; h < H; ++h) wsup[h] = with_sup ? sup_q[a * H + h] * sup_k[e * H + h] : 0.f;
    float mrun[H], lrun[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      mrun[h] = __int_as_float(0xff800000);  // -inf
      lrun[h] = 0.f;
    }
    for (int m0 = 0; m0 < mlen; m0 += 32) {
      const int m = m0 + lane;
      const bool in_range = m < mlen;
      const bool kv = in_range && kmask[m] != 0;
      float s[H];
      if (in_range) {
        head_scores<T, H, HC>(qa, ke, n, mlen, row, m, scale, s);
      } else {
#pragma unroll
        for (int h = 0; h < H; ++h) s[h] = 0.f;
      }
      float hsum = 0.f, ssum = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        hsum += s[h];
        ssum += s[h] * wsup[h];
        const float sm = kv ? s[h] : kNeg;
        const float mnew = fmaxf(mrun[h], warp_max(sm));
        const float p = kv ? expf(sm - mnew) : 0.f;
        lrun[h] = lrun[h] * expf(mrun[h] - mnew) + warp_sum(p);
        mrun[h] = mnew;
      }
      if (qv && kv) {
        g_lane += positive(hsum * (1.f / H), mode);
        if (with_sup) sup_lane = fmaxf(sup_lane, ssum * (1.f / H));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const long long idx = (((long long)a * ne + e) * H + h) * n + row;
        rowmax[idx] = mrun[h];
        rowsum[idx] = lrun[h];
      }
    }
  }
  g_lane = warp_sum(g_lane);
  sup_lane = warp_max(sup_lane);
  if (lane == 0) {
    red_g[warp] = g_lane;
    red_s[warp] = sup_lane;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float g = 0.f, sp = kNeg;
    for (int w = 0; w < kWarps; ++w) {
      g += red_g[w];
      sp = fmaxf(sp, red_s[w]);
    }
    gpart[(long long)ae * nblk + blk] = g;
    spart[(long long)ae * nblk + blk] = sp;
  }
}

// q (A,H,N,HC), k/v (E,H,M,HC), w (A,E), rowmax/rowsum (A,E,H,N), kmask (M);
// out (A,H,N,HC) f32.
template <typename T, int H, int HC>
__global__ void __launch_bounds__(kThreads)
eq_apply_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ rowmax,
                const float* __restrict__ rowsum, const uint8_t* __restrict__ kmask,
                float* __restrict__ out, int ne, int n, int mlen) {
  __shared__ float p_s[kWarps][H][32];
  const int nblk = (n + kWarps - 1) / kWarps;
  const int a = blockIdx.x / nblk;
  const int blk = blockIdx.x - a * nblk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blk * kWarps + warp;
  if (row >= n) return;  // no block-wide barrier below
  const float scale = 1.f / sqrtf((float)HC);
  constexpr int kPairs = HC / 2;
  static_assert(HC % 8 == 0 && kPairs <= 32, "head width: a multiple of 8, at most 64");
  const bool pv_lane = lane < kPairs;
  const T* qa = q + (long long)a * H * n * HC;

  float acc[H][2];
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h][0] = acc[h][1] = 0.f;

  for (int e = 0; e < ne; ++e) {
    const T* ke = k + (long long)e * H * mlen * HC;
    const T* ve = v + (long long)e * H * mlen * HC;
    float rmax[H], tmp[H][2];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      rmax[h] = rowmax[(((long long)a * ne + e) * H + h) * n + row];
      tmp[h][0] = tmp[h][1] = 0.f;
    }
    for (int m0 = 0; m0 < mlen; m0 += 32) {
      const int m = m0 + lane;
      const bool kv = m < mlen && kmask[m] != 0;
      float s[H];
      if (kv) head_scores<T, H, HC>(qa, ke, n, mlen, row, m, scale, s);
#pragma unroll
      for (int h = 0; h < H; ++h)
        p_s[warp][h][lane] = kv ? Elem<T>::round(expf(s[h] - rmax[h])) : 0.f;
      __syncwarp();
      if (pv_lane) {
        const int mcount = min(32, mlen - m0);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const T* vb = ve + ((long long)h * mlen + m0) * HC + 2 * lane;
          float t0 = tmp[h][0], t1 = tmp[h][1];
          for (int j = 0; j < mcount; ++j) {
            const float p = p_s[warp][h][j];
            const float2 vv = Elem<T>::load2(vb + (long long)j * HC);
            t0 = fmaf(p, vv.x, t0);
            t1 = fmaf(p, vv.y, t1);
          }
          tmp[h][0] = t0;
          tmp[h][1] = t1;
        }
      }
      __syncwarp();
    }
    const float wae = w[a * ne + e];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float f = wae * (1.f / fmaxf(rowsum[(((long long)a * ne + e) * H + h) * n + row],
                                         1e-30f));
      acc[h][0] += f * tmp[h][0];
      acc[h][1] += f * tmp[h][1];
    }
  }
  if (pv_lane) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float* o = out + (((long long)a * H + h) * n + row) * HC + 2 * lane;
      o[0] = acc[h][0];
      o[1] = acc[h][1];
    }
  }
}

// ---------------------------------------------------------------------------
// K6's serving form, "tc" (bf16, H = 4, head width 64).
//
// Bound: exponentials.  Every score with a valid key takes one exp: 151 M at
// the serving shape, at 16 per clock per SM (132 SMs, 1.98 GHz) 36 us; the
// products take 19.5 us at the tensor-core peak.  With 16 query rows per
// warp each warp reads the k tile from shared memory for itself (by
// ldmatrix, 8 bytes per score and head, plus its q tile, 4 more), which
// with the exps and the float32 work per score is what the time is made of
// (scripts/probe_eq_attention.py: the variants and their times).
//
// Work: per key anchor e, A * ceil(N / 16) warp units (anchor a, 16 query
// rows).  One block per SM: E x bpe blocks, bpe = SMs / E, each of one
// producer warp and kConsumers consumer warps that all take units of one e;
// in each pass the block streams k[e] once and each consumer warp computes
// one unit, passes repeating until e's units are spent (at the serving
// shape 132 blocks, 384 units per e over 22 x 9 warps: two passes, and no
// warp takes more than two units).  No block barrier after the set-up:
// * producer (one lane): per pass every key tile of k[e] that holds a valid
//   key, as one TMA tensor copy (H heads x kKeys keys x 64 channels, the
//   128-byte swizzle: 16-byte chunk c of key row r lands at c ^ (r & 7))
//   into a ring of kStages slots, with full / empty mbarriers;
// * consumers: the unit's q rows (H heads) copied once into the warp's own
//   swizzled shared tile; per key tile, every head's S = q k^T first (A and
//   B fragments by ldmatrix.x4, free of bank conflicts under the swizzle;
//   mma.sync m16n8k16, 16 independent accumulator chains), then the head
//   sum for positive() (with sup the weighted one), the masked maxima and
//   the sums 2^((s - ref) * scale * log2 e): one FFMA and one ex2.approx
//   (one MUFU op) per score.  Each lane keeps its own reference max per
//   row, moved (with a rescale of its sum) only when a tile's max passes it
//   by kSlack, decided by one warp vote per tile; the lanes' sums and true
//   maxima are merged across the quad once per unit.
// The key mask is staged once per block as bits: tiles without a valid key
// are skipped by producer and consumers alike, a partial tile is masked by
// selection.  rowmax stays in the plain version's units (scale * q . k).
// Each 16-row m-tile writes one pooled partial, already divided by the
// valid (n, m) count, so the wrapper only sums them; with sup one partial
// max.
namespace eq_tc {

using bf16 = __nv_bfloat16;
constexpr int kH = 4;
constexpr int kHC = 64;
// the design's settings; scripts/probe_eq_attention.py builds the source
// with each of them changed and times the variants in turns
constexpr int kKeys = 32;  // keys per staged tile
constexpr int kStages = 8;  // ring slots
constexpr float kSlack = 64.f;  // raw q . k: 2^(64 * scale * log2 e) = 2^11.5
constexpr int kConsumers = 9;  // consumer warps per block
constexpr int kMT = 1;  // 16-row m-tiles per warp unit, sharing each k fragment
constexpr bool kQInSmem = true;  // q fragments from shared memory (else registers)
constexpr bool kPersistent = true;  // one block walks every pass
constexpr int kRows = 16;  // query rows per m-tile (one pooled partial)
constexpr int kUnitRows = kRows * kMT;
constexpr int kThreads = (kConsumers + 1) * 32;
constexpr int kNT = kKeys / 8;
constexpr int kWords = kKeys / 32;  // key-mask words per tile
constexpr uint32_t kStageBytes = (uint32_t)kH * kKeys * kHC * sizeof(bf16);
constexpr uint32_t kQBytes = (uint32_t)kH * kUnitRows * kHC * sizeof(bf16);  // per warp
static_assert(kQInSmem || kMT == 1, "q in registers holds one m-tile");
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can have

// the shared-memory plan, byte offsets from the block's 1024-aligned base
// (mirrored by the wrapper's eq_attention.eq_stats_smem_bytes): the ring, q
// tiles (kQInSmem), the key-mask bits, 2 * kStages mbarriers, two counts
__host__ __device__ inline size_t mask_off() {
  return (size_t)kStages * kStageBytes + (kQInSmem ? (size_t)kConsumers * kQBytes : 0);
}
__host__ __device__ inline int tiles(int m) { return (m + kKeys - 1) / kKeys; }
__host__ __device__ inline size_t bar_off(int m) {
  return mask_off() + (((size_t)tiles(m) * kWords * 4 + 7) & ~(size_t)7);
}
__host__ __device__ inline size_t smem_bytes(int m) {
  return 1024 + bar_off(m) + 2 * kStages * sizeof(uint64_t) + 2 * sizeof(int);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one TMA copy of the box at key `key0`, head `h` of anchor `e` (K6's box:
// all heads from h = 0; K7's: one head) into `dst`
__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap* map, int key0, int h,
                                          int e, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(key0), "r"(h),
      "r"(e), "r"(smem_u32(bar)) : "memory");
}

// four 8x8 bf16 matrices from shared memory: each lane gives the address
// of one 16-byte row (lanes 8i..8i+7 the rows of matrix i), r[i] holds
// lane (g, t)'s elements 2t, 2t + 1 of row g of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Fragment addressing of a tile of 128-byte rows (64 bf16) under the
// 128-byte swizzle (16-byte chunk c of row r at c ^ (r & 7)), for lane
// `lane`: the row it addresses within a group of 16 and its chunk offsets
// for the k-steps kk = 0..3 (channels 16 kk .. 16 kk + 15).
// * A (16 rows x 16 channels, q): lanes 0-15 rows 0-15 at chunk 2 kk,
//   lanes 16-31 the same rows at chunk 2 kk + 1: r = a0..a3 of mma.m16n8k16;
// * B (two n-tiles of 8 keys, k): lanes 0-7 / 8-15 keys 0-7 at chunks 2 kk /
//   2 kk + 1, lanes 16-23 / 24-31 keys 8-15 the same: r = b0, b1 of the
//   first n-tile, then of the second.
struct Frag {
  int a_row, b_row;
  uint32_t a_off[4], b_off[4];
  __device__ explicit Frag(int lane) {
    a_row = lane & 15;
    b_row = ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_off[kk] = (uint32_t)(((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4);
      b_off[kk] = (uint32_t)(((2 * kk + ((lane >> 3) & 1)) ^ (lane & 7)) << 4);
    }
  }
};

// whether a tile of kW mask words holds no valid key / only valid keys
template <int kW = kWords>
__device__ __forceinline__ bool tile_empty(const uint32_t* w) {
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) any |= w[i];
  return any == 0;
}

template <int kW = kWords>
__device__ __forceinline__ bool tile_full(const uint32_t* w) {
  uint32_t all = ~0u;
#pragma unroll
  for (int i = 0; i < kW; ++i) all &= w[i];
  return all == ~0u;
}

// a consumer warp's state over one unit, per m-tile, head and row (g /
// g + 8), in raw q . k units: the lane's sum of 2^((s - ref) * scale *
// log2 e) over its keys, its reference max `ref` (moved only where a lane's
// tile max passes ref + kSlack, so the sums stay below 2^(kSlack * scale *
// log2 e) without a rescale per tile), and its true max; merged across the
// quad at the end
template <bool kSup>
struct Unit {
  float l[kMT][kH][2], ref[kMT][kH][2], top[kMT][kH][2];
  float g[kMT][2];    // pooled sums of rows g / g + 8
  float sup[kMT][2];  // raw weighted-head-sum maxima
  float wsup[kH];
};

// The unit's work on one staged tile (all heads).  kMasked: select the
// tile's valid keys (bits in w); otherwise every key is valid.  q comes from
// the warp's swizzled tile `qs` ([head][m-tile][16 rows][64]) or, with one
// m-tile, from registers `qf`.
template <int kMode, bool kSup, bool kMasked>
__device__ __forceinline__ void tile_step(uint32_t slot, const uint32_t (&qf)[kH][4][4],
                                          uint32_t qs, const Frag& fr, const uint32_t* w,
                                          int t, float c2, float hscale, int mode,
                                          Unit<kSup>& u) {
  uint32_t bits[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) bits[i] = w[i] >> (2 * t);
  auto valid = [&](int jn, int i) -> bool {
    return (bits[jn >> 2] >> (((jn & 3) << 3) + i)) & 1u;
  };
  // every head's products first: 4 * kNT * kMT independent chains of mma
  float s[kMT][kH][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int jn = 0; jn < kNT; ++jn)
        s[mt][h][jn][0] = s[mt][h][jn][1] = s[mt][h][jn][2] = s[mt][h][jn][3] = 0.f;
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if constexpr (kQInSmem) {
          ldsm_x4(a[mt], qs + ((h * kMT + mt) * kRows + fr.a_row) * 128 + fr.a_off[kk]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[mt][i] = qf[h][kk][i];
        }
      }
#pragma unroll
      for (int jn = 0; jn < kNT; jn += 2) {
        uint32_t b[4];
        ldsm_x4(b, slot + (h * kKeys + 8 * jn + fr.b_row) * 128 + fr.b_off[kk]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][h][jn], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);
          mma_bf16(s[mt][h][jn + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[2], b[3]);
        }
      }
    }
  // head sums, masking, the lanes' maxima; one vote for the whole tile
  float hs[kMT][kNT][4], ss[kMT][kNT][4], mx[kMT][kH][2];
  bool moved = false;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      mx[mt][h][0] = mx[mt][h][1] = neg_inf();
#pragma unroll
      for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = s[mt][h][jn][c];
          hs[mt][jn][c] = h == 0 ? v : hs[mt][jn][c] + v;
          if constexpr (kSup)
            ss[mt][jn][c] = h == 0 ? v * u.wsup[0] : fmaf(v, u.wsup[h], ss[mt][jn][c]);
          const float vm = (!kMasked || valid(jn, c & 1)) ? v : neg_inf();
          s[mt][h][jn][c] = vm;
          mx[mt][h][c >> 1] = fmaxf(mx[mt][h][c >> 1], vm);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        u.top[mt][h][r] = fmaxf(u.top[mt][h][r], mx[mt][h][r]);
        moved |= mx[mt][h][r] > u.ref[mt][h][r] + kSlack;
      }
    }
  // a rescale only where some lane's max passes its reference by kSlack
  if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float ref = fmaxf(u.ref[mt][h][r], mx[mt][h][r]);
          u.l[mt][h][r] *= ex2((u.ref[mt][h][r] - ref) * c2);
          u.ref[mt][h][r] = ref;
        }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float ca = -u.ref[mt][h][0] * c2, cb = -u.ref[mt][h][1] * c2;
      float suma = 0.f, sumb = 0.f;
#pragma unroll
      for (int jn = 0; jn < kNT; ++jn) {
        suma += ex2(fmaf(s[mt][h][jn][0], c2, ca)) + ex2(fmaf(s[mt][h][jn][1], c2, ca));
        sumb += ex2(fmaf(s[mt][h][jn][2], c2, cb)) + ex2(fmaf(s[mt][h][jn][3], c2, cb));
      }
      u.l[mt][h][0] += suma;
      u.l[mt][h][1] += sumb;
    }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = !kMasked || valid(jn, c & 1);
        const float x = hs[mt][jn][c];
        if constexpr (kMode == 1) {  // sq: (scale / H)^2 applied at the end
          const float xv = ok ? x : 0.f;
          u.g[mt][c >> 1] = fmaf(xv, xv, u.g[mt][c >> 1]);
        } else {
          const float pv = positive(x * hscale, mode);
          u.g[mt][c >> 1] += ok ? pv : 0.f;
        }
        if constexpr (kSup)
          u.sup[mt][c >> 1] = fmaxf(u.sup[mt][c >> 1], ok ? ss[mt][jn][c] : neg_inf());
      }
}

// q (A,H,N,64), k (E,H,M,64) behind `map`, qmask (N), kmask (M) as bytes,
// sup_q (A,H) / sup_k (E,H) when kSup; rowmax/rowsum (A,E,H,N); gpart/spart
// (A,E,ceil(N/16)).  kMode: the positive() mode, or -1 for `mode` at run time.
template <int kMode, bool kSup>
__global__ void __launch_bounds__(kThreads, 1)
eq_stats_tc_kernel(const __grid_constant__ CUtensorMap map, const bf16* __restrict__ q,
                   const uint8_t* __restrict__ qmask, const uint8_t* __restrict__ kmask,
                   const float* __restrict__ sup_q, const float* __restrict__ sup_k,
                   float* __restrict__ rowmax, float* __restrict__ rowsum,
                   float* __restrict__ gpart, float* __restrict__ spart, int na, int ne, int n,
                   int mlen, int bpe, int passes, int mode) {
  extern __shared__ char smem_raw[];
  char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(base + mask_off());
  uint64_t* full = reinterpret_cast<uint64_t*>(base + bar_off(mlen));
  uint64_t* empty = full + kStages;
  int* counts = reinterpret_cast<int*>(empty + kStages);  // valid query rows, valid keys

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_pass = ne * bpe;
  const int p0 = kPersistent ? 0 : blockIdx.x / per_pass;
  const int p_end = kPersistent ? passes : p0 + 1;
  const int bid = blockIdx.x % per_pass;
  const int e = bid / bpe, lb = bid - e * bpe;
  const int rblocks = (n + kUnitRows - 1) / kUnitRows;
  const int units = na * rblocks;  // per e
  const int parts = (n + kRows - 1) / kRows;  // pooled partial slots per (a, e)
  const int ntiles = tiles(mlen);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    counts[0] = counts[1] = 0;
  }
  __syncthreads();
  // the key mask as bits (zero past mlen) and both valid counts
  int kc = 0;
  for (int wd = warp; wd < ntiles * kWords; wd += kConsumers + 1) {
    const int key = 32 * wd + lane;
    const uint32_t b = __ballot_sync(0xffffffffu, key < mlen && kmask[key] != 0);
    if (lane == 0) mask_s[wd] = b;
    kc += __popc(b);
  }
  int qc = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) qc += qmask[i] != 0;
  qc = __reduce_add_sync(0xffffffffu, qc);
  if (lane == 0) {
    atomicAdd(&counts[0], qc);
    atomicAdd(&counts[1], kc);
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer
    if (lane != 0) return;
    int s = 0;
    for (int pass = p0; pass < p_end && (pass * bpe + lb) * kConsumers < units; ++pass)
      for (int j = 0; j < ntiles; ++j) {
        if (tile_empty(mask_s + j * kWords)) continue;
        const int slot = s % kStages;
        if (s >= kStages) mbar_wait_or_trap(&empty[slot], ((s / kStages) - 1) & 1, 0);
        mbar_expect_tx(&full[slot], kStageBytes);
        load_tile(base + (size_t)slot * kStageBytes, &map, j * kKeys, 0, e, &full[slot]);
        ++s;
      }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const float scale = 0.125f;  // 1 / sqrt(64)
  const float c2 = scale * kLog2e;
  const float hscale = scale / kH;
  const float inv_count = 1.f / ((float)counts[0] * (float)counts[1] + 1e-9f);
  char* qs = kQInSmem ? base + (size_t)kStages * kStageBytes + (size_t)warp * kQBytes : nullptr;
  const uint32_t qs_u32 = kQInSmem ? smem_u32(qs) : 0u;
  const Frag fr(lane);
  int s = 0;
  for (int pass = p0; pass < p_end && (pass * bpe + lb) * kConsumers < units; ++pass) {
    const int unit = (pass * bpe + lb) * kConsumers + warp;
    const bool active = unit < units;
    const int a = active ? unit / rblocks : 0;
    const int rb = unit - a * rblocks;
    const int row0 = rb * kUnitRows;
    const bf16* qa = q + (long long)a * kH * n * kHC;
    uint32_t qf[kH][4][4];  // q in registers (!kQInSmem): a0..a3 per head and k-step
    Unit<kSup> u;
    if (active) {
      if constexpr (kQInSmem) {
        __syncwarp();
        for (int idx = lane; idx < kH * kUnitRows * 8; idx += 32) {
          const int h = idx / (kUnitRows * 8), r = (idx / 8) % kUnitRows, ch = idx % 8;
          const int row = row0 + r;
          *reinterpret_cast<uint4*>(qs + (h * kUnitRows + r) * 128 + ((ch ^ (r & 7)) << 4)) =
              ld16(qa + ((long long)h * n + row) * kHC + 8 * ch, row < n);
        }
        __syncwarp();
      } else {
        const int ra = row0 + g, rbw = ra + 8;
        auto q32 = [&](int h, int row, int c) -> uint32_t {
          return row < n ? __ldg(reinterpret_cast<const unsigned int*>(
                               qa + ((long long)h * n + row) * kHC + c))
                         : 0u;
        };
#pragma unroll
        for (int h = 0; h < kH; ++h)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            qf[h][kk][0] = q32(h, ra, 16 * kk + 2 * t);
            qf[h][kk][1] = q32(h, rbw, 16 * kk + 2 * t);
            qf[h][kk][2] = q32(h, ra, 16 * kk + 8 + 2 * t);
            qf[h][kk][3] = q32(h, rbw, 16 * kk + 8 + 2 * t);
          }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          // a finite start, so that 2^((s - ref) * c) stays 0 on masked keys
          u.ref[mt][h][0] = u.ref[mt][h][1] = -1e30f;
          u.top[mt][h][0] = u.top[mt][h][1] = neg_inf();
          u.l[mt][h][0] = u.l[mt][h][1] = 0.f;
        }
        u.g[mt][0] = u.g[mt][1] = 0.f;
        u.sup[mt][0] = u.sup[mt][1] = neg_inf();
      }
#pragma unroll
      for (int h = 0; h < kH; ++h) u.wsup[h] = kSup ? sup_q[a * kH + h] * sup_k[e * kH + h] : 0.f;
    }
    for (int j = 0; j < ntiles; ++j) {
      const uint32_t* w = mask_s + j * kWords;
      if (tile_empty(w)) continue;
      const int slot = s % kStages;
      mbar_wait_or_trap(&full[slot], (s / kStages) & 1, 1);
      if (active) {
        const uint32_t sb = smem_u32(base) + (uint32_t)slot * kStageBytes;
        if (tile_full(w))
          tile_step<kMode, kSup, false>(sb, qf, qs_u32, fr, w, t, c2, hscale, mode, u);
        else
          tile_step<kMode, kSup, true>(sb, qf, qs_u32, fr, w, t, c2, hscale, mode, u);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      ++s;
    }
    if (!active) continue;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int ra = row0 + mt * kRows + g;
      const int rows[2] = {ra, ra + 8};
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // the row's max, and the lanes' sums moved to it (none: no valid
          // key, the plain version's -1e9 and 0)
          const float top = quad_max(u.top[mt][h][r]);
          const float sum = quad_sum(
              top == neg_inf() ? 0.f : u.l[mt][h][r] * ex2((u.ref[mt][h][r] - top) * c2));
          if (t == 0 && rows[r] < n) {
            const long long idx = (((long long)a * ne + e) * kH + h) * n + rows[r];
            rowmax[idx] = top == neg_inf() ? kNeg : top * scale;
            rowsum[idx] = sum;
          }
        }
      const bool qva = ra < n && qmask[ra] != 0;
      const bool qvb = ra + 8 < n && qmask[ra + 8] != 0;
      float gs = warp_sum((qva ? u.g[mt][0] : 0.f) + (qvb ? u.g[mt][1] : 0.f));
      if (kMode == 1) gs *= hscale * hscale;
      const int part = rb * kMT + mt;
      const long long out = ((long long)a * ne + e) * parts + part;
      if (lane == 0 && part < parts) gpart[out] = gs * inv_count;
      if constexpr (kSup) {
        const float sp =
            warp_max(fmaxf(qva ? u.sup[mt][0] : neg_inf(), qvb ? u.sup[mt][1] : neg_inf()));
        if (lane == 0 && part < parts) spart[out] = sp == neg_inf() ? kNeg : sp * hscale;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// A TMA map of x (E, 4, M, 64) bf16 (16-byte aligned) whose box is `keys`
// keys of `heads` heads of one anchor, 128-byte swizzled; 0 or a CUDA error
static int encode_map(CUtensorMap* map, const void* x, int ne, int m, int keys, int heads) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)kHC, (cuuint64_t)m, (cuuint64_t)kH, (cuuint64_t)ne};
  const cuuint64_t strides[3] = {kHC * sizeof(bf16), (cuuint64_t)m * kHC * sizeof(bf16),
                                 (cuuint64_t)kH * m * kHC * sizeof(bf16)};
  const cuuint32_t box[4] = {(cuuint32_t)kHC, (cuuint32_t)keys, (cuuint32_t)heads, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// (blocks per key anchor, passes) of the grid for A anchors, E key anchors,
// N query rows
static void plan(int na, int ne, int n, int* bpe, int* passes) {
  const int units = na * ((n + kUnitRows - 1) / kUnitRows);
  const int most = (units + kConsumers - 1) / kConsumers;  // blocks with a unit
  *bpe = std::max(1, std::min(sm_count() / ne, most));
  *passes = (units + *bpe * kConsumers - 1) / (*bpe * kConsumers);
}

// static: each instance raises its shared-memory attribute once per process
template <int kMode, bool kSup>
static int launch_mode(const CUtensorMap& map, const void* q, const void* qm, const void* km,
                       const void* sq, const void* sk, void* rowmax, void* rowsum,
                       void* gpart, void* spart, int na, int ne, int n, int m, int mode,
                       cudaStream_t st) {
  const size_t smem = smem_bytes(m);
  static size_t attr = 0;
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        eq_stats_tc_kernel<kMode, kSup>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  int bpe, passes;
  plan(na, ne, n, &bpe, &passes);
  const int grid = ne * bpe * (kPersistent ? 1 : passes);
  eq_stats_tc_kernel<kMode, kSup><<<grid, kThreads, smem, st>>>(
      map, (const bf16*)q, (const uint8_t*)qm, (const uint8_t*)km, (const float*)sq,
      (const float*)sk, (float*)rowmax, (float*)rowsum, (float*)gpart, (float*)spart, na, ne,
      n, m, bpe, passes, mode);
  return (int)cudaGetLastError();
}

// K6 in the tc form: k (E, 4, M, 64) bf16, 16-byte aligned
inline int launch(const void* q, const void* k, const void* qm, const void* km,
                  const void* sq, const void* sk, void* rowmax, void* rowsum, void* gpart,
                  void* spart, int na, int ne, int n, int m, int mode, cudaStream_t st) {
  if (smem_bytes(m) > (size_t)kMaxSmem || sm_count() == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = encode_map(&map, k, ne, m, kKeys, kH);
  if (err) return err;
  const bool sup = sq != nullptr;
  if (mode == 1)
    return sup ? launch_mode<1, true>(map, q, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na,
                                      ne, n, m, mode, st)
               : launch_mode<1, false>(map, q, qm, km, sq, sk, rowmax, rowsum, gpart, spart,
                                       na, ne, n, m, mode, st);
  return sup ? launch_mode<-1, true>(map, q, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na,
                                     ne, n, m, mode, st)
             : launch_mode<-1, false>(map, q, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na,
                                      ne, n, m, mode, st);
}

// blocks of the (sq, no sup) kernel resident per SM at M keys
inline int blocks_per_sm(int m) {
  const size_t smem = smem_bytes(m);
  if (cudaFuncSetAttribute(eq_stats_tc_kernel<1, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return -1;
  int nb = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, eq_stats_tc_kernel<1, false>, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return nb;
}

// ---------------------------------------------------------------------------
// K7's serving form, "tc" (bf16, H = 4, head width 64).
//
// out[a,h,n] = sum_e w[a,e] / max(rowsum[a,e,h,n], 1e-30)
//              * sum_m round_bf16(exp(s_aeh[n,m] - rowmax[a,e,h,n]) kmask[m]) v[e,h,m]
// (the unscaled probability rounded to bf16 before p v, as on the TPU).
//
// Bound: at the serving shape the products (q k^T and p v, 38.7 GFLOP) take
// 39 us at the tensor-core peak and the exps (151 M) 36 us.  On mma.sync,
// with k and v fragments read by ldmatrix, a 16-row warp reads 16 bytes of
// shared memory per score (a floor of ~72 us at 128 bytes per clock per
// SM); wgmma reads k and v once per 64-row warpgroup, a quarter of that,
// and runs the products at the full tensor-core rate.  What is left is the
// chain within a warpgroup, q k^T -> exp -> p v, each step waiting for the
// one before (scripts/probe_eq_attention.py: the variants and ablations).
//
// Work: per head h, A * ceil(N / 64) units (anchor a, 64 query rows), one
// per warpgroup, each looping over every key anchor e; each warp owns 16 of
// the unit's rows: its o (16 x 64 float32) sums one e's p v, and at the end
// of each e its acc takes w[a,e] / rowsum * o.  One block per SM, grouped
// by head: H x bph blocks (bph = SMs / H), each of one producer warp and
// kApplyConsumers consumer warps (three warpgroups) that all take units of
// one head; in each pass the block streams k[e, h] and v[e, h] once for
// every e and each warpgroup computes one unit (at the serving shape 96
// units per head over 32 x 3 warpgroups: one pass, ~212 MB through L2 per
// launch).  No block barrier after the set-up:
// * producer (one lane): per pass and e, every key tile holding a valid
//   key, as two TMA tensor copies (k and v, kApplyKeys keys x 64 channels,
//   the 128-byte swizzle) into one slot of a ring of kApplyStages, with
//   full / empty mbarriers;
// * consumers: q in registers (the A operand), fetched once per unit;
//   rowmax and rowsum read once per (unit, e); per tile S = q k^T by
//   wgmma.m64n64k16 (k read from the swizzled slot as a K-major B), p =
//   2^(s scale log2 e - rowmax log2 e) (one FFMA, one ex2.approx), the mask
//   a select from the staged bits, p rounded to bf16 straight from the
//   accumulators into A fragments, o += p v by wgmma (v read from the slot
//   as an MN-major B).
// The key mask is staged once per block as bits: tiles without a valid key
// are skipped by producer and consumers alike.  Rows >= N are neither read
// nor written.
constexpr int kApplyKeys = 64;  // keys per staged k / v tile: one wgmma N
constexpr int kApplyStages = 4;  // ring slots
constexpr int kApplyConsumers = 12;  // consumer warps per block, whole warpgroups
constexpr bool kApplyPersistent = true;  // one block walks every pass
constexpr int kApplyThreads = (kApplyConsumers + 1) * 32;
constexpr int kAUnitsPerBlock = kApplyConsumers / 4;
constexpr int kAUnitRows = 4 * kRows;  // query rows of a warpgroup
constexpr int kANT = kApplyKeys / 8;  // key n-tiles per tile
constexpr int kAWords = kApplyKeys / 32;  // key-mask words per tile
constexpr uint32_t kATileBytes = (uint32_t)kApplyKeys * kHC * sizeof(bf16);  // k or v
constexpr uint32_t kASlotBytes = 2 * kATileBytes;
static_assert(kANT == 8 && kHC / 8 == 8 && kApplyConsumers % 4 == 0,
              "wgmma.m64n64k16 tiles: 64 keys, 64 channels, whole warpgroups");

// K7's shared-memory plan, byte offsets from the block's 1024-aligned base
// (mirrored by the wrapper's eq_attention.eq_apply_smem_bytes): the ring
// (each slot a k tile, then a v tile), the key-mask bits, 2 * kApplyStages
// mbarriers
__host__ __device__ inline size_t apply_mask_off() {
  return (size_t)kApplyStages * kASlotBytes;
}
__host__ __device__ inline int apply_tiles(int m) { return (m + kApplyKeys - 1) / kApplyKeys; }
__host__ __device__ inline size_t apply_bar_off(int m) {
  return apply_mask_off() + (((size_t)apply_tiles(m) * kAWords * 4 + 7) & ~(size_t)7);
}
__host__ __device__ inline size_t apply_smem_bytes(int m) {
  return 1024 + apply_bar_off(m) + 2 * kApplyStages * sizeof(uint64_t);
}

// A wgmma descriptor of a 128-byte swizzled tile of 128-byte rows at shared
// address `addr` (1024-byte aligned atoms of 8 rows, 1024 bytes apart), read
// K-major (k: the channels of a key contiguous) or MN-major (v as B of p v:
// the channels contiguous along N)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the 32 accumulators at
// `d` across the asynchronous products
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64: 32 floats, each warp its 16 rows in the mma.sync accumulator
// layout, n-tile j at d[4 j .. 4 j + 3]) += a (64 x 16 bf16 in registers, the
// mma.sync A layout) . b (16 x 64 behind `desc`; kTransB: MN-major)
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred acc;\n setp.ne.b32 acc, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, acc, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kTransB), "r"(1));
}

// o += p v for one staged tile (k at `slot`, v kATileBytes after it) and the
// warpgroup's 64 query rows (this warp's 16): q from registers `qf`
// ([k-step][a0..a3]); nb[r] = -rowmax log2 e of rows g / g + 8; kMasked:
// only the tile's valid keys (bits in w) count.
template <bool kMasked>
__device__ __forceinline__ void apply_step(uint32_t slot, const uint32_t (&qf)[4][4],
                                           const uint32_t* w, int t, float c2,
                                           const float (&nb)[2], float (&o)[kHC / 8][4]) {
  float s[kANT][4];
#pragma unroll
  for (int jn = 0; jn < kANT; ++jn) s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;
  const uint64_t dk = gmma_desc(slot);
  fence_regs(&s[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(&s[0][0], qf[kk], dk + 2 * kk);  // +32 bytes
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(&s[0][0]);
  uint32_t bits[kAWords];
#pragma unroll
  for (int i = 0; i < kAWords; ++i) bits[i] = w[i] >> (2 * t);
#pragma unroll
  for (int jn = 0; jn < kANT; ++jn)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = ex2(fmaf(s[jn][c], c2, nb[c >> 1]));
      if constexpr (kMasked)
        s[jn][c] = (bits[jn >> 2] >> (((jn & 3) << 3) + (c & 1))) & 1u ? p : 0.f;
      else
        s[jn][c] = p;
    }
  const uint64_t dv = gmma_desc(slot + kATileBytes);
  fence_regs(&o[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < kApplyKeys / 16; ++kc) {
    const uint32_t p[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                           pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                           pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                           pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
    wgmma_rs<1>(&o[0][0], p, dv + 128 * kc);  // +16 keys: 2048 bytes
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(&o[0][0]);
}

// q (A,H,N,64), k / v (E,H,M,64) behind kmap / vmap, w (A,E), rowmax/rowsum
// (A,E,H,N), kmask (M) as bytes; out (A,H,N,64) float32.
__global__ void __launch_bounds__(kApplyThreads, 1)
eq_apply_tc_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
                   const float* __restrict__ w, const float* __restrict__ rowmax,
                   const float* __restrict__ rowsum, const uint8_t* __restrict__ kmask,
                   float* __restrict__ out, int na, int ne, int n, int mlen, int bph,
                   int passes) {
  extern __shared__ char smem_raw[];
  char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(base + apply_mask_off());
  uint64_t* full = reinterpret_cast<uint64_t*>(base + apply_bar_off(mlen));
  uint64_t* empty = full + kApplyStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_pass = kH * bph;
  const int p0 = kApplyPersistent ? 0 : blockIdx.x / per_pass;
  const int p_end = kApplyPersistent ? passes : p0 + 1;
  const int bid = blockIdx.x % per_pass;
  const int h = bid / bph, lb = bid - h * bph;
  const int rblocks = (n + kAUnitRows - 1) / kAUnitRows;
  const int units = na * rblocks;  // per head
  const int ntiles = apply_tiles(mlen);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kApplyStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kApplyConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the key mask as bits (zero past mlen)
  for (int wd = warp; wd < ntiles * kAWords; wd += kApplyConsumers + 1) {
    const int key = 32 * wd + lane;
    const uint32_t b = __ballot_sync(0xffffffffu, key < mlen && kmask[key] != 0);
    if (lane == 0) mask_s[wd] = b;
  }
  __syncthreads();

  if (warp == kApplyConsumers) {  // the producer
    if (lane != 0) return;
    int s = 0;
    for (int pass = p0; pass < p_end && (pass * bph + lb) * kAUnitsPerBlock < units; ++pass)
      for (int e = 0; e < ne; ++e)
        for (int j = 0; j < ntiles; ++j) {
          if (tile_empty<kAWords>(mask_s + j * kAWords)) continue;
          const int slot = s % kApplyStages;
          if (s >= kApplyStages)
            mbar_wait_or_trap(&empty[slot], ((s / kApplyStages) - 1) & 1, 0);
          mbar_expect_tx(&full[slot], kASlotBytes);
          char* dst = base + (size_t)slot * kASlotBytes;
          load_tile(dst, &kmap, j * kApplyKeys, h, e, &full[slot]);
          load_tile(dst + kATileBytes, &vmap, j * kApplyKeys, h, e, &full[slot]);
          ++s;
        }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const float c2 = 0.125f * kLog2e;  // 1 / sqrt(64) in base 2
  int s = 0;
  for (int pass = p0; pass < p_end && (pass * bph + lb) * kAUnitsPerBlock < units; ++pass) {
    const int unit = (pass * bph + lb) * kAUnitsPerBlock + warp / 4;
    const bool active = unit < units;  // the same for the warpgroup's four warps
    const int a = active ? unit / rblocks : 0;
    const int ra = (unit - a * rblocks) * kAUnitRows + (warp % 4) * kRows + g, rb = ra + 8;
    const bool va = active && ra < n, vb = active && rb < n;
    const bf16* qh = q + ((long long)a * kH + h) * n * kHC;
    auto q32 = [&](bool ok, int row, int c) -> uint32_t {
      return ok ? __ldg(reinterpret_cast<const unsigned int*>(qh + (long long)row * kHC + c))
                : 0u;
    };
    uint32_t qf[4][4];  // the A fragments of this warp's rows: a0..a3 per k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      qf[kk][0] = q32(va, ra, 16 * kk + 2 * t);
      qf[kk][1] = q32(vb, rb, 16 * kk + 2 * t);
      qf[kk][2] = q32(va, ra, 16 * kk + 8 + 2 * t);
      qf[kk][3] = q32(vb, rb, 16 * kk + 8 + 2 * t);
    }
    float acc[kHC / 8][4];
#pragma unroll
    for (int j = 0; j < kHC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int e = 0; e < ne; ++e) {
      const long long srow = (((long long)a * ne + e) * kH + h) * n;
      const float nb[2] = {va ? -rowmax[srow + ra] * kLog2e : 0.f,
                           vb ? -rowmax[srow + rb] * kLog2e : 0.f};
      float o[kHC / 8][4];
#pragma unroll
      for (int j = 0; j < kHC / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
      for (int j = 0; j < ntiles; ++j) {
        const uint32_t* wd = mask_s + j * kAWords;
        if (tile_empty<kAWords>(wd)) continue;
        const int slot = s % kApplyStages;
        mbar_wait_or_trap(&full[slot], (s / kApplyStages) & 1, 1);
        if (active) {
          const uint32_t sb = smem_u32(base) + (uint32_t)slot * kASlotBytes;
          if (tile_full<kAWords>(wd))
            apply_step<false>(sb, qf, wd, t, c2, nb, o);
          else
            apply_step<true>(sb, qf, wd, t, c2, nb, o);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
        ++s;
      }
      if (active) {
        const float we = w[a * ne + e];
        const float fa = va ? we * (1.f / fmaxf(rowsum[srow + ra], 1e-30f)) : 0.f;
        const float fb = vb ? we * (1.f / fmaxf(rowsum[srow + rb], 1e-30f)) : 0.f;
#pragma unroll
        for (int j = 0; j < kHC / 8; ++j) {
          acc[j][0] += fa * o[j][0];
          acc[j][1] += fa * o[j][1];
          acc[j][2] += fb * o[j][2];
          acc[j][3] += fb * o[j][3];
        }
      }
    }
    float* oh = out + ((long long)a * kH + h) * n * kHC;
#pragma unroll
    for (int j = 0; j < kHC / 8; ++j) {
      if (va)
        *reinterpret_cast<float2*>(oh + (long long)ra * kHC + 8 * j + 2 * t) =
            make_float2(acc[j][0], acc[j][1]);
      if (vb)
        *reinterpret_cast<float2*>(oh + (long long)rb * kHC + 8 * j + 2 * t) =
            make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// (blocks per head, passes) of K7's grid for A anchors and N query rows
static void apply_plan(int na, int n, int* bph, int* passes) {
  const int units = na * ((n + kAUnitRows - 1) / kAUnitRows);
  const int most = (units + kAUnitsPerBlock - 1) / kAUnitsPerBlock;  // blocks with a unit
  *bph = std::max(1, std::min(sm_count() / kH, most));
  *passes = (units + *bph * kAUnitsPerBlock - 1) / (*bph * kAUnitsPerBlock);
}

// K7 in the tc form: k, v (E, 4, M, 64) bf16, 16-byte aligned
inline int launch_apply(const void* q, const void* k, const void* v, const void* w,
                        const void* rowmax, const void* rowsum, const void* km, void* out,
                        int na, int ne, int n, int m, cudaStream_t st) {
  const size_t smem = apply_smem_bytes(m);
  if (smem > (size_t)kMaxSmem || sm_count() == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap kmap, vmap;
  int err = encode_map(&kmap, k, ne, m, kApplyKeys, 1);
  if (!err) err = encode_map(&vmap, v, ne, m, kApplyKeys, 1);
  if (err) return err;
  static size_t attr = 0;  // the kernel's shared-memory attribute, raised once per size
  if (smem > attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        eq_apply_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr = smem;
  }
  int bph, passes;
  apply_plan(na, n, &bph, &passes);
  const int grid = kH * bph * (kApplyPersistent ? 1 : passes);
  eq_apply_tc_kernel<<<grid, kApplyThreads, smem, st>>>(
      kmap, vmap, (const bf16*)q, (const float*)w, (const float*)rowmax, (const float*)rowsum,
      (const uint8_t*)km, (float*)out, na, ne, n, m, bph, passes);
  return (int)cudaGetLastError();
}

// blocks of K7's kernel resident per SM at M keys
inline int apply_blocks_per_sm(int m) {
  const size_t smem = apply_smem_bytes(m);
  if (cudaFuncSetAttribute(eq_apply_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int nb = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, eq_apply_tc_kernel, kApplyThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return nb;
}

}  // namespace eq_tc

template <typename T, int H, int HC>
int launch_stats(const void* q, const void* k, const void* qm, const void* km,
                 const void* sq, const void* sk, void* rowmax, void* rowsum, void* gpart,
                 void* spart, int na, int ne, int n, int m, int mode, cudaStream_t st) {
  const int grid = na * ne * ((n + kWarps - 1) / kWarps);
  eq_stats_kernel<T, H, HC><<<grid, kThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const uint8_t*)qm, (const uint8_t*)km, (const float*)sq,
      (const float*)sk, (float*)rowmax, (float*)rowsum, (float*)gpart, (float*)spart, na,
      ne, n, m, mode);
  return (int)cudaGetLastError();
}

template <typename T>
int stats(const void* q, const void* k, const void* qm, const void* km, const void* sq,
          const void* sk, void* rowmax, void* rowsum, void* gpart, void* spart, int na,
          int ne, int h, int n, int m, int hc, int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // bf16 at head width 64 takes the tc form, everything else (float32, head
  // widths 16 and 32) the CUDA cores
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (h == 4 && hc == 64)
      return eq_tc::launch(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na, ne, n, m,
                           mode, st);
  } else {
    if (h == 4 && hc == 64)
      return launch_stats<T, 4, 64>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na,
                                    ne, n, m, mode, st);
  }
  if (h == 4 && hc == 32)
    return launch_stats<T, 4, 32>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na,
                                  ne, n, m, mode, st);
  if (h == 4 && hc == 16)
    return launch_stats<T, 4, 16>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na,
                                  ne, n, m, mode, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int H, int HC>
int launch_apply(const void* q, const void* k, const void* v, const void* w,
                 const void* rowmax, const void* rowsum, const void* km, void* out, int na,
                 int ne, int n, int m, cudaStream_t st) {
  const int grid = na * ((n + kWarps - 1) / kWarps);
  eq_apply_kernel<T, H, HC><<<grid, kThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)w, (const float*)rowmax,
      (const float*)rowsum, (const uint8_t*)km, (float*)out, ne, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int apply(const void* q, const void* k, const void* v, const void* w, const void* rowmax,
          const void* rowsum, const void* km, void* out, int na, int ne, int h, int n,
          int m, int hc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // bf16 at head width 64 takes the tc form, everything else (float32, head
  // widths 16 and 32) the CUDA cores
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (h == 4 && hc == 64)
      return eq_tc::launch_apply(q, k, v, w, rowmax, rowsum, km, out, na, ne, n, m, st);
  }
  if (h == 4 && hc == 64)
    return launch_apply<T, 4, 64>(q, k, v, w, rowmax, rowsum, km, out, na, ne, n, m, st);
  if (h == 4 && hc == 32)
    return launch_apply<T, 4, 32>(q, k, v, w, rowmax, rowsum, km, out, na, ne, n, m, st);
  if (h == 4 && hc == 16)
    return launch_apply<T, 4, 16>(q, k, v, w, rowmax, rowsum, km, out, na, ne, n, m, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int se3et_eq_attention_stats_bf16(
    const void* q, const void* k, const void* qm, const void* km, const void* sq,
    const void* sk, void* rowmax, void* rowsum, void* gpart, void* spart, int na, int ne,
    int h, int n, int m, int hc, int mode, void* stream) {
  return stats<__nv_bfloat16>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na, ne,
                              h, n, m, hc, mode, stream);
}

extern "C" int se3et_eq_attention_stats_f32(
    const void* q, const void* k, const void* qm, const void* km, const void* sq,
    const void* sk, void* rowmax, void* rowsum, void* gpart, void* spart, int na, int ne,
    int h, int n, int m, int hc, int mode, void* stream) {
  return stats<float>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na, ne, h, n, m,
                      hc, mode, stream);
}

extern "C" int se3et_eq_attention_apply_bf16(
    const void* q, const void* k, const void* v, const void* w, const void* rowmax,
    const void* rowsum, const void* km, void* out, int na, int ne, int h, int n, int m,
    int hc, void* stream) {
  return apply<__nv_bfloat16>(q, k, v, w, rowmax, rowsum, km, out, na, ne, h, n, m, hc,
                              stream);
}

extern "C" int se3et_eq_attention_apply_f32(
    const void* q, const void* k, const void* v, const void* w, const void* rowmax,
    const void* rowsum, const void* km, void* out, int na, int ne, int h, int n, int m,
    int hc, void* stream) {
  return apply<float>(q, k, v, w, rowmax, rowsum, km, out, na, ne, h, n, m, hc, stream);
}

// K6's pooled partial slots per (a, e) at N query rows, as the kernel that
// takes (h, hc, bf16) writes them (the wrapper's
// eq_attention.eq_attention_stats_parts is held against it); 0 where none
extern "C" int se3et_eq_attention_stats_parts(int h, int n, int hc, int bf16) {
  if (h != 4 || (hc != 64 && hc != 32 && hc != 16)) return 0;
  if (bf16 && hc == 64) return (n + eq_tc::kRows - 1) / eq_tc::kRows;
  return (n + kWarps - 1) / kWarps;
}

// the tc form's shared memory at M keys (eq_attention.eq_stats_smem_bytes)
extern "C" long long se3et_eq_attention_stats_smem(int m) {
  return (long long)eq_tc::smem_bytes(m);
}

// blocks of the tc form resident per SM at M keys (-1 on a CUDA error)
extern "C" int se3et_eq_attention_stats_blocks_per_sm(int m) {
  return eq_tc::blocks_per_sm(m);
}

// K7's tc form: its shared memory at M keys (eq_attention.eq_apply_smem_bytes)
extern "C" long long se3et_eq_attention_apply_smem(int m) {
  return (long long)eq_tc::apply_smem_bytes(m);
}

// blocks of K7's tc form resident per SM at M keys (-1 on a CUDA error)
extern "C" int se3et_eq_attention_apply_blocks_per_sm(int m) {
  return eq_tc::apply_blocks_per_sm(m);
}
