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
// * the "tc" forms, bf16 with H = 4, at head widths 64 (se3ete) and 32 (the
//   wide-head family se3ete2): K6 eq_stats_tc_kernel<HC> (TMA key tiles of
//   all heads, mma.sync, base-2 softmax; each width its plan, StatsPlan<HC>:
//   at 32 under the 64-byte swizzle, in 128-key tiles, q in registers, a
//   rescale vote a head, on warp-uniform branches); K7 eq_apply_tc_kernel<HC>: TMA key and value
//   tiles of one head, wgmma for q k^T and p v, base-2 exps (at 32 in
//   128-key tiles under the 64-byte swizzle, on warp-uniform branches);
// * the "cuda" forms, everything else (float32; head width 16 in either
//   type): the CUDA-core kernels, one block per (a[, e], 8 query rows), one
//   warp per query row, one lane per key of a 32-key tile, key rows read
//   through L1 (the block's warps walk the same tile), the query row as
//   warp-wide broadcasts, K6's softmax statistics online (running max and
//   rescaled sum), K7's tile probabilities staged in shared memory for a
//   lane-per-value-pair p . v (below head width 64 the lanes from HC / 2 on
//   hold no pair).  The first designs, kept for float32 and head width 16,
//   are also reachable in bf16 through se3et_eq_attention_stats_cuda_bf16
//   and se3et_eq_attention_apply_cuda_bf16.
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
// K6's serving forms, "tc" (bf16, H = 4, head widths 64 and 32).
//
// Bound: exponentials.  Every score with a valid key takes one exp: 151 M at
// either serving shape, at 16 per clock per SM (132 SMs, 1.98 GHz) 36 us;
// the products take 19.5 us at the tensor-core peak at head width 64, 9.8
// at 32.  At 64 (se3ete), with 16 query rows per warp, each warp reads the
// k tile from shared memory for itself (by ldmatrix, 8 bytes per score and
// head, plus its q tile, 4 more), which with the exps and the float32 work
// per score is what the time is made of.  At 32 (the wide-head family
// se3ete2) a key row is 64 bytes: its k fragments are 4 bytes per score and
// head, and q sits in registers (4 heads x 2 k-steps x 4 registers a lane),
// ~18 us of shared memory under the exps' 36.  What holds it there is each
// warp's chain, products -> maxima -> exps: without the mma a warp runs in
// ~60 % of the time, without the exps in ~80 % (scripts/probe_eq_attention.py
// --kernel k6w: the variants and ablations, NVIDIA H100 80GB HBM3, 700 W).
// So at 32 each head votes on its own rescale: its exps start while the
// later heads' products are still on the tensor cores (6 % on one vote a
// step); 128-key tiles (32 KB, 4 slots) take fewer ring waits a key.
//
// Work: per key anchor e, A * ceil(N / kUnitRows) warp units (anchor a,
// kUnitRows query rows).  One block per SM: E x bpe blocks, bpe = SMs / E,
// each of one producer warp and kConsumers consumer warps that all take
// units of one e; in each pass the block streams k[e] once and each
// consumer warp computes one unit, passes repeating until e's units are
// spent (at the serving shape 132 blocks, 384 16-row units per e over 22 x
// 9 warps: two passes, and no warp takes more than two units).  No block
// barrier after the set-up:
// * producer (one lane): per pass every key tile of k[e] that holds a valid
//   key, as one TMA tensor copy (H heads x kKeys keys x HC channels, under
//   the swizzle of the row width: 16-byte chunk c of key row r at c ^ (r &
//   7) for 128-byte rows, c ^ ((r >> 1) & 3) for 64-byte rows) into a ring
//   of kStages slots, with full / empty mbarriers;
// * consumers: the unit's q rows (H heads) copied once into the warp's own
//   swizzled shared tile, or held in registers; per 32 keys of a staged
//   tile (a step), every head's S = q k^T first (A and B fragments by
//   ldmatrix.x4, free of bank conflicts under the swizzle; mma.sync
//   m16n8k16, 16 independent accumulator chains), then the head sum for
//   positive() (with sup the weighted one), the masked maxima and the sums
//   2^((s - ref) * scale * log2 e): one FFMA and one ex2.approx (one MUFU
//   op) per score.  Each lane keeps its own reference max per row, moved
//   (with a rescale of its sum) only when a step's max passes it by kSlack,
//   decided by one warp vote per step (at 32 one per step and head); the
//   lanes' sums and true maxima are merged across the quad once per unit.
// The key mask is staged once per block as bits: tiles without a valid key
// are skipped by producer and consumers alike, steps without one by the
// consumers, a partial step is masked by selection.  rowmax stays in the
// plain version's units (scale * q . k).  Each 16-row m-tile writes one
// pooled partial, already divided by the valid (n, m) count, so the wrapper
// only sums them; with sup one partial max.  At 32 every consumer branch is
// warp-uniform (values broadcast from lane 0 or voted, every lane arrives
// on an empty barrier, the waits trap without a message), as K7's form
// there.
namespace eq_tc {

using bf16 = __nv_bfloat16;
constexpr int kH = 4;
// K6's plan at head width 64 (se3ete's EQ cross layers) and at 32 (the
// wide-head family se3ete2's); scripts/probe_eq_attention.py builds the
// source with each setting changed and times the variants in turns
constexpr int kStatsKeys = 32;  // keys per staged tile, whole 32-key steps
constexpr int kStatsStages = 8;  // ring slots
constexpr int kStatsConsumers = 9;  // consumer warps per block
constexpr int kStatsMT = 1;  // 16-row m-tiles per warp unit, sharing each k fragment
constexpr bool kStatsQInSmem = true;  // q fragments from shared memory (else registers)
constexpr int kStats32Keys = 128;
constexpr int kStats32Stages = 4;
constexpr int kStats32Consumers = 9;
constexpr int kStats32MT = 1;
constexpr bool kStats32QInSmem = false;
constexpr bool kStats32HeadVote = true;  // one rescale vote a head (else a step)
constexpr bool kPersistent = true;  // one block walks every pass
// a lane's reference max moves only where a step's max passes it by this
// much in scaled units (scale * q . k), so its sum stays below 2^(8 log2 e)
// = 2^11.5 between rescales at every width
constexpr float kSlackScaled = 8.f;
constexpr int kRows = 16;  // query rows per m-tile (one pooled partial)
constexpr int kStepKeys = 32;  // keys per consumer step (one key-mask word)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can have

// K6's plan at head width HC (64: se3ete's EQ cross layers, 32: se3ete2's)
template <int HC>
struct StatsPlan {
  static constexpr bool k64 = HC == 64;
  static constexpr int kKeys = k64 ? kStatsKeys : kStats32Keys;
  static constexpr int kStages = k64 ? kStatsStages : kStats32Stages;
  static constexpr int kConsumers = k64 ? kStatsConsumers : kStats32Consumers;
  static constexpr int kMT = k64 ? kStatsMT : kStats32MT;
  static constexpr bool kQInSmem = k64 ? kStatsQInSmem : kStats32QInSmem;
  static constexpr bool kHeadVote = !k64 && kStats32HeadVote;
  // every branch of a consumer warp on a value ptxas can prove the same in
  // all its lanes
  static constexpr bool kUniform = !k64;
  static constexpr float kScale = k64 ? 0.125f : 0.17677669529663687f;  // 1 / sqrt(HC)
  static constexpr float kSlack = kSlackScaled / kScale;  // raw q . k: 64 at 64, 45.25 at 32
  static constexpr int kUnitRows = kRows * kMT;
  static constexpr int kThreads = (kConsumers + 1) * 32;
  static constexpr int kWords = kKeys / kStepKeys;  // key-mask words (steps) per tile
  static constexpr int kKSteps = HC / 16;  // k-steps of q k^T
  static constexpr uint32_t kRowBytes = HC * sizeof(bf16);  // a key row: the swizzle span
  static constexpr uint32_t kStageBytes = (uint32_t)kH * kKeys * kRowBytes;
  static constexpr uint32_t kQBytes = (uint32_t)kH * kUnitRows * kRowBytes;  // per warp
  static_assert((HC == 64 || HC == 32) && kKeys % kStepKeys == 0 && kKeys <= 256,
                "64 or 32 channels, whole 32-key steps, a TMA box of at most 256 keys");
  static_assert(kQInSmem || kMT == 1, "q in registers holds one m-tile");
};

// the shared-memory plan at head width HC, byte offsets from the block's
// 1024-aligned base (mirrored by the wrapper's eq_attention.eq_stats_smem_bytes):
// the ring, q tiles (kQInSmem), the key-mask bits, 2 * kStages mbarriers,
// two counts
template <int HC>
__host__ __device__ inline size_t mask_off() {
  using P = StatsPlan<HC>;
  return (size_t)P::kStages * P::kStageBytes +
         (P::kQInSmem ? (size_t)P::kConsumers * P::kQBytes : 0);
}
template <int HC>
__host__ __device__ inline int tiles(int m) {
  return (m + StatsPlan<HC>::kKeys - 1) / StatsPlan<HC>::kKeys;
}
template <int HC>
__host__ __device__ inline size_t bar_off(int m) {
  return mask_off<HC>() + (((size_t)tiles<HC>(m) * StatsPlan<HC>::kWords * 4 + 7) & ~(size_t)7);
}
template <int HC>
__host__ __device__ inline size_t smem_bytes(int m) {
  return 1024 + bar_off<HC>(m) + 2 * StatsPlan<HC>::kStages * sizeof(uint64_t) + 2 * sizeof(int);
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

// the 16-byte chunk at which chunk c of row r of a tile of HC-channel rows
// lands under the TMA swizzle of its row width: 128 bytes at 64 (c ^ (r &
// 7)), 64 bytes at 32 (c ^ ((r >> 1) & 3): 512-byte atoms of 8 rows)
template <int HC>
__host__ __device__ constexpr int swz(int c, int r) {
  return HC == 64 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}

// Fragment addressing of a swizzled tile of HC-channel rows, for lane
// `lane`: the row it addresses within a group of 16 and its chunk offsets
// for the k-steps kk (channels 16 kk .. 16 kk + 15).
// * A (16 rows x 16 channels, q): lanes 0-15 rows 0-15 at chunk 2 kk,
//   lanes 16-31 the same rows at chunk 2 kk + 1: r = a0..a3 of mma.m16n8k16;
// * B (two n-tiles of 8 keys, k): lanes 0-7 / 8-15 keys 0-7 at chunks 2 kk /
//   2 kk + 1, lanes 16-23 / 24-31 keys 8-15 the same: r = b0, b1 of the
//   first n-tile, then of the second.
// A row's swizzle depends on its index mod 8: lane & 7 for both (written so,
// ptxas schedules the kernel at 64 as fast as before it took the width as a
// parameter; with the rows themselves it did not), and rows at a multiple of
// 8 from these keep their chunk offsets.
template <int HC>
struct Frag {
  int a_row, b_row;
  uint32_t a_off[HC / 16], b_off[HC / 16];
  __device__ explicit Frag(int lane) {
    a_row = lane & 15;
    b_row = ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk) {
      a_off[kk] = (uint32_t)(swz<HC>(2 * kk + (lane >> 4), lane & 7) << 4);
      b_off[kk] = (uint32_t)(swz<HC>(2 * kk + ((lane >> 3) & 1), lane & 7) << 4);
    }
  }
};

// whether a tile of kW mask words holds no valid key / only valid keys
template <int kW>
__device__ __forceinline__ bool tile_empty(const uint32_t* w) {
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) any |= w[i];
  return any == 0;
}

template <int kW>
__device__ __forceinline__ bool tile_full(const uint32_t* w) {
  uint32_t all = ~0u;
#pragma unroll
  for (int i = 0; i < kW; ++i) all &= w[i];
  return all == ~0u;
}

// `b` as lane 0 of the warp holds it where kOn: a value ptxas can prove the
// same in every lane, so that a branch on it is no divergent path among the
// warp's (or warpgroup's) products
template <bool kOn>
__device__ __forceinline__ uint32_t lane0(uint32_t b) {
  if constexpr (kOn)
    return __shfl_sync(0xffffffffu, b, 0);
  else
    return b;
}

// mbar_wait that traps after about 2^33 cycles, without mbar_wait_or_trap's
// message: its printf, an extern call, would make ptxas serialise every
// wgmma of a kernel.  kWarp: the whole warp waits, and leaves when every
// lane has seen the phase complete, by a vote (a uniform branch)
template <bool kWarp>
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (kWarp ? __all_sync(0xffffffffu, done) : done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// a ring wait by the producer's lane (`what` 0) or a whole consumer warp
// (`what` 1): named in mbar_wait_or_trap's message, or with kUniform
// without one, the consumer warp leaving at once
template <bool kUniform>
__device__ __forceinline__ void ring_wait(uint64_t* bar, uint32_t parity, int what) {
  if constexpr (!kUniform)
    mbar_wait_or_trap(bar, parity, what);
  else if (what == 0)
    mbar_wait_bounded<false>(bar, parity);
  else
    mbar_wait_bounded<true>(bar, parity);
}

// a consumer warp's arrival on an empty barrier: lane 0's, or with
// kUniform every lane's (no divergent path; the barrier then counts 32
// arrivals a warp)
template <bool kUniform>
__device__ __forceinline__ void ring_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (kUniform || lane == 0) mbar_arrive(bar);
}

// a consumer warp's state over one unit, per m-tile, head and row (g /
// g + 8), in raw q . k units: the lane's sum of 2^((s - ref) * scale *
// log2 e) over its keys, its reference max `ref` (moved only where a lane's
// step max passes ref + kSlack, so the sums stay below 2^(kSlack * scale *
// log2 e) without a rescale per step), and its true max; merged across the
// quad at the end
template <int HC, bool kSup>
struct Unit {
  static constexpr int kMT = StatsPlan<HC>::kMT;
  float l[kMT][kH][2], ref[kMT][kH][2], top[kMT][kH][2];
  float g[kMT][2];    // pooled sums of rows g / g + 8
  float sup[kMT][2];  // raw weighted-head-sum maxima
  float wsup[kH];
};

// The unit's work on one 32-key step (all heads) at key `key0` of the
// staged tile at `slot`.  kMasked: select the step's valid keys (bits in
// w); otherwise every key is valid.  q comes from the warp's swizzled tile
// `qs` ([head][m-tile][16 rows][HC]) or, with one m-tile, from registers
// `qf`.
template <int HC, int kMode, bool kSup, bool kMasked>
__device__ __forceinline__ void tile_step(uint32_t slot, int key0,
                                          const uint32_t (&qf)[kH][HC / 16][4], uint32_t qs,
                                          const Frag<HC>& fr, uint32_t w, int t, float c2,
                                          float hscale, int mode, Unit<HC, kSup>& u) {
  using P = StatsPlan<HC>;
  constexpr int kMT = P::kMT, kNT = kStepKeys / 8;
  const uint32_t bits = w >> (2 * t);
  auto valid = [&](int jn, int i) -> bool { return (bits >> ((jn << 3) + i)) & 1u; };
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
    for (int kk = 0; kk < P::kKSteps; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if constexpr (P::kQInSmem) {
          ldsm_x4(a[mt], qs + ((h * kMT + mt) * kRows + fr.a_row) * P::kRowBytes + fr.a_off[kk]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[mt][i] = qf[h][kk][i];
        }
      }
#pragma unroll
      for (int jn = 0; jn < kNT; jn += 2) {
        uint32_t b[4];
        ldsm_x4(b, slot + (h * P::kKeys + key0 + 8 * jn + fr.b_row) * P::kRowBytes +
                       fr.b_off[kk]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][h][jn], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);
          mma_bf16(s[mt][h][jn + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[2], b[3]);
        }
      }
    }
  // head sums, masking, the lanes' maxima; one vote for the whole step, or
  // with kHeadVote one a head, so that a head's exps can start while the
  // later heads' products are still on the tensor cores
  float hs[kMT][kNT][4], ss[kMT][kNT][4], mx[kMT][kH][2];
  // head h's rescale, where some lane's max passes its reference by kSlack
  auto rescale = [&](int mt, int h) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float ref = fmaxf(u.ref[mt][h][r], mx[mt][h][r]);
      u.l[mt][h][r] *= ex2((u.ref[mt][h][r] - ref) * c2);
      u.ref[mt][h][r] = ref;
    }
  };
  auto exps = [&](int mt, int h) {
    const float ca = -u.ref[mt][h][0] * c2, cb = -u.ref[mt][h][1] * c2;
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn) {
      suma += ex2(fmaf(s[mt][h][jn][0], c2, ca)) + ex2(fmaf(s[mt][h][jn][1], c2, ca));
      sumb += ex2(fmaf(s[mt][h][jn][2], c2, cb)) + ex2(fmaf(s[mt][h][jn][3], c2, cb));
    }
    u.l[mt][h][0] += suma;
    u.l[mt][h][1] += sumb;
  };
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
        moved |= mx[mt][h][r] > u.ref[mt][h][r] + P::kSlack;
      }
      if constexpr (P::kHeadVote) {
        if (__any_sync(0xffffffffu, moved)) rescale(mt, h);
        moved = false;
        exps(mt, h);
      }
    }
  if constexpr (!P::kHeadVote) {
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < kH; ++h) rescale(mt, h);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < kH; ++h) exps(mt, h);
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

// q (A,H,N,HC), k (E,H,M,HC) behind `map`, qmask (N), kmask (M) as bytes,
// sup_q (A,H) / sup_k (E,H) when kSup; rowmax/rowsum (A,E,H,N); gpart/spart
// (A,E,ceil(N/16)).  kMode: the positive() mode, or -1 for `mode` at run time.
template <int HC, int kMode, bool kSup>
__global__ void __launch_bounds__(StatsPlan<HC>::kThreads, 1)
eq_stats_tc_kernel(const __grid_constant__ CUtensorMap map, const bf16* __restrict__ q,
                   const uint8_t* __restrict__ qmask, const uint8_t* __restrict__ kmask,
                   const float* __restrict__ sup_q, const float* __restrict__ sup_k,
                   float* __restrict__ rowmax, float* __restrict__ rowsum,
                   float* __restrict__ gpart, float* __restrict__ spart, int na, int ne, int n,
                   int mlen, int bpe, int passes, int mode) {
  using P = StatsPlan<HC>;
  extern __shared__ char smem_raw[];
  char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(base + mask_off<HC>());
  uint64_t* full = reinterpret_cast<uint64_t*>(base + bar_off<HC>(mlen));
  uint64_t* empty = full + P::kStages;
  int* counts = reinterpret_cast<int*>(empty + P::kStages);  // valid query rows, valid keys

  const int warp = lane0<P::kUniform>(threadIdx.x / 32), lane = threadIdx.x % 32;
  const int per_pass = ne * bpe;
  const int p0 = kPersistent ? 0 : blockIdx.x / per_pass;
  const int p_end = kPersistent ? passes : p0 + 1;
  const int bid = blockIdx.x % per_pass;
  const int e = bid / bpe, lb = bid - e * bpe;
  const int rblocks = (n + P::kUnitRows - 1) / P::kUnitRows;
  const int units = na * rblocks;  // per e
  const int parts = (n + kRows - 1) / kRows;  // pooled partial slots per (a, e)
  const int ntiles = tiles<HC>(mlen);

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P::kConsumers * (P::kUniform ? 32 : 1));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    counts[0] = counts[1] = 0;
  }
  __syncthreads();
  // the key mask as bits (zero past mlen) and both valid counts
  int kc = 0;
  for (int wd = warp; wd < ntiles * P::kWords; wd += P::kConsumers + 1) {
    const int key = 32 * wd + lane;
    const uint32_t b = __ballot_sync(0xffffffffu, key < mlen && kmask[key] != 0);
    if (lane == 0) mask_s[wd] = b;
    kc += __popc(b);
  }
  int qc = 0;
  for (int i = threadIdx.x; i < n; i += P::kThreads) qc += qmask[i] != 0;
  qc = __reduce_add_sync(0xffffffffu, qc);
  if (lane == 0) {
    atomicAdd(&counts[0], qc);
    atomicAdd(&counts[1], kc);
  }
  __syncthreads();

  if (warp == P::kConsumers) {  // the producer
    if (lane != 0) return;
    int s = 0;
    for (int pass = p0; pass < p_end && (pass * bpe + lb) * P::kConsumers < units; ++pass)
      for (int j = 0; j < ntiles; ++j) {
        if (tile_empty<P::kWords>(mask_s + j * P::kWords)) continue;
        const int slot = s % P::kStages;
        if (s >= P::kStages) ring_wait<P::kUniform>(&empty[slot], ((s / P::kStages) - 1) & 1, 0);
        mbar_expect_tx(&full[slot], P::kStageBytes);
        load_tile(base + (size_t)slot * P::kStageBytes, &map, j * P::kKeys, 0, e, &full[slot]);
        ++s;
      }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const float scale = P::kScale;
  const float c2 = scale * kLog2e;
  const float hscale = scale / kH;
  const float inv_count = 1.f / ((float)counts[0] * (float)counts[1] + 1e-9f);
  char* qs = P::kQInSmem ? base + (size_t)P::kStages * P::kStageBytes + (size_t)warp * P::kQBytes
                         : nullptr;
  const uint32_t qs_u32 = P::kQInSmem ? smem_u32(qs) : 0u;
  const Frag<HC> fr(lane);
  int s = 0;
  for (int pass = p0; pass < p_end && (pass * bpe + lb) * P::kConsumers < units; ++pass) {
    const int unit = (pass * bpe + lb) * P::kConsumers + warp;
    const bool active = unit < units;
    const int a = active ? unit / rblocks : 0;
    const int rb = unit - a * rblocks;
    const int row0 = rb * P::kUnitRows;
    const bf16* qa = q + (long long)a * kH * n * HC;
    uint32_t qf[kH][HC / 16][4];  // q in registers (!kQInSmem): a0..a3 per head and k-step
    Unit<HC, kSup> u;
    if (active) {
      if constexpr (P::kQInSmem) {
        constexpr int kChunks = HC / 8;  // 16-byte chunks of a row
        __syncwarp();
        for (int idx = lane; idx < kH * P::kUnitRows * kChunks; idx += 32) {
          const int h = idx / (P::kUnitRows * kChunks), r = (idx / kChunks) % P::kUnitRows,
                    ch = idx % kChunks;
          const int row = row0 + r;
          *reinterpret_cast<uint4*>(qs + (h * P::kUnitRows + r) * P::kRowBytes +
                                    (swz<HC>(ch, r) << 4)) =
              ld16(qa + ((long long)h * n + row) * HC + 8 * ch, row < n);
        }
        __syncwarp();
      } else {
        const int ra = row0 + g, rbw = ra + 8;
        auto q32 = [&](int h, int row, int c) -> uint32_t {
          return row < n ? __ldg(reinterpret_cast<const unsigned int*>(
                               qa + ((long long)h * n + row) * HC + c))
                         : 0u;
        };
#pragma unroll
        for (int h = 0; h < kH; ++h)
#pragma unroll
          for (int kk = 0; kk < P::kKSteps; ++kk) {
            qf[h][kk][0] = q32(h, ra, 16 * kk + 2 * t);
            qf[h][kk][1] = q32(h, rbw, 16 * kk + 2 * t);
            qf[h][kk][2] = q32(h, ra, 16 * kk + 8 + 2 * t);
            qf[h][kk][3] = q32(h, rbw, 16 * kk + 8 + 2 * t);
          }
      }
#pragma unroll
      for (int mt = 0; mt < P::kMT; ++mt) {
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
      const uint32_t* w = mask_s + j * P::kWords;
      if (lane0<P::kUniform>(tile_empty<P::kWords>(w))) continue;
      const int slot = s % P::kStages;
      ring_wait<P::kUniform>(&full[slot], (s / P::kStages) & 1, 1);
      if (active) {
        const uint32_t sb = smem_u32(base) + (uint32_t)slot * P::kStageBytes;
#pragma unroll 1
        for (int i = 0; i < P::kWords; ++i) {  // the tile's 32-key steps
          const uint32_t wd = lane0<P::kUniform>(w[i]);
          if (wd == ~0u)
            tile_step<HC, kMode, kSup, false>(sb, kStepKeys * i, qf, qs_u32, fr, wd, t, c2,
                                              hscale, mode, u);
          else if (wd != 0u)
            tile_step<HC, kMode, kSup, true>(sb, kStepKeys * i, qf, qs_u32, fr, wd, t, c2,
                                             hscale, mode, u);
        }
      }
      ring_arrive<P::kUniform>(&empty[slot], lane);
      ++s;
    }
    if (!active) continue;
#pragma unroll
    for (int mt = 0; mt < P::kMT; ++mt) {
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
      const int part = rb * P::kMT + mt;
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

// A TMA map of x (E, 4, M, hc) bf16 (16-byte aligned; hc 64 or 32) whose
// box is `keys` keys of `heads` heads of one anchor, each row swizzled over
// its own width (128 bytes at hc 64, 64 bytes at 32); 0 or a CUDA error
static int encode_map(CUtensorMap* map, const void* x, int ne, int m, int keys, int heads,
                      int hc) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hc, (cuuint64_t)m, (cuuint64_t)kH, (cuuint64_t)ne};
  const cuuint64_t strides[3] = {hc * sizeof(bf16), (cuuint64_t)m * hc * sizeof(bf16),
                                 (cuuint64_t)kH * m * hc * sizeof(bf16)};
  const cuuint32_t box[4] = {(cuuint32_t)hc, (cuuint32_t)keys, (cuuint32_t)heads, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      hc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// (blocks per key anchor, passes) of K6's grid at head width HC for A
// anchors, E key anchors, N query rows
template <int HC>
static void plan(int na, int ne, int n, int* bpe, int* passes) {
  using P = StatsPlan<HC>;
  const int units = na * ((n + P::kUnitRows - 1) / P::kUnitRows);
  const int most = (units + P::kConsumers - 1) / P::kConsumers;  // blocks with a unit
  *bpe = std::max(1, std::min(sm_count() / ne, most));
  *passes = (units + *bpe * P::kConsumers - 1) / (*bpe * P::kConsumers);
}

// static: each instance raises its shared-memory attribute once per process
template <int HC, int kMode, bool kSup>
static int launch_mode(const CUtensorMap& map, const void* q, const void* qm, const void* km,
                       const void* sq, const void* sk, void* rowmax, void* rowsum,
                       void* gpart, void* spart, int na, int ne, int n, int m, int mode,
                       cudaStream_t st) {
  const size_t smem = smem_bytes<HC>(m);
  static size_t attr = 0;
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        eq_stats_tc_kernel<HC, kMode, kSup>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  int bpe, passes;
  plan<HC>(na, ne, n, &bpe, &passes);
  const int grid = ne * bpe * (kPersistent ? 1 : passes);
  eq_stats_tc_kernel<HC, kMode, kSup><<<grid, StatsPlan<HC>::kThreads, smem, st>>>(
      map, (const bf16*)q, (const uint8_t*)qm, (const uint8_t*)km, (const float*)sq,
      (const float*)sk, (float*)rowmax, (float*)rowsum, (float*)gpart, (float*)spart, na, ne,
      n, m, bpe, passes, mode);
  return (int)cudaGetLastError();
}

// K6 in the tc form at head width HC: k (E, 4, M, HC) bf16, 16-byte aligned
template <int HC>
inline int launch(const void* q, const void* k, const void* qm, const void* km,
                  const void* sq, const void* sk, void* rowmax, void* rowsum, void* gpart,
                  void* spart, int na, int ne, int n, int m, int mode, cudaStream_t st) {
  if (smem_bytes<HC>(m) > (size_t)kMaxSmem || sm_count() == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = encode_map(&map, k, ne, m, StatsPlan<HC>::kKeys, kH, HC);
  if (err) return err;
  const bool sup = sq != nullptr;
  if (mode == 1)
    return sup ? launch_mode<HC, 1, true>(map, q, qm, km, sq, sk, rowmax, rowsum, gpart, spart,
                                          na, ne, n, m, mode, st)
               : launch_mode<HC, 1, false>(map, q, qm, km, sq, sk, rowmax, rowsum, gpart,
                                           spart, na, ne, n, m, mode, st);
  return sup ? launch_mode<HC, -1, true>(map, q, qm, km, sq, sk, rowmax, rowsum, gpart, spart,
                                         na, ne, n, m, mode, st)
             : launch_mode<HC, -1, false>(map, q, qm, km, sq, sk, rowmax, rowsum, gpart, spart,
                                          na, ne, n, m, mode, st);
}

// blocks of the (sq, no sup) kernel at head width HC resident per SM at M
// keys (-1 on a CUDA error)
template <int HC>
inline int blocks_per_sm(int m) {
  const size_t smem = smem_bytes<HC>(m);
  if (cudaFuncSetAttribute(eq_stats_tc_kernel<HC, 1, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return -1;
  int nb = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, eq_stats_tc_kernel<HC, 1, false>,
                                                    StatsPlan<HC>::kThreads, smem) != cudaSuccess)
    return -1;
  return nb;
}

// ---------------------------------------------------------------------------
// K7's serving forms, "tc" (bf16, H = 4, head width 64 or 32).
//
// out[a,h,n] = sum_e w[a,e] / max(rowsum[a,e,h,n], 1e-30)
//              * sum_m round_bf16(exp(s_aeh[n,m] - rowmax[a,e,h,n]) kmask[m]) v[e,h,m]
// (the unscaled probability rounded to bf16 before p v, as on the TPU).
//
// Bound at head width 64 (se3ete): the products (q k^T and p v, 38.7 GFLOP)
// take 39 us at the tensor-core peak and the exps (151 M) 36 us.  On
// mma.sync, with k and v fragments read by ldmatrix, a 16-row warp reads 16
// bytes of shared memory per score (a floor of ~72 us at 128 bytes per
// clock per SM); wgmma reads k and v once per 64-row warpgroup, a quarter
// of that, and runs the products at the full tensor-core rate.  What is
// left is the chain within a warpgroup, q k^T -> exp -> p v, each step
// waiting for the one before (scripts/probe_eq_attention.py: the variants
// and ablations).
//
// At head width 32 (se3ete2) the products halve (19.3 GFLOP, 20 us) and
// the exps do not (151 M, 36 us at 16 per clock per SM): the SFU bounds the
// kernel.  Rows of k and v are 64 bytes there: their tiles are staged under
// the 64-byte swizzle (16-byte chunk c of key row r at c ^ ((r >> 1) & 3),
// 512-byte atoms of 8 rows); tiles of 128 keys halve the waits per key
// (q k^T one wgmma.m64n128k16 per k-step, p v on wgmma.m64n32k16).  What
// the chain leaves to the SFU depends on the tensor cores taking every
// wgmma without a wait in between: ptxas serialises a kernel's wgmma where
// one sits on a branch it cannot prove warp-uniform (the warp index, the
// mask words read per lane, lane 0's arrival: C7520), where its printf is
// (mbar_wait_or_trap's message), or where another instruction writes an
// accumulator in flight.  So at 32 the consumers branch on values
// broadcast from lane 0 or voted (ApplyPlan::kUniform), every lane arrives
// on an empty barrier, and the waits trap without a message.  A warpgroup
// that pipelines its tiles (tile j + 1's q k^T issued before tile j's exps)
// needs two score tiles a thread, more than the 128 registers that 13 warps
// leave it, and ptxas then serialises the wgmma again (C7512): it lost to
// the plain chain (PERF.md).
//
// Work: per head h, A * ceil(N / 64) units (anchor a, 64 query rows), one
// per warpgroup, each looping over every key anchor e; each warp owns 16 of
// the unit's rows: its o (16 x HC float32) sums one e's p v, and at the end
// of each e its acc takes w[a,e] / rowsum * o.  One block per SM, grouped
// by head: H x bph blocks (bph = SMs / H), each of one producer warp and
// kConsumers consumer warps (three warpgroups) that all take units of one
// head; in each pass the block streams k[e, h] and v[e, h] once for every e
// and each warpgroup computes one unit (at the serving shape 96 units per
// head over 32 x 3 warpgroups: one pass, ~212 MB through L2 per launch at
// head width 64).  No block barrier after the set-up:
// * producer (one lane): per pass and e, every key tile holding a valid
//   key, as two TMA tensor copies (k and v, kKeys keys x HC channels, the
//   swizzle of their row width) into one slot of a ring of kStages, with
//   full / empty mbarriers;
// * consumers: q in registers (the A operand), fetched once per unit;
//   rowmax and rowsum read once per (unit, e); per tile S = q k^T by wgmma
//   (k read from the swizzled slot as a K-major B), p = 2^(s scale log2 e
//   - rowmax log2 e) (one FFMA, one ex2.approx), the mask a select from the
//   staged bits, p rounded to bf16 straight
//   from the accumulators into A fragments, o += p v by wgmma (v read from
//   the slot as an MN-major B).
// The key mask is staged once per block as bits: tiles without a valid key
// are skipped by producer and consumers alike.  Rows >= N are neither read
// nor written.
constexpr int kApplyKeys = 64;  // keys per staged k / v tile: one wgmma N
constexpr int kApplyStages = 4;  // ring slots
constexpr int kApplyConsumers = 12;  // consumer warps per block, whole warpgroups
constexpr bool kApplyPersistent = true;  // one block walks every pass
// head width 32: keys per tile (32, or whole 64-key chunks), ring slots,
// consumer warps
constexpr int kApply32Keys = 128;
constexpr int kApply32Stages = 6;
constexpr int kApply32Consumers = 12;
constexpr int kAUnitRows = 4 * kRows;  // query rows of a warpgroup

// K7's plan at head width HC (64: se3ete's EQ cross layers, 32: se3ete2's)
template <int HC>
struct ApplyPlan {
  static constexpr bool k64 = HC == 64;
  static constexpr int kKeys = k64 ? kApplyKeys : kApply32Keys;
  static constexpr int kStages = k64 ? kApplyStages : kApply32Stages;
  static constexpr int kConsumers = k64 ? kApplyConsumers : kApply32Consumers;
  // every branch of a consumer warp on a value ptxas can prove the same in
  // all its lanes (else ptxas serialises the kernel's wgmma, C7520)
  static constexpr bool kUniform = !k64;
  static constexpr int kThreads = (kConsumers + 1) * 32;
  static constexpr int kUnitsPerBlock = kConsumers / 4;
  static constexpr int kNT = kKeys / 8;  // key n-tiles per tile
  static constexpr int kWords = kKeys / 32;  // key-mask words per tile
  static constexpr int kKSteps = HC / 16;  // k-steps of q k^T
  static constexpr uint32_t kRowBytes = HC * sizeof(bf16);  // a key row: the swizzle span
  static constexpr uint32_t kTileBytes = (uint32_t)kKeys * kRowBytes;  // k or v
  static constexpr uint32_t kSlotBytes = 2 * kTileBytes;
  static constexpr int kChunk = kKeys < 128 ? kKeys : 128;  // keys of one q k^T wgmma
  static_assert((HC == 64 || HC == 32) && kKeys % kChunk == 0 &&
                    (kChunk == 32 || kChunk == 64 || kChunk == 128) &&
                    kKeys <= 256 && kConsumers % 4 == 0,
                "wgmma tiles: chunks of 32, 64 or 128 keys (a TMA box of at most 256 keys), "
                "64 or 32 channels, whole warpgroups");
};

// K7's shared-memory plan at head width HC, byte offsets from the block's
// 1024-aligned base (mirrored by the wrapper's eq_attention.eq_apply_smem_bytes):
// the ring (each slot a k tile, then a v tile), the key-mask bits,
// 2 * kStages mbarriers
template <int HC>
__host__ __device__ inline size_t apply_mask_off() {
  return (size_t)ApplyPlan<HC>::kStages * ApplyPlan<HC>::kSlotBytes;
}
template <int HC>
__host__ __device__ inline int apply_tiles(int m) {
  return (m + ApplyPlan<HC>::kKeys - 1) / ApplyPlan<HC>::kKeys;
}
template <int HC>
__host__ __device__ inline size_t apply_bar_off(int m) {
  return apply_mask_off<HC>() +
         (((size_t)apply_tiles<HC>(m) * ApplyPlan<HC>::kWords * 4 + 7) & ~(size_t)7);
}
template <int HC>
__host__ __device__ inline size_t apply_smem_bytes(int m) {
  return 1024 + apply_bar_off<HC>(m) + 2 * ApplyPlan<HC>::kStages * sizeof(uint64_t);
}

// A wgmma descriptor of a swizzled tile of HC-channel rows at shared address
// `addr`: 2 HC-byte rows under the swizzle of that span (128 bytes at 64
// channels, 64 at 32), atoms of 8 rows 16 HC bytes apart, tiles 1024-byte
// aligned; read K-major (k: the channels of a key contiguous) or MN-major
// (v as B of p v: the channels contiguous along N, one atom wide)
template <int HC>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  constexpr uint64_t atom = 8 * 2 * HC, layout = HC == 64 ? 1 : 2;
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) | ((atom >> 4) << 32) |
         (layout << 62);
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
// keeps the compiler from moving reads or writes of the kN accumulators at
// `d` across the asynchronous products
template <int kN>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// the same at N = 32: d (64 x 32, 16 floats) += a . b (16 x 32 behind `desc`)
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred acc;\n setp.ne.b32 acc, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, acc, 1, 1, %21;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kTransB), "r"(1));
}

// the same at N = 128: d (64 x 128, 64 floats) += a . b (16 x 128 behind `desc`)
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred acc;\n setp.ne.b32 acc, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, acc, 1, 1, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kTransB), "r"(1));
}

// S (64 x kKeys: this warp's 16 rows, n-tile j at s[j]) += q k^T for the k
// tile at `slot`, issued and not waited: per chunk of kChunk keys (one
// wgmma N), HC / 16 k-steps (+32 bytes each within the swizzled rows)
template <int HC>
__device__ __forceinline__ void issue_scores(float (&s)[ApplyPlan<HC>::kNT][4], uint32_t slot,
                                             const uint32_t (&qf)[HC / 16][4]) {
  using P = ApplyPlan<HC>;
  const uint64_t dk = gmma_desc<HC>(slot);
#pragma unroll
  for (int c = 0; c < P::kKeys / P::kChunk; ++c)
#pragma unroll
    for (int kk = 0; kk < P::kKSteps; ++kk) {
      const uint64_t d = dk + (uint64_t)c * (P::kChunk * P::kRowBytes >> 4) + 2 * kk;
      if constexpr (P::kChunk == 128)
        wgmma_rs_n128<0>(&s[16 * c][0], qf[kk], d);
      else if constexpr (P::kChunk == 64)
        wgmma_rs<0>(&s[8 * c][0], qf[kk], d);
      else
        wgmma_rs_n32<0>(&s[4 * c][0], qf[kk], d);
    }
}

// o += p v for the tile's scores turned probabilities `s` and the v tile at
// `vslot`, issued and not waited: p rounded to bf16 straight into A
// fragments, one wgmma per 16 keys
template <int HC>
__device__ __forceinline__ void issue_pv(float (&o)[HC / 8][4],
                                         const float (&s)[ApplyPlan<HC>::kNT][4],
                                         uint32_t vslot) {
  using P = ApplyPlan<HC>;
  const uint64_t dv = gmma_desc<HC>(vslot);
#pragma unroll
  for (int kc = 0; kc < P::kKeys / 16; ++kc) {
    const uint32_t p[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                           pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                           pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                           pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
    const uint64_t d = dv + (uint64_t)kc * (16 * P::kRowBytes >> 4);  // +16 key rows
    if constexpr (HC == 64)
      wgmma_rs<1>(&o[0][0], p, d);
    else
      wgmma_rs_n32<1>(&o[0][0], p, d);
  }
}

// p = 2^(s c2 + nb[row]) in place, nb[r] = -rowmax log2 e of rows g / g + 8;
// kMasked: 0 where the tile's key is masked (bits in w)
template <int HC, bool kMasked>
__device__ __forceinline__ void probs(float (&s)[ApplyPlan<HC>::kNT][4], const uint32_t* w,
                                      int t, float c2, const float (&nb)[2]) {
  using P = ApplyPlan<HC>;
  uint32_t bits[P::kWords];
#pragma unroll
  for (int i = 0; i < P::kWords; ++i) bits[i] = w[i] >> (2 * t);
#pragma unroll
  for (int jn = 0; jn < P::kNT; ++jn)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = ex2(fmaf(s[jn][c], c2, nb[c >> 1]));
      if constexpr (kMasked)
        s[jn][c] = (bits[jn >> 2] >> (((jn & 3) << 3) + (c & 1))) & 1u ? p : 0.f;
      else
        s[jn][c] = p;
    }
}

// o += p v for one staged tile (k at `slot`, v kTileBytes after it) and the
// warpgroup's 64 query rows (this warp's 16), each product waited for: q
// from registers `qf` ([k-step][a0..a3]); kMasked: only the tile's valid
// keys (bits in w) count.
template <int HC, bool kMasked>
__device__ __forceinline__ void apply_step(uint32_t slot, const uint32_t (&qf)[HC / 16][4],
                                           const uint32_t* w, int t, float c2,
                                           const float (&nb)[2], float (&o)[HC / 8][4]) {
  using P = ApplyPlan<HC>;
  float s[P::kNT][4];
#pragma unroll
  for (int jn = 0; jn < P::kNT; ++jn) s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;
  fence_regs<P::kNT * 4>(&s[0][0]);
  wgmma_fence();
  issue_scores<HC>(s, slot, qf);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<P::kNT * 4>(&s[0][0]);
  probs<HC, kMasked>(s, w, t, c2, nb);
  fence_regs<HC / 2>(&o[0][0]);
  wgmma_fence();
  issue_pv<HC>(o, s, slot + P::kTileBytes);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<HC / 2>(&o[0][0]);
}

// q (A,H,N,HC), k / v (E,H,M,HC) behind kmap / vmap, w (A,E), rowmax/rowsum
// (A,E,H,N), kmask (M) as bytes; out (A,H,N,HC) float32.
template <int HC>
__global__ void __launch_bounds__(ApplyPlan<HC>::kThreads, 1)
eq_apply_tc_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
                   const float* __restrict__ w, const float* __restrict__ rowmax,
                   const float* __restrict__ rowsum, const uint8_t* __restrict__ kmask,
                   float* __restrict__ out, int na, int ne, int n, int mlen, int bph,
                   int passes) {
  using P = ApplyPlan<HC>;
  extern __shared__ char smem_raw[];
  char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(base + apply_mask_off<HC>());
  uint64_t* full = reinterpret_cast<uint64_t*>(base + apply_bar_off<HC>(mlen));
  uint64_t* empty = full + P::kStages;

  const int warp = lane0<P::kUniform>(threadIdx.x / 32), lane = threadIdx.x % 32;
  const int per_pass = kH * bph;
  const int p0 = kApplyPersistent ? 0 : blockIdx.x / per_pass;
  const int p_end = kApplyPersistent ? passes : p0 + 1;
  const int bid = blockIdx.x % per_pass;
  const int h = bid / bph, lb = bid - h * bph;
  const int rblocks = (n + kAUnitRows - 1) / kAUnitRows;
  const int units = na * rblocks;  // per head
  const int ntiles = apply_tiles<HC>(mlen);

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P::kConsumers * (P::kUniform ? 32 : 1));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the key mask as bits (zero past mlen)
  for (int wd = warp; wd < ntiles * P::kWords; wd += P::kConsumers + 1) {
    const int key = 32 * wd + lane;
    const uint32_t b = __ballot_sync(0xffffffffu, key < mlen && kmask[key] != 0);
    if (lane == 0) mask_s[wd] = b;
  }
  __syncthreads();

  if (warp == P::kConsumers) {  // the producer
    if (lane != 0) return;
    int s = 0;
    for (int pass = p0; pass < p_end && (pass * bph + lb) * P::kUnitsPerBlock < units; ++pass)
      for (int e = 0; e < ne; ++e)
        for (int j = 0; j < ntiles; ++j) {
          if (tile_empty<P::kWords>(mask_s + j * P::kWords)) continue;
          const int slot = s % P::kStages;
          if (s >= P::kStages) ring_wait<P::kUniform>(&empty[slot], ((s / P::kStages) - 1) & 1, 0);
          mbar_expect_tx(&full[slot], P::kSlotBytes);
          char* dst = base + (size_t)slot * P::kSlotBytes;
          load_tile(dst, &kmap, j * P::kKeys, h, e, &full[slot]);
          load_tile(dst + P::kTileBytes, &vmap, j * P::kKeys, h, e, &full[slot]);
          ++s;
        }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const float c2 = (1.f / sqrtf((float)HC)) * kLog2e;  // the score scale in base 2
  int s = 0;
  for (int pass = p0; pass < p_end && (pass * bph + lb) * P::kUnitsPerBlock < units; ++pass) {
    const int unit = (pass * bph + lb) * P::kUnitsPerBlock + warp / 4;
    const bool active = unit < units;  // the same for the warpgroup's four warps
    const int a = active ? unit / rblocks : 0;
    const int ra = (unit - a * rblocks) * kAUnitRows + (warp % 4) * kRows + g, rb = ra + 8;
    const bool va = active && ra < n, vb = active && rb < n;
    const bf16* qh = q + ((long long)a * kH + h) * n * HC;
    auto q32 = [&](bool ok, int row, int c) -> uint32_t {
      return ok ? __ldg(reinterpret_cast<const unsigned int*>(qh + (long long)row * HC + c))
                : 0u;
    };
    uint32_t qf[HC / 16][4];  // the A fragments of this warp's rows: a0..a3 per k-step
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk) {
      qf[kk][0] = q32(va, ra, 16 * kk + 2 * t);
      qf[kk][1] = q32(vb, rb, 16 * kk + 2 * t);
      qf[kk][2] = q32(va, ra, 16 * kk + 8 + 2 * t);
      qf[kk][3] = q32(vb, rb, 16 * kk + 8 + 2 * t);
    }
    float acc[HC / 8][4];
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int e = 0; e < ne; ++e) {
      const long long srow = (((long long)a * ne + e) * kH + h) * n;
      const float nb[2] = {va ? -rowmax[srow + ra] * kLog2e : 0.f,
                           vb ? -rowmax[srow + rb] * kLog2e : 0.f};
      float o[HC / 8][4];
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
      for (int j = 0; j < ntiles; ++j) {
        const uint32_t* wd = mask_s + j * P::kWords;
        if (lane0<P::kUniform>(tile_empty<P::kWords>(wd))) continue;
        const int slot = s % P::kStages;
        ring_wait<P::kUniform>(&full[slot], (s / P::kStages) & 1, 1);
        if (active) {
          const uint32_t sb = smem_u32(base) + (uint32_t)slot * P::kSlotBytes;
          if (lane0<P::kUniform>(tile_full<P::kWords>(wd)))
            apply_step<HC, false>(sb, qf, wd, t, c2, nb, o);
          else
            apply_step<HC, true>(sb, qf, wd, t, c2, nb, o);
        }
        ring_arrive<P::kUniform>(&empty[slot], lane);
        ++s;
      }
      if (active) {
        const float we = w[a * ne + e];
        const float fa = va ? we * (1.f / fmaxf(rowsum[srow + ra], 1e-30f)) : 0.f;
        const float fb = vb ? we * (1.f / fmaxf(rowsum[srow + rb], 1e-30f)) : 0.f;
#pragma unroll
        for (int j = 0; j < HC / 8; ++j) {
          acc[j][0] += fa * o[j][0];
          acc[j][1] += fa * o[j][1];
          acc[j][2] += fb * o[j][2];
          acc[j][3] += fb * o[j][3];
        }
      }
    }
    float* oh = out + ((long long)a * kH + h) * n * HC;
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) {
      if (va)
        *reinterpret_cast<float2*>(oh + (long long)ra * HC + 8 * j + 2 * t) =
            make_float2(acc[j][0], acc[j][1]);
      if (vb)
        *reinterpret_cast<float2*>(oh + (long long)rb * HC + 8 * j + 2 * t) =
            make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// (blocks per head, passes) of K7's grid at head width HC for A anchors and
// N query rows
template <int HC>
static void apply_plan(int na, int n, int* bph, int* passes) {
  constexpr int per_block = ApplyPlan<HC>::kUnitsPerBlock;
  const int units = na * ((n + kAUnitRows - 1) / kAUnitRows);
  const int most = (units + per_block - 1) / per_block;  // blocks with a unit
  *bph = std::max(1, std::min(sm_count() / kH, most));
  *passes = (units + *bph * per_block - 1) / (*bph * per_block);
}

// K7 in the tc form: k, v (E, 4, M, HC) bf16, 16-byte aligned
template <int HC>
inline int launch_apply(const void* q, const void* k, const void* v, const void* w,
                        const void* rowmax, const void* rowsum, const void* km, void* out,
                        int na, int ne, int n, int m, cudaStream_t st) {
  const size_t smem = apply_smem_bytes<HC>(m);
  if (smem > (size_t)kMaxSmem || sm_count() == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap kmap, vmap;
  int err = encode_map(&kmap, k, ne, m, ApplyPlan<HC>::kKeys, 1, HC);
  if (!err) err = encode_map(&vmap, v, ne, m, ApplyPlan<HC>::kKeys, 1, HC);
  if (err) return err;
  static size_t attr = 0;  // the kernel's shared-memory attribute, raised once per size
  if (smem > attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        eq_apply_tc_kernel<HC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr = smem;
  }
  int bph, passes;
  apply_plan<HC>(na, n, &bph, &passes);
  const int grid = kH * bph * (kApplyPersistent ? 1 : passes);
  eq_apply_tc_kernel<HC><<<grid, ApplyPlan<HC>::kThreads, smem, st>>>(
      kmap, vmap, (const bf16*)q, (const float*)w, (const float*)rowmax, (const float*)rowsum,
      (const uint8_t*)km, (float*)out, na, ne, n, m, bph, passes);
  return (int)cudaGetLastError();
}

// blocks of K7's kernel at head width HC resident per SM at M keys (-1 on a
// CUDA error)
template <int HC>
inline int apply_blocks_per_sm(int m) {
  const size_t smem = apply_smem_bytes<HC>(m);
  if (cudaFuncSetAttribute(eq_apply_tc_kernel<HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int nb = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, eq_apply_tc_kernel<HC>,
                                                    ApplyPlan<HC>::kThreads,
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

// K6 on the CUDA cores (the first design), at every width it is built for
template <typename T>
int stats_cuda(const void* q, const void* k, const void* qm, const void* km, const void* sq,
               const void* sk, void* rowmax, void* rowsum, void* gpart, void* spart, int na,
               int ne, int h, int n, int m, int hc, int mode, cudaStream_t st) {
  if (h == 4 && hc == 64)
    return launch_stats<T, 4, 64>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na,
                                  ne, n, m, mode, st);
  if (h == 4 && hc == 32)
    return launch_stats<T, 4, 32>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na,
                                  ne, n, m, mode, st);
  if (h == 4 && hc == 16)
    return launch_stats<T, 4, 16>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na,
                                  ne, n, m, mode, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int stats(const void* q, const void* k, const void* qm, const void* km, const void* sq,
          const void* sk, void* rowmax, void* rowsum, void* gpart, void* spart, int na,
          int ne, int h, int n, int m, int hc, int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // bf16 at head widths 64 and 32 takes the tc form, everything else
  // (float32, head width 16) the CUDA cores
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (h == 4 && hc == 64)
      return eq_tc::launch<64>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na, ne, n,
                               m, mode, st);
    if (h == 4 && hc == 32)
      return eq_tc::launch<32>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na, ne, n,
                               m, mode, st);
  }
  return stats_cuda<T>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na, ne, h, n, m,
                       hc, mode, st);
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

// K7 on the CUDA cores (the first design), at every width it is built for
template <typename T>
int apply_cuda(const void* q, const void* k, const void* v, const void* w, const void* rowmax,
               const void* rowsum, const void* km, void* out, int na, int ne, int h, int n,
               int m, int hc, cudaStream_t st) {
  if (h == 4 && hc == 64)
    return launch_apply<T, 4, 64>(q, k, v, w, rowmax, rowsum, km, out, na, ne, n, m, st);
  if (h == 4 && hc == 32)
    return launch_apply<T, 4, 32>(q, k, v, w, rowmax, rowsum, km, out, na, ne, n, m, st);
  if (h == 4 && hc == 16)
    return launch_apply<T, 4, 16>(q, k, v, w, rowmax, rowsum, km, out, na, ne, n, m, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int apply(const void* q, const void* k, const void* v, const void* w, const void* rowmax,
          const void* rowsum, const void* km, void* out, int na, int ne, int h, int n,
          int m, int hc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // bf16 at head widths 64 and 32 takes the tc form, everything else
  // (float32, head width 16) the CUDA cores
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (h == 4 && hc == 64)
      return eq_tc::launch_apply<64>(q, k, v, w, rowmax, rowsum, km, out, na, ne, n, m, st);
    if (h == 4 && hc == 32)
      return eq_tc::launch_apply<32>(q, k, v, w, rowmax, rowsum, km, out, na, ne, n, m, st);
  }
  return apply_cuda<T>(q, k, v, w, rowmax, rowsum, km, out, na, ne, h, n, m, hc, st);
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

// the bf16 K7 on its first design (the CUDA-core kernel) at any width it is
// built for, where the tc form takes the shape: for the tests and the
// timings that hold the two against each other
extern "C" int se3et_eq_attention_apply_cuda_bf16(
    const void* q, const void* k, const void* v, const void* w, const void* rowmax,
    const void* rowsum, const void* km, void* out, int na, int ne, int h, int n, int m,
    int hc, void* stream) {
  return apply_cuda<__nv_bfloat16>(q, k, v, w, rowmax, rowsum, km, out, na, ne, h, n, m, hc,
                                   (cudaStream_t)stream);
}

// the bf16 K6 on its first design (the CUDA-core kernel) at any width it is
// built for, where the tc form takes the shape: for the tests and the
// timings that hold the two against each other
extern "C" int se3et_eq_attention_stats_cuda_bf16(
    const void* q, const void* k, const void* qm, const void* km, const void* sq,
    const void* sk, void* rowmax, void* rowsum, void* gpart, void* spart, int na, int ne,
    int h, int n, int m, int hc, int mode, void* stream) {
  return stats_cuda<__nv_bfloat16>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na, ne,
                                   h, n, m, hc, mode, (cudaStream_t)stream);
}

// K6's pooled partial slots per (a, e) at N query rows, as the kernel that
// takes (h, hc, bf16) writes them (the wrapper's
// eq_attention.eq_attention_stats_parts is held against it); 0 where none
extern "C" int se3et_eq_attention_stats_parts(int h, int n, int hc, int bf16) {
  if (h != 4 || (hc != 64 && hc != 32 && hc != 16)) return 0;
  if (bf16 && (hc == 64 || hc == 32)) return (n + eq_tc::kRows - 1) / eq_tc::kRows;
  return (n + kWarps - 1) / kWarps;
}

// K6's tc form at head width hc (64 or 32): its shared memory at M keys
// (eq_attention.eq_stats_smem_bytes); 0 at another width
extern "C" long long se3et_eq_attention_stats_smem(int m, int hc) {
  if (hc == 64) return (long long)eq_tc::smem_bytes<64>(m);
  if (hc == 32) return (long long)eq_tc::smem_bytes<32>(m);
  return 0;
}

// blocks of K6's tc form at head width hc resident per SM at M keys (-1 on
// a CUDA error or at another width)
extern "C" int se3et_eq_attention_stats_blocks_per_sm(int m, int hc) {
  if (hc == 64) return eq_tc::blocks_per_sm<64>(m);
  if (hc == 32) return eq_tc::blocks_per_sm<32>(m);
  return -1;
}

// K7's tc form at head width hc (64 or 32): its shared memory at M keys
// (eq_attention.eq_apply_smem_bytes); 0 at another width
extern "C" long long se3et_eq_attention_apply_smem(int m, int hc) {
  if (hc == 64) return (long long)eq_tc::apply_smem_bytes<64>(m);
  if (hc == 32) return (long long)eq_tc::apply_smem_bytes<32>(m);
  return 0;
}

// blocks of K7's tc form at head width hc resident per SM at M keys (-1 on
// a CUDA error or at another width)
extern "C" int se3et_eq_attention_apply_blocks_per_sm(int m, int hc) {
  if (hc == 64) return eq_tc::apply_blocks_per_sm<64>(m);
  if (hc == 32) return eq_tc::apply_blocks_per_sm<32>(m);
  return -1;
}
