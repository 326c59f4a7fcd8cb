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
// eq_attention_stats_form names K6's):
// * bf16, H = 4, head width 64 (the serving path): K6 in the "tc" form
//   below (eq_stats_tc_kernel: TMA key tiles, mma.sync, base-2 softmax);
//   K7 on mma.sync (eq_apply_mma_kernel);
// * float32 and head width 16: the CUDA-core kernels, one block per
//   (a[, e], 8 query rows), one warp per query row, one lane per key of a
//   32-key tile, key rows read through L1 (the block's warps walk the same
//   tile), the query row as warp-wide broadcasts, K6's softmax statistics
//   online (running max and rescaled sum), K7's tile probabilities staged in
//   shared memory for a lane-per-value-pair p . v.
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

// K7's tensor-core kernel (bf16, head width a multiple of 32):
// mma.sync.m16n8k16 (bf16 in, float32 accumulate; fragment layout in
// attention_common.cuh).  One warp owns 16 query rows, a block 64; a key
// tile is 32 keys (few registers: three blocks fit an SM), its k and v rows
// staged in shared memory for the block's warps by cp.async one tile ahead
// of the tile being computed.  Probabilities go from the score accumulators
// straight into A fragments (rounded to bf16, as on the TPU); V fragments
// come from a shared-memory tile through ldmatrix.trans.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per block
constexpr int kTileKeys = 32;
constexpr int kTileNT = kTileKeys / 8;  // key n-tiles per tile
template <int HC>
constexpr int kStride = HC + 8;  // bf16 per staged k / v row: 16-byte aligned

// One block per (a, h, 64 query rows); e and the key tiles loop inside.
template <int H, int HC>
__global__ void __launch_bounds__(kMmaThreads)
eq_apply_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ rowmax, const float* __restrict__ rowsum,
                    const uint8_t* __restrict__ kmask, float* __restrict__ out, int ne,
                    int n, int mlen) {
  constexpr int kS = kStride<HC>;
  // double-buffered k and v tiles, filled by cp.async a tile ahead
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kTileKeys * kS];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kTileKeys * kS];
  const int nblk = (n + kMmaRows - 1) / kMmaRows;
  const int blk = blockIdx.x % nblk;
  const int ah = blockIdx.x / nblk;
  const int a = ah / H;
  const int h = ah - a * H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ra = blk * kMmaRows + warp * 16 + g;
  const int rb = ra + 8;
  const float scale = 1.f / sqrtf((float)HC);

  uint4 qf[HC / 32][2];
  load_q<HC>(q + ((long long)a * H + h) * n * HC, n, ra, rb, t, qf);
  float acc[HC / 8][4], o[HC / 8][4];
#pragma unroll
  for (int j = 0; j < HC / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = o[j][c] = 0.f;

  // one flat loop over (key anchor e, key tile), so the prefetch runs
  // across e boundaries
  const int ntiles = (mlen + kTileKeys - 1) / kTileKeys;
  const int total = ne * ntiles;
  auto stage = [&](int it, int buf) {
    const int e = it / ntiles;
    const int key0 = (it - e * ntiles) * kTileKeys;
    const long long head = ((long long)e * H + h) * mlen * HC;
    stage_rows_async<HC, kTileKeys>(k + head, mlen, key0, k_s[buf], kS, threadIdx.x,
                                    kMmaThreads);
    stage_rows_async<HC, kTileKeys>(v + head, mlen, key0, v_s[buf], kS, threadIdx.x,
                                    kMmaThreads);
  };
  stage(0, 0);
  cp_async_commit();
  float rma = 0.f, rmb = 0.f;
  for (int it = 0; it < total; ++it) {
    const int e = it / ntiles;
    const int key0 = (it - e * ntiles) * kTileKeys;
    const int buf = it & 1;
    const long long srow = (((long long)a * ne + e) * H + h) * n;
    if (key0 == 0) {
      rma = ra < n ? rowmax[srow + ra] : 0.f;
      rmb = rb < n ? rowmax[srow + rb] : 0.f;
    }
    if (it + 1 < total) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    float s[kTileNT][4];
    qk_tile_smem<HC, kTileNT>(qf, k_s[buf], kS, g, t, s);
#pragma unroll
    for (int j = 0; j < kTileNT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key0 + 8 * j + 2 * t + i;
        const bool kv = key < mlen && kmask[key] != 0;
        s[j][i] = kv ? expf(s[j][i] * scale - rma) : 0.f;
        s[j][2 + i] = kv ? expf(s[j][2 + i] * scale - rmb) : 0.f;
      }
    pv_tile<HC, kTileKeys>(s, v_s[buf], kS, lane, o);
    __syncthreads();  // all reads of buffer buf done before it is refilled
    if (key0 + kTileKeys >= mlen) {  // last tile of this e
      const float we = w[a * ne + e];
      const float fa = ra < n ? we * (1.f / fmaxf(rowsum[srow + ra], 1e-30f)) : 0.f;
      const float fb = rb < n ? we * (1.f / fmaxf(rowsum[srow + rb], 1e-30f)) : 0.f;
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        acc[j][0] += fa * o[j][0];
        acc[j][1] += fa * o[j][1];
        acc[j][2] += fb * o[j][2];
        acc[j][3] += fb * o[j][3];
        o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
      }
    }
  }
  float* oh = out + ((long long)a * H + h) * n * HC;
#pragma unroll
  for (int j = 0; j < HC / 8; ++j) {
    if (ra < n)
      *reinterpret_cast<float2*>(oh + (long long)ra * HC + 8 * j + 2 * t) =
          make_float2(acc[j][0], acc[j][1]);
    if (rb < n)
      *reinterpret_cast<float2*>(oh + (long long)rb * HC + 8 * j + 2 * t) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

template <int H, int HC>
int launch_apply_mma(const void* q, const void* k, const void* v, const void* w,
                     const void* rowmax, const void* rowsum, const void* km, void* out,
                     int na, int ne, int n, int m, cudaStream_t st) {
  const int grid = na * H * ((n + kMmaRows - 1) / kMmaRows);
  eq_apply_mma_kernel<H, HC><<<grid, kMmaThreads, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)w, (const float*)rowmax, (const float*)rowsum, (const uint8_t*)km,
      (float*)out, ne, n, m);
  return (int)cudaGetLastError();
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

// one TMA copy of key tile `key0` of k[e] (all heads) into `dst`
__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap* map, int key0, int e,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(key0), "r"(0),
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

__device__ __forceinline__ bool tile_empty(const uint32_t* w) {
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) any |= w[i];
  return any == 0;
}

__device__ __forceinline__ bool tile_full(const uint32_t* w) {
  uint32_t all = ~0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) all &= w[i];
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
        load_tile(base + (size_t)slot * kStageBytes, &map, j * kKeys, e, &full[slot]);
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
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)kHC, (cuuint64_t)m, (cuuint64_t)kH, (cuuint64_t)ne};
  const cuuint64_t strides[3] = {kHC * sizeof(bf16), (cuuint64_t)m * kHC * sizeof(bf16),
                                 (cuuint64_t)kH * m * kHC * sizeof(bf16)};
  const cuuint32_t box[4] = {(cuuint32_t)kHC, (cuuint32_t)kKeys, (cuuint32_t)kH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(k), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
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
  // bf16 at head width 64 takes the tc form, everything else the CUDA cores
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (h == 4 && hc == 64)
      return eq_tc::launch(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na, ne, n, m,
                           mode, st);
  } else {
    if (h == 4 && hc == 64)
      return launch_stats<T, 4, 64>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na,
                                    ne, n, m, mode, st);
  }
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
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (h == 4 && hc == 64)
      return launch_apply_mma<4, 64>(q, k, v, w, rowmax, rowsum, km, out, na, ne, n, m, st);
  }
  if (h == 4 && hc == 64)
    return launch_apply<T, 4, 64>(q, k, v, w, rowmax, rowsum, km, out, na, ne, n, m, st);
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
  if (h != 4 || (hc != 64 && hc != 16)) return 0;
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
