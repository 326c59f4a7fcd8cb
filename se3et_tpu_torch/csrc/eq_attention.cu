// Flash equivariant cross attention: K6 (stats) and K7 (apply).
//
// Same functions as the TPU kernels se3et_tpu/ops/pallas/eq_attention.py
// eq_attention_stats (_stats_kernel) and eq_attention_apply (_apply_kernel).
// With s_aeh[n, m] = scale * q[a,h,n] . k[e,h,m] (float32 sums):
//   K6: rowmax/rowsum[a,e,h,n] of the key-masked s (masked s = -1e9, its
//       exp weighted by 0); per block the partial sum over its rows of
//       positive(mean_h s) * qmask[n] * kmask[m], and with sup_q/sup_k the
//       partial max over valid (n, m) of mean_h s * sup_q[a,h] * sup_k[e,h]
//       (-1e9 if none).  The caller reduces the partials in a fixed order.
//   K7: out[a,h,n] = sum_e w[a,e] / rowsum[a,e,h,n]
//                    * sum_m round_T(exp(s - rowmax) * kmask[m]) v[e,h,m]
//
// Bound: operations.  At the serving shape (A=E=6, H=4, N=M=1024, c=64,
// bf16) K6 is 19.3 GFLOP and 151 M exps on inputs of 6 MB; K7 twice the
// products.  The TPU grid walks e sequentially into a VMEM accumulator
// and carries the pooled sum across query blocks; blocks here carry no
// state, so K7 loops e inside the block and K6 writes per-block partials.
//
// Two implementations of each, chosen by element type: for bf16 with a
// head width that is a multiple of 32 (the serving path) the tensor-core
// kernels below (mma.sync); for float32 and other widths the CUDA-core
// kernels: one block per (a[, e], 8 query rows), one warp per query row,
// one lane per key of a 32-key tile, key rows read through L1 (the block's
// warps walk the same tile), the query row as warp-wide broadcasts, K6's
// softmax statistics online (running max and rescaled sum), K7's tile
// probabilities staged in shared memory for a lane-per-value-pair p . v.
#include <type_traits>

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

// Tensor-core kernels (bf16, head width a multiple of 32): the same two
// functions with mma.sync.m16n8k16 (bf16 in, float32 accumulate; fragment
// layout in attention_common.cuh).  One warp owns 16 query rows, a block
// 64; a key tile is 32 keys (few registers: three blocks fit an SM), its
// k (and for K7 v) rows staged in shared memory for the block's warps by
// cp.async one tile ahead of the tile being computed.  Probabilities go from the score accumulators
// straight into A fragments (rounded to bf16, as on the TPU); V fragments
// come from a shared-memory tile through ldmatrix.trans.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per block
constexpr int kTileKeys = 32;
constexpr int kTileNT = kTileKeys / 8;  // key n-tiles per tile
template <int HC>
constexpr int kStride = HC + 8;  // bf16 per staged k / v row: 16-byte aligned

template <int H, int HC, bool kWithSup>
__global__ void __launch_bounds__(kMmaThreads)
eq_stats_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const uint8_t* __restrict__ qmask, const uint8_t* __restrict__ kmask,
                    const float* __restrict__ sup_q, const float* __restrict__ sup_k,
                    float* __restrict__ rowmax, float* __restrict__ rowsum,
                    float* __restrict__ gpart, float* __restrict__ spart, int ne, int n,
                    int mlen, int mode) {
  __shared__ float red_g[kMmaWarps];
  __shared__ float red_s[kMmaWarps];
  // double-buffered k tiles of all H heads, filled by cp.async a tile ahead
  __shared__ __align__(16) __nv_bfloat16 k_s[2][H * kTileKeys * kStride<HC>];
  const int nblk = (n + kMmaRows - 1) / kMmaRows;
  const int parts = (n + kWarps - 1) / kWarps;  // partial slots per (a, e)
  const int blk = blockIdx.x % nblk;
  const int ae = blockIdx.x / nblk;
  const int a = ae / ne;
  const int e = ae - a * ne;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ra = blk * kMmaRows + warp * 16 + g;
  const int rb = ra + 8;
  const bool qva = ra < n && qmask[ra] != 0;
  const bool qvb = rb < n && qmask[rb] != 0;
  const float scale = 1.f / sqrtf((float)HC);
  const __nv_bfloat16* qa = q + (long long)a * H * n * HC;
  const __nv_bfloat16* ke = k + (long long)e * H * mlen * HC;

  float wsup[H], mrun[H][2], lrun[H][2];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    wsup[h] = kWithSup ? sup_q[a * H + h] * sup_k[e * H + h] : 0.f;
    mrun[h][0] = mrun[h][1] = __int_as_float(0xff800000);  // -inf
    lrun[h][0] = lrun[h][1] = 0.f;
  }
  float g_lane = 0.f, sup_lane = kNeg;

  const int ntiles = (mlen + kTileKeys - 1) / kTileKeys;
  auto stage = [&](int tile, int buf) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      stage_rows_async<HC, kTileKeys>(ke + (long long)h * mlen * HC, mlen, tile * kTileKeys,
                                      k_s[buf] + h * kTileKeys * kStride<HC>, kStride<HC>,
                                      threadIdx.x, kMmaThreads);
  };
  stage(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int key0 = tile * kTileKeys;
    const int buf = tile & 1;
    if (tile + 1 < ntiles) stage(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    bool kv[kTileNT][2];
#pragma unroll
    for (int j = 0; j < kTileNT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key0 + 8 * j + 2 * t + i;
        kv[j][i] = key < mlen && kmask[key] != 0;
      }
    float hs[kTileNT][4], ss[kTileNT][4];
#pragma unroll
    for (int j = 0; j < kTileNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) hs[j][c] = ss[j][c] = 0.f;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      uint4 qf[HC / 32][2];
      load_q<HC>(qa + (long long)h * n * HC, n, ra, rb, t, qf);
      float s[kTileNT][4];
      qk_tile_smem<HC, kTileNT>(qf, k_s[buf] + h * kTileKeys * kStride<HC>, kStride<HC>, g,
                                t, s);
      float mxa = kNeg, mxb = kNeg;
#pragma unroll
      for (int j = 0; j < kTileNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = s[j][c] * scale;
          s[j][c] = v;
          hs[j][c] += v;
          if (kWithSup) ss[j][c] += v * wsup[h];
          if (kv[j][c & 1]) {
            if (c < 2) mxa = fmaxf(mxa, v);
            else mxb = fmaxf(mxb, v);
          }
        }
      const float ma = fmaxf(mrun[h][0], quad_max(mxa));
      const float mb = fmaxf(mrun[h][1], quad_max(mxb));
      float suma = 0.f, sumb = 0.f;
#pragma unroll
      for (int j = 0; j < kTileNT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (kv[j][i]) {
            suma += expf(s[j][i] - ma);
            sumb += expf(s[j][2 + i] - mb);
          }
      lrun[h][0] = lrun[h][0] * expf(mrun[h][0] - ma) + suma;
      lrun[h][1] = lrun[h][1] * expf(mrun[h][1] - mb) + sumb;
      mrun[h][0] = ma;
      mrun[h][1] = mb;
    }
#pragma unroll
    for (int j = 0; j < kTileNT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!kv[j][i]) continue;
        if (qva) {
          g_lane += positive(hs[j][i] * (1.f / H), mode);
          if (kWithSup) sup_lane = fmaxf(sup_lane, ss[j][i] * (1.f / H));
        }
        if (qvb) {
          g_lane += positive(hs[j][2 + i] * (1.f / H), mode);
          if (kWithSup) sup_lane = fmaxf(sup_lane, ss[j][2 + i] * (1.f / H));
        }
      }
    __syncthreads();  // all reads of k_s[buf] done before it is refilled
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float la = quad_sum(lrun[h][0]);
    const float lb = quad_sum(lrun[h][1]);
    if (t == 0) {
      const long long base = (((long long)a * ne + e) * H + h) * n;
      if (ra < n) {
        rowmax[base + ra] = mrun[h][0];
        rowsum[base + ra] = la;
      }
      if (rb < n) {
        rowmax[base + rb] = mrun[h][1];
        rowsum[base + rb] = lb;
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
    float gs = 0.f, sp = kNeg;
    for (int w = 0; w < kMmaWarps; ++w) {
      gs += red_g[w];
      sp = fmaxf(sp, red_s[w]);
    }
    gpart[(long long)ae * parts + blk] = gs;
    spart[(long long)ae * parts + blk] = sp;
  }
}

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
int launch_stats_mma(const void* q, const void* k, const void* qm, const void* km,
                     const void* sq, const void* sk, void* rowmax, void* rowsum, void* gpart,
                     void* spart, int na, int ne, int n, int m, int mode, cudaStream_t st) {
  const int grid = na * ne * ((n + kMmaRows - 1) / kMmaRows);
  auto kernel = sq != nullptr ? eq_stats_mma_kernel<H, HC, true>
                              : eq_stats_mma_kernel<H, HC, false>;
  kernel<<<grid, kMmaThreads, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const uint8_t*)qm,
      (const uint8_t*)km, (const float*)sq, (const float*)sk, (float*)rowmax,
      (float*)rowsum, (float*)gpart, (float*)spart, ne, n, m, mode);
  return (int)cudaGetLastError();
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
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (h == 4 && hc == 64)
      return launch_stats_mma<4, 64>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart,
                                     na, ne, n, m, mode, st);
  }
  if (h == 4 && hc == 64)
    return launch_stats<T, 4, 64>(q, k, qm, km, sq, sk, rowmax, rowsum, gpart, spart, na,
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
