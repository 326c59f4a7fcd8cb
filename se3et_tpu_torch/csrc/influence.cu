// KPConv influence weights of one (stage, neighbour set) (K15).
//
//   infl[b,p,h,k] = f_sigma(|s[nbr(p,h)] - q[p] - kp_k|)   (0 for sentinels)
//   inf_sum[b,p,k] = sum_h infl[b,p,h,k]                   (float32)
//
// Same function as the TPU kernel se3et_tpu/ops/pallas/windowed_conv.py
// influence_windowed_pallas (_infl_kernel): f is linear max(1 - d/sigma, 0),
// constant 1 or gaussian exp(-d^2 / (2 (0.3 sigma)^2)); the squared
// distance is expanded as |rel|^2 - 2 rel.kp + |kp|^2 with rel = s - q and
// clamped at 0, as the port's host influence (data/influence.py) forms it.
// The TPU kernel reads neighbour coordinates through one-hot matmuls over
// per-block windows (a TPU has no fast row gather); here each neighbour
// index is read directly (sentinel == Ns clamped before the read, weight 0).
//
// Bound: bytes.  Per (p, h) one coordinate row is gathered and K weights
// are written; the (B, Nq, H, K) output is 80 % of the bytes.  Two forms,
// chosen by shape alone (se3et_influence_plan, windowed_conv.influence_form):
//
// * "tiles" (K <= 16, H <= 64; every set of the model): a block owns a tile
//   of R = 16 consecutive query rows of the flattened (B * Nq) rows, one
//   thread per (row, h) slot (R * H threads: none idles at H 24-38).  Each
//   thread reads its slot's index: a sentinel's K weights are zeroed, a
//   valid (slot, index) goes on a list in shared memory (a warp's by one
//   atomic).  Only 26-73 % of the model's slots are valid (pair 0; 26 % at
//   stage 0, whose padded and short rows are sentinels), so after a
//   barrier the first threads take a listed slot each: its offset s - q,
//   then its K weights, the mode a template parameter, into a float32
//   staging tile in shared memory in the output's (row, h, k) order.
//   After a second barrier the block converts the tile to the output type
//   and writes it as 16-byte evict-first stores: the tile is one contiguous
//   span of the output, 16-byte aligned for any H and K because 8 | R, and
//   the wrapper pads both outputs' allocations to a whole 16-byte unit, so
//   the last tile stores whole units too.  The H-sums are read from the
//   same tile, 4 (row, k) a thread (four chains side by side), added in h
//   order, and go out as 16-byte stores.  The weight's arithmetic is the
//   first design's, operation by operation (kp_influence), so both forms
//   give the same bits.  What holds it (scripts/probe_influence.py): the
//   stores alone take 60 % of its time, and the index and coordinate loads
//   ahead of them most of the rest; the square roots and divisions little.
// * "first", the first design: a block owns 256 / H query rows, one thread
//   per (p, h); each thread writes its K weights with scalar stores (30
//   bytes apart across a warp's lanes in bf16) and keeps them in shared
//   memory as float32; after a barrier one thread per (p, k) sums its H
//   values in h order.  It takes every K <= 16 and H <= 256, and the probe
//   and the checks run it beside the tiles form.
#include <cstdint>

#include "embedding_common.cuh"

namespace {

using se3et::store;

constexpr int kThreads = 256;
constexpr int kMaxK = 16;

// The arithmetic of a weight, which both forms share: each operation
// rounded on its own (no contraction left to the compiler), in the order
// nvcc first compiled the first design, so the forms give the same bits.
// |v|^2 = fma(z, z, fma(x, x, y * y))
__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(x, x, __fmul_rn(y, y)));
}

// -1 / (2 (0.3 sigma)^2), the gaussian's factor
__device__ __forceinline__ float gauss_factor(float sigma) {
  const float s3 = __fmul_rn(0.3f, sigma);
  return __fdiv_rn(-1.f, __fmul_rn(__fmul_rn(2.f, s3), s3));
}

// f_sigma(|rel - kp|) from rel, |rel|^2 and the kernel point (kx, ky, kz,
// |kp|^2): the squared distance expanded and clamped at 0; mode 0 linear,
// 1 constant, 2 gaussian
template <int MODE>
__device__ __forceinline__ float kp_influence(float rx, float ry, float rz, float rel2,
                                              float kx, float ky, float kz, float kk2,
                                              float sigma, float gauss) {
  const float dot = __fmaf_rn(rz, kz, __fmaf_rn(rx, kx, __fmul_rn(ry, ky)));
  const float sq = fmaxf(__fadd_rn(__fsub_rn(rel2, __fmul_rn(2.f, dot)), kk2), 0.f);
  if (MODE == 0) return fmaxf(__fsub_rn(1.f, __fdiv_rn(__fsqrt_rn(sq), sigma)), 0.f);
  if (MODE == 1) return 1.f;
  return expf(__fmul_rn(sq, gauss));
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
influence_kernel(const float* __restrict__ q, const float* __restrict__ s,
                 const int* __restrict__ nbr, const float* __restrict__ kp,
                 TOut* __restrict__ infl, float* __restrict__ inf_sum, int nq, int ns, int h,
                 int k_dim, int mode, float sigma) {
  __shared__ float s_kp[kMaxK][4];  // x, y, z, |kp|^2
  extern __shared__ float s_w[];    // [rows][h][k_dim]
  const int rows = kThreads / h;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * rows;
  if (threadIdx.x < k_dim) {
    const float x = kp[threadIdx.x * 3 + 0], y = kp[threadIdx.x * 3 + 1],
                z = kp[threadIdx.x * 3 + 2];
    s_kp[threadIdx.x][0] = x;
    s_kp[threadIdx.x][1] = y;
    s_kp[threadIdx.x][2] = z;
    s_kp[threadIdx.x][3] = sq_norm(x, y, z);
  }
  __syncthreads();

  const int pl = threadIdx.x / h;
  const int hh = threadIdx.x - pl * h;
  const int p = p0 + pl;
  if (pl < rows && p < nq) {
    const long long slot = ((long long)b * nq + p) * h + hh;
    const int idx = nbr[slot];
    const bool valid = idx >= 0 && idx < ns;
    const int safe = min(max(idx, 0), ns - 1);
    const float* qp = q + ((long long)b * nq + p) * 3;
    const float* sp = s + ((long long)b * ns + safe) * 3;
    const float rx = __fsub_rn(sp[0], qp[0]), ry = __fsub_rn(sp[1], qp[1]),
                rz = __fsub_rn(sp[2], qp[2]);
    const float rel2 = sq_norm(rx, ry, rz);
    const float gauss = gauss_factor(sigma);
    TOut* out = infl + slot * k_dim;
    float* w_s = s_w + (pl * h + hh) * k_dim;
    for (int kk = 0; kk < k_dim; ++kk) {
      const float* c = s_kp[kk];
      float w;
      if (mode == 0) {
        w = kp_influence<0>(rx, ry, rz, rel2, c[0], c[1], c[2], c[3], sigma, gauss);
      } else if (mode == 1) {
        w = 1.f;
      } else {
        w = kp_influence<2>(rx, ry, rz, rel2, c[0], c[1], c[2], c[3], sigma, gauss);
      }
      w = valid ? w : 0.f;
      w_s[kk] = w;
      store(out + kk, w);
    }
  }
  __syncthreads();

  // inf_sum: one thread per (p, k), the H weights added in h order
  for (int t = threadIdx.x; t < rows * k_dim; t += kThreads) {
    const int r = t / k_dim;
    const int kk = t - r * k_dim;
    if (p0 + r >= nq) continue;
    const float* w_s = s_w + r * h * k_dim + kk;
    float acc = 0.f;
    for (int j = 0; j < h; ++j) acc += w_s[j * k_dim];
    inf_sum[((long long)b * nq + p0 + r) * k_dim + kk] = acc;
  }
}

template <typename TOut>
int launch(const void* q, const void* s, const void* nbr, const void* kp, void* infl,
           void* inf_sum, int batch, int nq, int ns, int h, int k_dim, int mode, float sigma,
           void* stream) {
  if (h < 1 || h > kThreads || k_dim < 1 || k_dim > kMaxK || ns < 1 || mode < 0 || mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = kThreads / h;
  const size_t smem = (size_t)rows * h * k_dim * sizeof(float);
  dim3 grid((nq + rows - 1) / rows, batch);
  influence_kernel<TOut><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)s, (const int*)nbr, (const float*)kp, (TOut*)infl,
      (float*)inf_sum, nq, ns, h, k_dim, mode, sigma);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The tiles form.  -D switches give the probe (scripts/probe_influence.py)
// other builds; the shipped build takes the defaults.
#ifndef INFLUENCE_TILES_R  // query rows a tile, a multiple of 8
#define INFLUENCE_TILES_R 16
#endif
#ifndef INFLUENCE_TILES_SLOTS  // (row, h) slots a thread
#define INFLUENCE_TILES_SLOTS 1
#endif
#ifndef INFLUENCE_TILES_STAGE  // 2 the form; 1 without the weights' stores;
#define INFLUENCE_TILES_STAGE 2  // 0 constant weights stored, nothing computed;
#endif  // ablations of the weight: 3 without its square root and division, 4 |rel|^2
#ifndef INFLUENCE_TILES_STREAM  // 1 evict-first stores, 0 plain stores
#define INFLUENCE_TILES_STREAM 1
#endif
#ifndef INFLUENCE_TILES_DIRECT  // 1: a lane computes each 16-byte output run
#define INFLUENCE_TILES_DIRECT 0  // straight from the coordinates and stores it
#endif
#ifndef INFLUENCE_TILES_SHUFFLE  // 1: a warp a row, lane h (H <= 32), the
#define INFLUENCE_TILES_SHUFFLE 0  // H-sums by a shuffle chain in h order
#endif
#ifndef INFLUENCE_TILES_SUM_UNROLL  // h steps of the H-sums unrolled (their
#define INFLUENCE_TILES_SUM_UNROLL 4  // loads issued together)
#endif
#ifndef INFLUENCE_TILES_COMPACT  // 1: the tile's valid slots compacted before
#define INFLUENCE_TILES_COMPACT 1  // the weights; 0: a thread a slot, valid or not
#endif

// internal linkage throughout: a process that loads several builds of this
// file (the probe's) keeps their kernels and statics apart (a template's
// function-local static would otherwise be one object across libraries)
namespace {
namespace tiles {

constexpr int kRows = INFLUENCE_TILES_R;
constexpr int kSlots = INFLUENCE_TILES_SLOTS;
constexpr int kSumUnroll = INFLUENCE_TILES_SUM_UNROLL;
constexpr int kMaxH = 64;
constexpr int kMaxThreads = 1024;
constexpr bool kShuffle = INFLUENCE_TILES_SHUFFLE != 0;
static_assert(kRows % 8 == 0, "a tile's spans start 16-byte aligned only for 8 | R");
static_assert(!kShuffle || kRows * 32 <= kMaxThreads, "a warp a row");
static_assert(kSlots >= 1, "a thread takes at least one slot");
// a slot's shared bytes: its K float32 weights, and its place on the list
// of valid slots (slot, index)
constexpr int kListBytes = (int)sizeof(int2);

struct Plan {
  int form;  // 1 tiles, 0 the first design
  int rows, threads, smem;
};

// The plan for H neighbours and K kernel points: S slots a thread of the
// R * H (whole warps, at most 1024: H <= 64 at R = 16, S = 1); shared
// memory for the float32 staging tile and the list of valid slots.
inline Plan plan_for(int h, int k) {
  const int threads = kShuffle ? kRows * 32 : ((kRows * h + kSlots - 1) / kSlots + 31) / 32 * 32;
  if (h < 1 || h > kMaxH || k < 1 || k > kMaxK || threads > kMaxThreads ||
      (kShuffle && h > 32)) {
    return {0, 0, 0, 0};
  }
  return {1, kRows, threads, kRows * h * (k * (int)sizeof(float) + kListBytes)};
}

// one (row, h) slot's offset rel = s[idx] - q[row] and |rel|^2; false for
// a sentinel
__device__ __forceinline__ bool slot_geometry(const float* __restrict__ q,
                                              const float* __restrict__ s, int idx, int row,
                                              int nq, int ns, float& rx, float& ry, float& rz,
                                              float& rel2) {
  if (!(idx >= 0 && idx < ns)) return false;
  const float* qp = q + (long long)row * 3;
  const float* sp = s + ((long long)(row / nq) * ns + idx) * 3;
  rx = __fsub_rn(sp[0], qp[0]);
  ry = __fsub_rn(sp[1], qp[1]);
  rz = __fsub_rn(sp[2], qp[2]);
  rel2 = sq_norm(rx, ry, rz);
  return true;
}

template <int MODE>
__device__ __forceinline__ float kp_weight(const float4& c, float rx, float ry, float rz,
                                           float rel2, float sigma, float gauss) {
#if INFLUENCE_TILES_STAGE == 4  // ablation: the slot's geometry alone
  return rel2;
#elif INFLUENCE_TILES_STAGE == 3  // ablation: no square root or division
  const float dot = __fmaf_rn(rz, c.z, __fmaf_rn(rx, c.x, __fmul_rn(ry, c.y)));
  return fmaxf(1.f - fmaxf(rel2 - 2.f * dot + c.w, 0.f) * sigma, 0.f);
#else
  return kp_influence<MODE>(rx, ry, rz, rel2, c.x, c.y, c.z, c.w, sigma, gauss);
#endif
}

template <typename T>
__device__ __forceinline__ void store16(T* dst, const T& v) {
#if INFLUENCE_TILES_STREAM
  __stcs(dst, v);
#else
  *dst = v;
#endif
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// one 16-byte unit of the output from 16 / sizeof(TOut) float32 values
__device__ __forceinline__ void store_unit(float* dst, const float* w) {
  store16(reinterpret_cast<float4*>(dst), make_float4(w[0], w[1], w[2], w[3]));
}
__device__ __forceinline__ void store_unit(__nv_bfloat16* dst, const float* w) {
  store16(reinterpret_cast<uint4*>(dst),
          make_uint4(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]), pack_bf16(w[4], w[5]),
                     pack_bf16(w[6], w[7])));
}

// One tile a block.
template <typename TOut, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
influence_tiles_kernel(const float* __restrict__ q, const float* __restrict__ s,
                       const int* __restrict__ nbr, const float* __restrict__ kp,
                       TOut* __restrict__ infl, float* __restrict__ inf_sum, int rows_total,
                       int nq, int ns, int h, int k_dim, float sigma) {
  constexpr int kVec = 16 / (int)sizeof(TOut);
  __shared__ float4 s_kp[kMaxK];                  // x, y, z, |kp|^2
  __shared__ float s_sum[kShuffle ? kRows * kMaxK : 1];  // the shuffle build's sums
  __shared__ int s_count;                         // the tile's valid slots
  // [rows][h][k_dim] float32, then the list of valid (slot, index) pairs
  extern __shared__ float4 s_tile[];
  float* s_w = reinterpret_cast<float*>(s_tile);
  const int t = threadIdx.x, lane = t & 31;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, rows_total - r0);
  const int slots = rows * h;
  const int span = slots * k_dim;  // the tile's elements of infl
  TOut* out = infl + r0 * h * k_dim;
  if (t < k_dim) {
    const float x = kp[t * 3 + 0], y = kp[t * 3 + 1], z = kp[t * 3 + 2];
    s_kp[t] = make_float4(x, y, z, sq_norm(x, y, z));
  }
  if (t == 0) s_count = 0;
  __syncthreads();
  const float gauss = gauss_factor(sigma);

#if INFLUENCE_TILES_STAGE == 0
  for (int e = t; e < span; e += blockDim.x) s_w[e] = 1.f;
#elif INFLUENCE_TILES_SHUFFLE
  {
    const int p = t >> 5;
    float rx = 0.f, ry = 0.f, rz = 0.f, rel2 = 0.f;
    const bool valid = p < rows && lane < h &&
                       slot_geometry(q, s, nbr[(r0 + p) * h + lane], (int)r0 + p, nq, ns, rx, ry,
                                     rz, rel2);
    for (int kk = 0; kk < k_dim; ++kk) {
      float w = valid ? kp_weight<MODE>(s_kp[kk], rx, ry, rz, rel2, sigma, gauss) : 0.f;
      if (p < rows && lane < h) s_w[(p * h + lane) * k_dim + kk] = w;
      // the chain in h order: lane j adds its weight to lane j - 1's sum
      for (int j = 1; j < h; ++j) {
        const float v = __shfl_up_sync(0xffffffffu, w, 1);
        if (lane == j) w = v + w;
      }
      if (lane == h - 1 && p < rows) s_sum[p * k_dim + kk] = w;
    }
  }
#elif INFLUENCE_TILES_DIRECT
  for (int u = t; u * kVec < span; u += blockDim.x) {
    float w[kVec];
    int slot = -1;
    bool valid = false;
    float rx = 0.f, ry = 0.f, rz = 0.f, rel2 = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int e = u * kVec + i;
      const int st = e / k_dim, kk = e - st * k_dim;
      if (st != slot && st < slots) {
        slot = st;
        valid = slot_geometry(q, s, nbr[r0 * h + st], (int)r0 + st / h, nq, ns, rx, ry, rz,
                              rel2);
      }
      w[i] = (e < span && valid) ? kp_weight<MODE>(s_kp[kk], rx, ry, rz, rel2, sigma, gauss)
                                 : 0.f;
      s_w[e] = w[i];
    }
#if INFLUENCE_TILES_STAGE == 2
    store_unit(out + u * kVec, w);
#endif
  }
#elif INFLUENCE_TILES_COMPACT
  {
    // the valid slots listed in shared memory (a warp's by one atomic on
    // the count), the sentinels' weights zeroed; then a thread a listed slot
    int2* s_list = reinterpret_cast<int2*>(s_w + kRows * h * k_dim);
    int idx[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int ts = t + i * blockDim.x;
      idx[i] = ts < slots ? nbr[r0 * h + ts] : -1;
    }
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int ts = t + i * blockDim.x;
      const bool valid = idx[i] >= 0 && idx[i] < ns;
      const unsigned m = __ballot_sync(0xffffffffu, valid);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&s_count, __popc(m));
      at = __shfl_sync(0xffffffffu, at, 0) + __popc(m & ((1u << lane) - 1u));
      if (valid) {
        s_list[at] = make_int2(ts, idx[i]);
      } else if (ts < slots) {
        for (int kk = 0; kk < k_dim; ++kk) s_w[ts * k_dim + kk] = 0.f;
      }
    }
    __syncthreads();
    const int listed = s_count;
    for (int e = t; e < listed; e += blockDim.x) {
      const int2 slot = s_list[e];
      float rx, ry, rz, rel2;
      slot_geometry(q, s, slot.y, (int)r0 + slot.x / h, nq, ns, rx, ry, rz, rel2);
      float* w_s = s_w + slot.x * k_dim;
      for (int kk = 0; kk < k_dim; ++kk)
        w_s[kk] = kp_weight<MODE>(s_kp[kk], rx, ry, rz, rel2, sigma, gauss);
    }
  }
#else
  for (int ts = t; ts < slots; ts += blockDim.x) {
    float* w_s = s_w + ts * k_dim;
    float rx, ry, rz, rel2;
    if (!slot_geometry(q, s, nbr[r0 * h + ts], (int)r0 + ts / h, nq, ns, rx, ry, rz, rel2)) {
      for (int kk = 0; kk < k_dim; ++kk) w_s[kk] = 0.f;
    } else {
      for (int kk = 0; kk < k_dim; ++kk)
        w_s[kk] = kp_weight<MODE>(s_kp[kk], rx, ry, rz, rel2, sigma, gauss);
    }
  }
#endif
  __syncthreads();

  // the tile's weights as 16-byte units (past the span: the allocation's pad)
#if INFLUENCE_TILES_STAGE != 1 && !INFLUENCE_TILES_DIRECT
  for (int u = t; u * kVec < span; u += blockDim.x) store_unit(out + u * kVec, s_w + u * kVec);
#endif
  // the H-sums, 4 (row, k) a thread from the last thread down, each added
  // in h order from 0 as the first design adds them
  for (int su = blockDim.x - 1 - t; su * 4 < rows * k_dim; su += blockDim.x) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (kShuffle) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = s_sum[su * 4 + i];
    } else {
      // four chains side by side (past the last row: the tile's last
      // column, read and not stored)
      const float* col[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = min(su * 4 + i, rows * k_dim - 1);
        const int p = e / k_dim;
        col[i] = s_w + p * h * k_dim + (e - p * k_dim);
      }
#pragma unroll kSumUnroll
      for (int j = 0; j < h; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += col[i][j * k_dim];
      }
    }
    store16(reinterpret_cast<float4*>(inf_sum + r0 * k_dim) + su,
            make_float4(acc[0], acc[1], acc[2], acc[3]));
  }
}

template <typename TOut, int MODE>
int launch_mode(const float* q, const float* s, const int* nbr, const float* kp, TOut* infl,
                float* inf_sum, int rows_total, int nq, int ns, int h, int k_dim, float sigma,
                const Plan& p, cudaStream_t stream) {
  auto fn = influence_tiles_kernel<TOut, MODE>;
  // past the default 48 KB (H > 45 at R = 16): raised to the most a launch
  // of this instance has asked for
  static int smem_set = 48 * 1024;
  if (p.smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = p.smem;
  }
  const long long tiles = ((long long)rows_total + kRows - 1) / kRows;
  fn<<<(unsigned)tiles, p.threads, p.smem, stream>>>(q, s, nbr, kp, infl, inf_sum, rows_total,
                                                      nq, ns, h, k_dim, sigma);
  return (int)cudaGetLastError();
}

// The outputs' allocations are padded to a whole 16-byte unit past their
// last element (the wrapper's): the last tile stores whole units.
template <typename TOut>
int launch(const void* q, const void* s, const void* nbr, const void* kp, void* infl,
           void* inf_sum, int batch, int nq, int ns, int h, int k_dim, int mode, float sigma,
           void* stream) {
  const Plan p = plan_for(h, k_dim);
  if (!p.form || ns < 1 || nq < 1 || batch < 1 || mode < 0 || mode > 2 ||
      reinterpret_cast<uintptr_t>(infl) % 16 || reinterpret_cast<uintptr_t>(inf_sum) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = (long long)batch * nq;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* sf = (const float*)s;
  const int* nb = (const int*)nbr;
  const float* kf = (const float*)kp;
  TOut* out = (TOut*)infl;
  float* sums = (float*)inf_sum;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return launch_mode<TOut, 0>(qf, sf, nb, kf, out, sums, (int)rows, nq, ns, h, k_dim, sigma,
                                  p, st);
    case 1:
      return launch_mode<TOut, 1>(qf, sf, nb, kf, out, sums, (int)rows, nq, ns, h, k_dim, sigma,
                                  p, st);
    default:
      return launch_mode<TOut, 2>(qf, sf, nb, kf, out, sums, (int)rows, nq, ns, h, k_dim, sigma,
                                  p, st);
  }
}

}  // namespace tiles
}  // namespace

extern "C" int se3et_influence_bf16(const void* q, const void* s, const void* nbr,
                                    const void* kp, void* infl, void* inf_sum, int batch,
                                    int nq, int ns, int h, int k_dim, int mode, float sigma,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, s, nbr, kp, infl, inf_sum, batch, nq, ns, h, k_dim, mode,
                               sigma, stream);
}

extern "C" int se3et_influence_f32(const void* q, const void* s, const void* nbr,
                                   const void* kp, void* infl, void* inf_sum, int batch,
                                   int nq, int ns, int h, int k_dim, int mode, float sigma,
                                   void* stream) {
  return launch<float>(q, s, nbr, kp, infl, inf_sum, batch, nq, ns, h, k_dim, mode, sigma,
                       stream);
}

// K15's tiles form; infl and inf_sum padded to a whole 16-byte unit
extern "C" int se3et_influence_tiles_bf16(const void* q, const void* s, const void* nbr,
                                          const void* kp, void* infl, void* inf_sum, int batch,
                                          int nq, int ns, int h, int k_dim, int mode,
                                          float sigma, void* stream) {
  return tiles::launch<__nv_bfloat16>(q, s, nbr, kp, infl, inf_sum, batch, nq, ns, h, k_dim,
                                      mode, sigma, stream);
}

extern "C" int se3et_influence_tiles_f32(const void* q, const void* s, const void* nbr,
                                         const void* kp, void* infl, void* inf_sum, int batch,
                                         int nq, int ns, int h, int k_dim, int mode, float sigma,
                                         void* stream) {
  return tiles::launch<float>(q, s, nbr, kp, infl, inf_sum, batch, nq, ns, h, k_dim, mode,
                              sigma, stream);
}

// The form for H neighbours and K kernel points (1 tiles, 0 the first
// design) and the tiles form's plan: rows a tile, threads a block, bytes of
// the staging tile (windowed_conv.influence_plan mirrors it)
extern "C" int se3et_influence_plan(int h, int k_dim, int* plan) {
  const tiles::Plan p = tiles::plan_for(h, k_dim);
  plan[0] = p.rows;
  plan[1] = p.threads;
  plan[2] = p.smem;
  return p.form;
}
