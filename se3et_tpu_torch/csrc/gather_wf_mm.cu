// E2PN conv gather x influence contraction fused with the expanded weight
// product (K12), and the same with the strided skip's neighbour max (K13).
//
//   wf_k[q, ac]  = round(sum_h infl[b, q, h, k] * x[b, nbr[b, q, h], ac])
//   out[b, q, :] = sum_k wf_k[q, :] @ rhs[k*AC:(k+1)*AC, :]           (float32)
//   pooled[b, q, ac2] = max_h (nbr valid ? x2[b, nbr, ac2] : 0)          (K13)
//
// with nbr == Ns a sentinel (no contribution to the conv, a zero row in the
// max) and round() the rounding to the feature type (bf16: the per-k
// rounding of the TPU kernel's epilogue).  Replaces the TPU kernels
// se3et_tpu/ops/pallas/windowed_conv.py windowed_gather_wf_mm (K12) and
// windowed_gather_wf_max_mm (K13).
//
// Bound: at the serving shapes the product is the larger term (stage-0
// conv: 2 x 20000 rows x 2880 x 192 MACs, 44 GFLOP, 0.045 ms at the bf16
// tensor-core peak) against ~100 MB of neighbour reads and output writes.
// What the fusion removes is the (B, Nq, K*AC) wf tensor (230 MB at stage
// 0) that the unfused route writes and the matmul reads back.
//
// K12 in bf16 (tc::gather_wf_mm_tc_kernel below, H <= 32).  At stage 1
// (x (2, 10000, 384), H 32, A*Cout 384) the weight product is 88 GFLOP,
// 0.09 ms at the bf16 peak; each 64-row block reads the whole 4.4 MB weight
// (1.4 GB from L2 in all) and the gather reads 0.5 GB of neighbour rows
// (L2 hits: x is 15 MB).  What held the first design back was the
// gather on the CUDA cores (each weight reloaded per channel pair), the
// weight panel waited for between products, and mma chains cut by
// branches.  The design:
//  * each warp's 8 query rows' influence (rows x H x K, as it lies in
//    (B, Nq, H, K), no padded copy) is read once into registers as the A
//    fragments of the gather (K padded to 16 and H to a multiple of 16, with
//    zeros);
//  * the H contraction runs on the tensor cores: per query row and 32-
//    channel chunk a (K x H) @ (H x 32) mma.sync product, B the row's
//    neighbour rows, staged with 16-byte cp.async into a per-warp ring of 3
//    rows two ahead (across chunks: the next chunk's first rows load during
//    the weight product) and read with ldmatrix.trans; the float32 sums are
//    rounded per k to bf16 into the A tile [k][64 rows][32], the TPU
//    epilogue's rounding;
//  * the weight, laid out per call by panels_kernel as contiguous (chunk, k)
//    panels in the shared tiles' swizzled order (one launch, a 4.4 MB copy
//    at stage 1), streams through a 4-slot ring: warp 0
//    keeps 3 panels in flight as single bulk copies (cp.async.bulk) that
//    signal an mbarrier per slot; every warp releases a slot on a second
//    mbarrier (no block-wide barrier per panel);
//  * fragments come by ldmatrix from 64-byte rows whose 16-byte units are
//    XOR-swizzled by row pair (conflict-free), all of a k-step's fragments
//    before its 24 products, and no branch among the products (a branch
//    makes the compiler wait for every mma in flight: guarded products ran
//    at a third of the rate);
//  * the last wave runs as half tiles of 32 rows when they fit on the SMs
//    (stage 1: 313 tiles = 2 waves + 49, run as 2 waves + 97 half tiles).
// Within a block the gather and the product still alternate per chunk, and
// one block runs per SM (the accumulator and the influence fragments take
// up to 254 registers a thread).  For H > 32 the fragments and the staging
// outgrow registers and shared memory: 32 < H <= 48 takes tc48 (its own
// plan, below the H <= 32 tile); wider sets and the float32 K12 (the tiny
// card-vs-CPU checks only) keep the first design below.
//
// K13 in bf16 (tc::gather_wf_max_mm_tc_kernel, H <= 32, AC2 a multiple of 8
// up to 1536): K12's tile (conv_tile: its gather and product unchanged, so
// its output equals K12's bit for bit) and the strided skip's max over the
// same index rows.  At the serving shape (x (2, 20000, 192), nbr (2, 10000,
// 24), skip (2, 20000, 768)) the skip reads whole 1536-byte payload rows,
// ~180 MB for pair 0's 118,184 valid references (of 480,000 slots: most
// are sentinels, and rows 7354-9999 of its first cloud have none), beside
// a 22 GFLOP product.  The first design ran the skip max first and alone
// (a 4-byte channel pair per thread, 24 dependent loads per item), two
// blocks per SM at 128 registers a thread, the gather on the CUDA cores.
// The design:
//  * each warp takes the max over its own 8 rows first (skip_max.cuh
//    skip_row_max, a whole row a call, the routine K2's rows form takes
//    a slice at a time), before the conv's registers are live: per row, up
//    to 24 / SU valid neighbours' payload rows at once, each lane loading
//    its 16-byte units of each straight into registers (96 registers of
//    loads in flight, ~80 KB a block), sentinel slots issuing no load and
//    a row with a sentinel starting its max at zero;
//  * then K12's conv; the skip of one SM overlaps the conv of the others;
//  * a tile without a valid neighbour (the padding) writes zero rows and
//    exits before its influence, gather and product;
//  * shared memory: K12's (166 KB at the serving shape).
// Chosen by measurement: a ring of shared slots per warp filled by bulk
// copies (or every lane's cp.async), its max taken before the conv, between
// the gather's rows or between the product's panels, kept at most ~48 KB a
// block in flight beside K12's shared memory and ran the skip at half the
// rate of the loads above in every placement (PERF.md), so it was removed.
// The float32 K13 and H > 32 keep the first design below, unchanged.
//
// First design: a block owns 64 query rows and keeps their (64, A*Cout) float32
// output in registers (8 warps: 2 along the rows, 4 along the columns; at
// most 12 n8-tiles of 2 m16-tiles per warp, so A*Cout <= 384).  The
// contraction dimension (k, ac) is walked channel chunk by channel chunk
// (64 bytes of channels): for a chunk, every thread gathers a channel pair
// of one row over its H neighbours (4-byte loads of x, the 16 padded
// influence weights as 16-byte loads) into 2 x 16 float32 sums and writes
// the K rounded sums into the shared A tile [K][64][chunk]; then, kernel
// point by kernel point, the (chunk, A*Cout) panel of the transposed
// weight is copied into shared memory (cp.async) and multiplied into the
// accumulators (bf16: mma.sync m16n8k16; float32: the same fragment
// ownership on the CUDA cores, for the float32 route's correctness).  Each
// neighbour row is read once per conv, the weight once per block (an L2
// hit), and only the (B, Nq, A*Cout) result is written.  Shared rows are
// 80 bytes apart, which makes the fragment reads conflict-free.  K13 first
// max-pools the skip payload over the same index rows, staged once in
// shared memory for both; it runs two blocks per SM (the skip's gather is
// latency-bound), which caps its accumulator at A*Cout <= 192.
#include "async_copy.cuh"
#include "attention_common.cuh"
#include "skip_max.cuh"

namespace {

using se3et::Elem;

constexpr int kBM = 64;         // query rows per block
constexpr int kThreads = 256;   // 2 x 4 warps
constexpr int kKP = 16;         // influence weights per (row, neighbour), padded
constexpr int kChunkBytes = 64; // channels of one chunk: 32 bf16 or 16 float
constexpr int kRowBytes = 80;   // shared row of a chunk, padded
constexpr int kMaxAcOutMM = 384;
constexpr int kMaxAcOutMaxMM = 192;

template <typename T>
struct Tile {
  static constexpr int kCW = kChunkBytes / sizeof(T);
  static constexpr int kLD = kRowBytes / sizeof(T);
};

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[mi][j] += A (rows wm*32 + 16 mi ..) x B (columns 8 (n_first + j) ..)
// over one 64-byte chunk of the contraction
template <int NT>
__device__ __forceinline__ void product(const __nv_bfloat16* ak, const __nv_bfloat16* bs,
                                        int wm, int n_first, int n_count, int g, int t,
                                        float (&acc)[2][NT][4]) {
  constexpr int LD = Tile<__nv_bfloat16>::kLD;
#pragma unroll
  for (int s = 0; s < Tile<__nv_bfloat16>::kCW / 16; ++s) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* p0 = ak + (wm * 32 + mi * 16 + g) * LD + s * 16 + 2 * t;
      const __nv_bfloat16* p1 = p0 + 8 * LD;
      a[mi][0] = u32(p0);
      a[mi][1] = u32(p1);
      a[mi][2] = u32(p0 + 8);
      a[mi][3] = u32(p1 + 8);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < n_count) {
        const __nv_bfloat16* q = bs + ((n_first + j) * 8 + g) * LD + s * 16 + 2 * t;
        const uint32_t b0 = u32(q), b1 = u32(q + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          se3et::mma_bf16(acc[mi][j], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b0, b1);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void product(const float* ak, const float* bs, int wm, int n_first,
                                        int n_count, int g, int t, float (&acc)[2][NT][4]) {
  constexpr int LD = Tile<float>::kLD;
  for (int e = 0; e < Tile<float>::kCW; ++e) {
    float a[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      a[mi][0] = ak[r * LD + e];
      a[mi][1] = ak[(r + 8) * LD + e];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < n_count) {
        const int n = (n_first + j) * 8 + 2 * t;
        const float b0 = bs[n * LD + e], b1 = bs[(n + 1) * LD + e];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[mi][j][0] = fmaf(a[mi][0], b0, acc[mi][j][0]);
          acc[mi][j][1] = fmaf(a[mi][0], b1, acc[mi][j][1]);
          acc[mi][j][2] = fmaf(a[mi][1], b0, acc[mi][j][2]);
          acc[mi][j][3] = fmaf(a[mi][1], b1, acc[mi][j][3]);
        }
      }
    }
  }
}

template <typename T, int NT, bool kSkip>
__global__ void __launch_bounds__(kThreads, kSkip ? 2 : 1)
gather_wf_mm_kernel(const T* __restrict__ x, const int* __restrict__ nbr,
                    const T* __restrict__ infl, const T* __restrict__ rhs_t,
                    float* __restrict__ out, const T* __restrict__ x2,
                    T* __restrict__ pooled, int ns, int nq, int h, int k, int ac, int ac_out,
                    int ac2) {
  constexpr int CW = Tile<T>::kCW, LD = Tile<T>::kLD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);                    // [k][kBM][LD]
  T* bs = as + k * kBM * LD;                             // [ac_out][LD]
  int* s_nbr = reinterpret_cast<int*>(bs + ac_out * LD);  // [kBM][h]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int nrows = min(kBM, nq - q0);
  const long long row0 = (long long)b * nq + q0;
  for (int i = tid; i < kBM * h; i += kThreads) {
    s_nbr[i] = i < nrows * h ? nbr[row0 * h + i] : ns;  // rows past nq: all sentinels
  }
  __syncthreads();

  if constexpr (kSkip) {
    // skip max over the staged index rows; same order and arithmetic as K2
    const T* x2b = x2 + (long long)b * ns * ac2;
    const int np = ac2 / 2;
    for (int item = tid; item < nrows * np; item += kThreads) {
      const int r = item / np;
      const int c = (item - r * np) * 2;
      const int* rn = s_nbr + r * h;
      float m0 = __int_as_float(0xff800000), m1 = m0;  // -inf
      for (int hh = 0; hh < h; ++hh) {
        const int j = rn[hh];
        const float2 v = (j < ns && j >= 0) ? Elem<T>::load2(x2b + (long long)j * ac2 + c)
                                            : make_float2(0.f, 0.f);
        m0 = fmaxf(m0, v.x);
        m1 = fmaxf(m1, v.y);
      }
      put2(pooled + (row0 + r) * ac2 + c, m0, m1);
    }
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int ntot = ac_out / 8, per = (ntot + 3) / 4;
  const int n_first = wn * per, n_count = min(per, ntot - n_first);
  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;

  const T* xb = x + (long long)b * ns * ac;
  const long long kac = (long long)k * ac;
  for (int c0 = 0; c0 < ac; c0 += CW) {
    // A tile of this chunk: as[kk][r][c - c0] = round(sum_h infl * x), zero
    // for channels past ac and rows past nq
    for (int item = tid; item < kBM * (CW / 2); item += kThreads) {
      const int r = item / (CW / 2);
      const int c = c0 + (item - r * (CW / 2)) * 2;
      float s0[kKP], s1[kKP];
#pragma unroll
      for (int kk = 0; kk < kKP; ++kk) s0[kk] = s1[kk] = 0.f;
      if (c < ac) {
        const int* rn = s_nbr + r * h;
        const T* wr = infl + (row0 + r) * (long long)h * kKP;
        for (int hh = 0; hh < h; ++hh) {
          const int j = rn[hh];
          if (j >= ns || j < 0) continue;
          const float2 xv = Elem<T>::load2(xb + (long long)j * ac + c);
          float w[kKP];
          Elem<T>::load8(wr + hh * kKP, w);
          Elem<T>::load8(wr + hh * kKP + 8, w + 8);
#pragma unroll
          for (int kk = 0; kk < kKP; ++kk) {
            s0[kk] = fmaf(w[kk], xv.x, s0[kk]);
            s1[kk] = fmaf(w[kk], xv.y, s1[kk]);
          }
        }
      }
      T* dst = as + r * LD + (c - c0);
#pragma unroll
      for (int kk = 0; kk < kKP; ++kk) {
        if (kk < k) put2(dst + kk * kBM * LD, s0[kk], s1[kk]);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < k; ++kk) {
      // weight panel rows kk*AC + c0 .. + CW of the expanded weight, one
      // shared row per output column (zero past ac)
      constexpr int kVec = kChunkBytes / 16, kPerVec = 16 / sizeof(T);
      for (int i = tid; i < ac_out * kVec; i += kThreads) {
        const int n = i / kVec;
        const int col = (i - n * kVec) * kPerVec;
        const bool ok = c0 + col < ac;
        se3et::cp_async16(bs + n * LD + col, ok ? rhs_t + n * kac + kk * ac + c0 + col : rhs_t,
                          ok);
      }
      se3et::cp_async_commit();
      se3et::cp_async_wait<0>();
      __syncthreads();
      product<NT>(as + kk * kBM * LD, bs, wm, n_first, n_count, g, t, acc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = wm * 32 + mi * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= n_count) continue;
      const int col = (n_first + j) * 8 + 2 * t;
      if (r < nrows)
        *reinterpret_cast<float2*>(out + (row0 + r) * ac_out + col) =
            make_float2(acc[mi][j][0], acc[mi][j][1]);
      if (r + 8 < nrows)
        *reinterpret_cast<float2*>(out + (row0 + r + 8) * ac_out + col) =
            make_float2(acc[mi][j][2], acc[mi][j][3]);
    }
  }
}

template <typename T, int NT, bool kSkip>
int launch_nt(dim3 grid, size_t smem, cudaStream_t stream, const void* x, const void* nbr,
              const void* infl, const void* rhs_t, void* out, const void* x2, void* pooled,
              int ns, int nq, int h, int k, int ac, int ac_out, int ac2) {
  auto fn = gather_wf_mm_kernel<T, NT, kSkip>;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<grid, kThreads, smem, stream>>>((const T*)x, (const int*)nbr, (const T*)infl,
                                       (const T*)rhs_t, (float*)out, (const T*)x2, (T*)pooled,
                                       ns, nq, h, k, ac, ac_out, ac2);
  return (int)cudaGetLastError();
}

template <typename T, bool kSkip>
int launch(const void* x, const void* nbr, const void* infl, const void* rhs_t, void* out,
           const void* x2, void* pooled, int batch, int ns, int nq, int h, int k, int ac,
           int ac_out, int ac2, void* stream) {
  const int max_out = kSkip ? kMaxAcOutMaxMM : kMaxAcOutMM;
  if (k < 1 || k > kKP || h < 1 || ac < 8 || ac % 8 || ac_out < 8 || ac_out % 8 ||
      ac_out > max_out || (kSkip && (ac2 < 2 || ac2 % 2)))
    return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  const size_t smem = (size_t)k * kBM * kRowBytes + (size_t)ac_out * kRowBytes +
                      (size_t)kBM * h * sizeof(int);
  const dim3 grid((nq + kBM - 1) / kBM, batch);
  const int per = (ac_out / 8 + 3) / 4;
  cudaStream_t st = (cudaStream_t)stream;
  if (per <= 2)
    return launch_nt<T, 2, kSkip>(grid, smem, st, x, nbr, infl, rhs_t, out, x2, pooled, ns,
                                  nq, h, k, ac, ac_out, ac2);
  if (per <= 6)
    return launch_nt<T, 6, kSkip>(grid, smem, st, x, nbr, infl, rhs_t, out, x2, pooled, ns,
                                  nq, h, k, ac, ac_out, ac2);
  if constexpr (!kSkip) {
    return launch_nt<T, 12, false>(grid, smem, st, x, nbr, infl, rhs_t, out, x2, pooled, ns,
                                   nq, h, k, ac, ac_out, ac2);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K12 in bf16 on the tensor cores (the serving route).  Rows are the
// flattened (b, q) rows of nbr / infl / out; a block owns kBM of them (the
// last wave in half tiles of kBM / 2, see launch).
namespace tc {

using se3et::bulk_load;
using se3et::mbar_arrive;
using se3et::mbar_expect_tx;
using se3et::mbar_init;
using se3et::mbar_wait;
using se3et::smem_u32;

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBM / kWarps;    // gather rows per warp: warp + kWarps * i
constexpr int kCW = 32;                // channels of one chunk: one 64-byte shared row
constexpr int kPlane = kBM * kCW + 8;  // bf16 per kernel-point plane of the A tile; the
                                       // 16-byte pad starts planes 4 banks apart
constexpr int kStages = 4;             // weight panels in the ring
constexpr int kStageRows = 3;          // neighbour-row buffers per warp
constexpr int kMaxH = 32;              // neighbours per row (padded to 16 in the gather)
constexpr int kMaxSkip = 1536;         // K13: skip payload channels
// phase bits (the probe's): the gather, the weight product, the last wave in
// half tiles; K13's skip max (by 16-byte loads into registers before the
// conv) and the exit of a tile without a valid neighbour
constexpr int kGather = 1, kProduct = 2, kSplitTail = 4, kSkip = 8, kPadExit = 16;
constexpr int kDefaultPhases = kGather | kProduct | kSplitTail;
constexpr int kMaxDefaultPhases = kDefaultPhases | kSkip | kPadExit;

// element offset of channel c (0..31) in row r of a tile of 64-byte rows,
// 16-byte units XOR-swizzled by row pair: the 8 rows an ldmatrix phase
// reads, and the rows a fragment store writes, hit 32 distinct banks.  The
// wrapper lays the weight panels out in global memory in this order.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kCW + ((((c >> 3) ^ (r >> 1)) & 3) << 3) + (c & 7);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem)));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// the chunk's channels of the hp neighbour rows of one query row, zero for
// sentinels, padding and rows past the end
__device__ __forceinline__ void stage_row(bf16* dst, const bf16* xb, const int* rn, int h,
                                          int hp, int ns, int c0, int ac, bool live, int lane) {
  for (int i = lane; i < hp * 4; i += 32) {
    const int hh = i >> 2, u = i & 3;
    const int j = hh < h ? rn[hh] : ns;
    const bool ok = live && j >= 0 && j < ns && c0 + 8 * u < ac;
    se3et::cp_async16(dst + swz(hh, 8 * u), ok ? xb + (long long)j * ac + c0 + 8 * u : xb, ok);
  }
}

// One tile of K12 (SU == 0) or K13 (SU > 0: the skip max too, SU 16-byte
// units of a payload row per lane at most).  K13 leaves K12's gather and
// product, and so their sums, as they are.
template <int NT, int HS, int SU>
__device__ __forceinline__ void conv_tile(const bf16* __restrict__ x, const int* __restrict__ nbr,
                                          const bf16* __restrict__ infl,
                                          const bf16* __restrict__ panels,
                                          float* __restrict__ out, const bf16* __restrict__ x2,
                                          bf16* __restrict__ pooled, int ns, int nq, int rows,
                                          int h, int hs, int k, int ac, int ac_out, int ac2,
                                          int nfull, int phases) {
  constexpr int hp = 16 * HS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);                       // [k][kPlane]
  bf16* s_w = s_a + k * kPlane;                                    // [kStages][ac_out][kCW]
  bf16* s_x = s_w + kStages * ac_out * kCW;                        // [warp][kStageRows][hp][kCW]
  int* s_nbr = reinterpret_cast<int*>(s_x + kWarps * kStageRows * hp * kCW);  // [kBM][h]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_nbr + kBM * h);   // [kStages]
  uint64_t* empty = full + kStages;                                // [kStages]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool half = (int)blockIdx.x >= nfull;
  const int r0 = half ? nfull * kBM + ((int)blockIdx.x - nfull) * (kBM / 2)
                      : (int)blockIdx.x * kBM;
  const int nrows = min(half ? kBM / 2 : kBM, rows - r0);
  const int nchunks = (ac + kCW - 1) / kCW;
  const int npanels = nchunks * k;
  const int panel_elems = ac_out * kCW;
  const uint32_t panel_bytes = (uint32_t)panel_elems * 2;
  const bool gather = phases & kGather, product = phases & kProduct;

  bool any = false;  // a valid neighbour among this thread's slots
  for (int i = tid; i < kBM * h; i += kThreads) {
    const int j = i < nrows * h ? nbr[(long long)r0 * h + i] : ns;
    s_nbr[i] = j;
    any |= j >= 0 && j < ns;
  }
  if constexpr (SU > 0) {
    const bool live = __syncthreads_or(any);  // and s_nbr is complete
    // a tile without a valid neighbour (the padding): zero rows of both
    // outputs, as the plain version gives them
    if ((phases & kPadExit) && !live) {
      float4* o = reinterpret_cast<float4*>(out + (long long)r0 * ac_out);
      for (int i = tid; i < nrows * ac_out / 4; i += kThreads)
        o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      uint4* pz = reinterpret_cast<uint4*>(pooled + (long long)r0 * ac2);
      for (int i = tid; i < nrows * ac2 / 8; i += kThreads) pz[i] = make_uint4(0u, 0u, 0u, 0u);
      return;
    }
    if (phases & kSkip) {
      // this warp's rows in turn, each whole (one slice of SU units a lane)
#pragma unroll 1
      for (int i = 0; i < kRows; ++i) {
        const int r = warp + kWarps * i;
        const uint4* src =
            reinterpret_cast<const uint4*>(x2 + (long long)(r0 + r) / nq * ns * ac2);
        se3et::skip_row_max<bf16, SU, 24 / SU>(
            src, s_nbr + r * h, h, ns, ac2 >> 3, 0,
            reinterpret_cast<uint4*>(pooled + (long long)(r0 + r) * ac2), r < nrows, lane);
      }
    }
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this warp's rows' influence, read once as it lies in (rows, hs, k),
  // held as the A fragments of the gather: A[kp][hh] = infl[r][hh][kp],
  // rows kp = g, g + 8 (zero past k), columns hh (zero past h)
  uint32_t wf[kRows][HS][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i;
    const bf16* wr = infl + (long long)min(r0 + r, rows - 1) * hs * k;
    const bool live = r < nrows;
    auto w = [&](int kp, int hh) {
      return live && kp < k && hh < h ? wr[hh * k + kp] : __float2bfloat16(0.f);
    };
#pragma unroll
    for (int s = 0; s < HS; ++s) {
      const int ha = 16 * s + 2 * t, hb = ha + 8;
      wf[i][s][0] = pack2(w(g, ha), w(g, ha + 1));
      wf[i][s][1] = pack2(w(g + 8, ha), w(g + 8, ha + 1));
      wf[i][s][2] = pack2(w(g, hb), w(g, hb + 1));
      wf[i][s][3] = pack2(w(g + 8, hb), w(g + 8, hb + 1));
    }
  }
  __syncthreads();

  // the weight ring: warp 0 keeps kStages - 1 panels in flight, each one
  // bulk copy; panel p (chunk p / k, kernel point p % k) lands in slot
  // p % kStages once all warps have released the slot
  auto produce = [&](int p) {
    const int s = p % kStages;
    if (p >= kStages) mbar_wait(&empty[s], ((p / kStages) - 1) & 1);
    if (lane == 0) {
      mbar_expect_tx(&full[s], panel_bytes);
      bulk_load(s_w + s * panel_elems, panels + (long long)p * panel_elems, panel_bytes,
                &full[s]);
    }
    __syncwarp();
  };
  if (product && warp == 0)
    for (int p = 0; p < min(kStages - 1, npanels); ++p) produce(p);

  // the gather's neighbour rows: a flat per-warp sequence over (chunk, row),
  // two rows ahead, so the next chunk's first rows load during the product
  bf16* my_x = s_x + warp * kStageRows * hp * kCW;
  const int nloads = nchunks * kRows;
  auto stage = [&](int q) {
    const int i = q % kRows, r = warp + kWarps * i;
    const int b = min(r0 + r, rows - 1) / nq;
    stage_row(my_x + (q % kStageRows) * hp * kCW, x + (long long)b * ns * ac, s_nbr + r * h, h,
              hp, ns, (q / kRows) * kCW, ac, r < nrows, lane);
  };
  if (gather) {
    stage(0);
    se3et::cp_async_commit();
    if (nloads > 1) stage(1);
    se3et::cp_async_commit();
  }

  // the product's warp tile: rows wm*32.., n-tiles n_first.. (as K13's)
  const int wm = warp >> 2, wn = warp & 3;
  const int ntot = ac_out / 8, per = (ntot + 3) / 4;
  const int n_first = wn * per, n_count = min(per, ntot - n_first);
  const bool rows_live = wm * 32 < nrows;
  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;

  for (int ci = 0; ci < nchunks; ++ci) {
    // 1. gather: per row the (k x hp) @ (hp x 32) product of its influence
    //    fragments and its staged neighbour rows (ldmatrix.trans), rounded
    //    per k into the A tile
    if (gather) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q = ci * kRows + i;
        if (q + 2 < nloads) stage(q + 2);
        se3et::cp_async_commit();
        se3et::cp_async_wait<2>();
        __syncwarp();
        const int r = warp + kWarps * i;
        if (r < nrows) {
          const bf16* xs = my_x + (q % kStageRows) * hp * kCW;
          float d[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
          // B fragments of n-tiles 2qq, 2qq+1 over neighbour rows 16s..
          // (transposed), all loaded before the products use them
          uint32_t bq[HS][2][4];
          const int mi = lane >> 3;
#pragma unroll
          for (int s = 0; s < HS; ++s)
#pragma unroll
            for (int qq = 0; qq < 2; ++qq)
              se3et::ldmatrix_x4_trans(
                  bq[s][qq], xs + swz(16 * s + (mi & 1) * 8 + (lane & 7), 8 * (2 * qq + (mi >> 1))));
#pragma unroll
          for (int s = 0; s < HS; ++s) {
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
              se3et::mma_bf16(d[2 * qq], wf[i][s][0], wf[i][s][1], wf[i][s][2], wf[i][s][3],
                              bq[s][qq][0], bq[s][qq][1]);
              se3et::mma_bf16(d[2 * qq + 1], wf[i][s][0], wf[i][s][1], wf[i][s][2],
                              wf[i][s][3], bq[s][qq][2], bq[s][qq][3]);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = 8 * j + 2 * t;
            if (g < k)
              *reinterpret_cast<__nv_bfloat162*>(s_a + g * kPlane + swz(r, c)) =
                  __floats2bfloat162_rn(d[j][0], d[j][1]);
            if (g + 8 < k)
              *reinterpret_cast<__nv_bfloat162*>(s_a + (g + 8) * kPlane + swz(r, c)) =
                  __floats2bfloat162_rn(d[j][2], d[j][3]);
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the A tile is complete

    // 2. the weight product, kernel point by kernel point, on the panels of
    //    the ring
    if (product) {
#pragma unroll 1
      for (int kk = 0; kk < k; ++kk) {
        const int p = ci * k + kk;
        const int slot = p % kStages;
        if (warp == 0 && p + kStages - 1 < npanels) produce(p + kStages - 1);
        mbar_wait(&full[slot], (p / kStages) & 1);
        if (rows_live) {
          const bf16* as = s_a + kk * kPlane;
          const bf16* bs = s_w + slot * panel_elems;
          const int mi8 = lane >> 3;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            // every fragment of this k-step first (ldmatrix and mma are
            // volatile asm and stay in program order), then the products.
            // No branch among the products: a branch makes the compiler
            // wait for every mma in flight.  n-tiles past this warp's
            // columns read a clamped tile and are never stored.
            uint32_t a[2][4], bq[NT / 2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              ldsm_x4(a[mi], as + swz(wm * 32 + mi * 16 + (mi8 & 1) * 8 + (lane & 7),
                                      8 * (2 * s + (mi8 >> 1))));
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
              const int nt = min(max(n_first + j + (mi8 >> 1), 0), ntot - 1);
              ldsm_x4(bq[j / 2], bs + swz(nt * 8 + (lane & 7), 8 * (2 * s + (mi8 & 1))));
            }
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                se3et::mma_bf16(acc[mi][j], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                                bq[j / 2][0], bq[j / 2][1]);
                se3et::mma_bf16(acc[mi][j + 1], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                                bq[j / 2][2], bq[j / 2][3]);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
    }
    __syncthreads();  // the A tile is free for the next chunk
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = wm * 32 + mi * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= n_count) continue;
      const int col = (n_first + j) * 8 + 2 * t;
      if (r < nrows)
        *reinterpret_cast<float2*>(out + (long long)(r0 + r) * ac_out + col) =
            make_float2(acc[mi][j][0], acc[mi][j][1]);
      if (r + 8 < nrows)
        *reinterpret_cast<float2*>(out + (long long)(r0 + r + 8) * ac_out + col) =
            make_float2(acc[mi][j][2], acc[mi][j][3]);
    }
  }
}

// K12's and K13's kernels take the same arguments (K12 ignores the skip's),
// so that one dispatch launches both
template <int NT, int HS>
__global__ void __launch_bounds__(kThreads, 1)
gather_wf_mm_tc_kernel(const bf16* __restrict__ x, const int* __restrict__ nbr,
                       const bf16* __restrict__ infl, const bf16* __restrict__ panels,
                       float* __restrict__ out, const bf16* __restrict__, bf16* __restrict__,
                       int ns, int nq, int rows, int h, int hs, int k, int ac, int ac_out, int,
                       int nfull, int phases) {
  conv_tile<NT, HS, 0>(x, nbr, infl, panels, out, nullptr, nullptr, ns, nq, rows, h, hs, k, ac,
                       ac_out, 0, nfull, phases);
}

template <int NT, int HS, int SU>
__global__ void __launch_bounds__(kThreads, 1)
gather_wf_max_mm_tc_kernel(const bf16* __restrict__ x, const int* __restrict__ nbr,
                           const bf16* __restrict__ infl, const bf16* __restrict__ panels,
                           float* __restrict__ out, const bf16* __restrict__ x2,
                           bf16* __restrict__ pooled, int ns, int nq, int rows, int h, int hs,
                           int k, int ac, int ac_out, int ac2, int nfull, int phases) {
  conv_tile<NT, HS, SU>(x, nbr, infl, panels, out, x2, pooled, ns, nq, rows, h, hs, k, ac,
                        ac_out, ac2, nfull, phases);
}

// the weight panels from the transposed weight rhs_t (A*Cout, K*AC): one
// thread per 16-byte unit (chunk c, kernel point kk, row n, unit pu), unit
// pu of row n holding channels 32c + 8 (pu ^ ((n >> 1) & 3)) .. + 8
__global__ void panels_kernel(const uint4* __restrict__ rhs_t, uint4* __restrict__ panels,
                              int k, int ac, int ac_out, long long units) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= units) return;
  const int pu = (int)(i & 3);
  const long long row = i >> 2;  // (c * k + kk) * ac_out + n
  const int n = (int)(row % ac_out);
  const long long p = row / ac_out;
  const int kk = (int)(p % k), c = (int)(p / k);
  const int ch = 32 * c + 8 * (pu ^ ((n >> 1) & 3));
  panels[i] = ch < ac ? rhs_t[((long long)n * k * ac + (long long)kk * ac + ch) / 8]
                      : make_uint4(0u, 0u, 0u, 0u);
}

size_t smem_bytes(int h, int k, int ac_out) {
  const int hp = (h + 15) & ~15;
  return (size_t)k * kPlane * 2 + (size_t)kStages * ac_out * kCW * 2 +
         (size_t)kWarps * kStageRows * hp * kCW * 2 + (size_t)kBM * h * 4 +
         (size_t)2 * kStages * 8;
}

// one launch of K12 (x2 null) or K13
struct Launch {
  const void *x, *nbr, *infl, *panels;
  void* out;
  const void* x2;
  void* pooled;
  int ns, nq, rows, h, hs, k, ac, ac_out, ac2, nblocks, nfull, phases;
  size_t smem;
  cudaStream_t stream;
};

template <int NT, int HS, int SU>
int launch_nt(const Launch& l) {
  auto fn = gather_wf_mm_tc_kernel<NT, HS>;
  if constexpr (SU > 0) fn = gather_wf_max_mm_tc_kernel<NT, HS, SU>;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<l.nblocks, kThreads, l.smem, l.stream>>>(
      (const bf16*)l.x, (const int*)l.nbr, (const bf16*)l.infl, (const bf16*)l.panels,
      (float*)l.out, (const bf16*)l.x2, (bf16*)l.pooled, l.ns, l.nq, l.rows, l.h, l.hs, l.k,
      l.ac, l.ac_out, l.ac2, l.nfull, l.phases);
  return (int)cudaGetLastError();
}

// K13 (A*Cout <= 192, so NT <= 6): 16-byte units of a payload row per lane,
// 3 up to AC2 768, else 6
template <int NT, int HS>
int launch_su(const Launch& l) {
  if constexpr (NT <= 6)
    if (l.x2) return l.ac2 <= 768 ? launch_nt<NT, HS, 3>(l) : launch_nt<NT, HS, 6>(l);
  return launch_nt<NT, HS, 0>(l);
}

template <int HS>
int launch_hs(const Launch& l) {
  const int per = (l.ac_out / 8 + 3) / 4;
  if (per <= 2) return launch_su<2, HS>(l);
  if (per <= 6) return launch_su<6, HS>(l);
  return launch_su<12, HS>(l);
}

// One block per SM (the (64, A*Cout) float32 accumulator and the influence
// fragments take up to ~170 registers a thread).  With T full tiles on S SMs
// the last wave holds T mod S tiles; when its rows fit in S half tiles, it
// runs as half tiles, so that more SMs share it (kSplitTail).  Sets the
// blocks and the full tiles among them for `rows` flattened rows.
cudaError_t grid_of(int rows, int phases, int* nblocks, int* nfull) {
  const int tiles = (rows + kBM - 1) / kBM;
  *nfull = *nblocks = tiles;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int waves = tiles / sms;
  if ((phases & kSplitTail) && waves > 0 && tiles % sms) {
    const int rest = rows - waves * sms * kBM;
    const int halves = (rest + kBM / 2 - 1) / (kBM / 2);
    if (halves <= sms) {
      *nfull = waves * sms;
      *nblocks = *nfull + halves;
    }
  }
  return cudaSuccess;
}

// K12 (x2 and pooled null) or K13 (x2 (B, Ns, AC2), pooled (B, Nq, AC2)).
// panels: the weight as (chunks, K, A*Cout, 32) bf16, rows swizzled as
// swz(), zero past AC.
int launch(const void* x, const void* nbr, const void* infl, const void* panels, void* out,
           const void* x2, void* pooled, int batch, int ns, int nq, int h, int hs, int k,
           int ac, int ac_out, int ac2, int phases, void* stream) {
  const bool skip = x2 != nullptr;
  if (k < 1 || k > kKP || h < 1 || h > kMaxH || hs < h || ac < 8 || ac % 8 || ac_out < 8 ||
      ac_out % 8 || ac_out > (skip ? kMaxAcOutMaxMM : kMaxAcOutMM) ||
      (reinterpret_cast<uintptr_t>(panels) & 15))
    return (int)cudaErrorInvalidValue;
  if (skip && (ac2 < 8 || ac2 % 8 || ac2 > kMaxSkip ||
               ((reinterpret_cast<uintptr_t>(x2) | reinterpret_cast<uintptr_t>(pooled) |
                 reinterpret_cast<uintptr_t>(out)) & 15)))
    return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  Launch l{x, nbr, infl, panels, out, x2, pooled, ns, nq, batch * nq, h, hs, k, ac, ac_out,
           ac2, 0, 0, phases, smem_bytes(h, k, ac_out), (cudaStream_t)stream};
  const cudaError_t e = grid_of(l.rows, phases, &l.nblocks, &l.nfull);
  if (e != cudaSuccess) return (int)e;
  return h <= 16 ? launch_hs<1>(l) : launch_hs<2>(l);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// K12 in bf16 on the tensor cores for 32 < H <= 48 (the "tc48" form; its
// plan is the constants below, mirrored by windowed_conv.gather_wf_mm_tc48_plan).
// At se3ete2's stage-2 convs (x (2, 3072, 384), H 36, K 15, A*Cout 384) the
// product is 27.2 GFLOP (0.028 ms at the bf16 peak) and the gather reads
// ~170 MB of neighbour rows from L2 (x is 4.7 MB).  What the H <= 32 tile
// cannot do here: three 16-neighbour fragments (H padded to 48) outgrow its
// shared memory (243 KB) and registers, and its 64-row tiles give 96 blocks
// on 132 SMs.  The plan:
//  * 48-row tiles (128 blocks at the target: one wave on 128 of 132 SMs);
//    each warp gathers 6 rows, whose influence (3 x 4 registers a row) it
//    holds as the A fragments of the gather, read once in place;
//  * the gather of a row and chunk is its (16 x 48) @ (48 x 32) product on
//    mma.sync, B the row's H staged neighbour rows (ldmatrix.trans; the
//    padding rows read a zero row), rounded per k to bf16 into the A tile as
//    the H <= 32 tile does (all 16 planes, the ones past K zero); three
//    staging buffers a warp (two ahead) where they fit, H <= 38, else two;
//  * the weight product on wgmma: two warpgroups, each m64n192k16 over the
//    tile's 48 rows and its half of A*Cout, A from registers (ldmatrix of
//    the A tile; the fourth warp's 16 rows, past the tile, read a zero
//    padding row and are not stored: a quarter of the product's tensor work
//    is padding), B the panel in the ring (the panels' 64-byte swizzle is
//    wgmma's);
//  * two A tiles: the gather of chunk c + 1 runs between the products of
//    chunk c, a row while kernel point i K / 6's product is in flight;
//  * the weight panels stream through a 3-slot ring of bulk copies
//    (mbarriers), released per panel;
//  * every branch is warp-uniform (waits by vote, lane 0's copies and
//    arrivals predicated, not branched): else ptxas serialises the wgmma
//    (C7520, ROADMAP).
// Measured (scripts/probe_gather_wf_mm.py, NVIDIA H100 80GB HBM3, 700 W,
// PERF.md): the gather alone and the product alone each take about half of
// the kernel; the product alone streams the 566 MB of weight panels (4.4 MB
// per tile) from L2 at ~7 TB/s, the gather's scattered 64-byte rows run at
// ~2.5 TB/s, and the two overlap little.  A cluster of 2 blocks sharing the
// weight stream by multicast halved the L2 reads but ran slower (ROADMAP
// B.2).  Neither staging the rows through L1 (a 48-row tile references each
// distinct neighbour row ~6 times) nor one A tile (gather and product in
// turn, 70 KB more L1) moved the gather.
namespace tc48 {

using se3et::mbar_init;
using se3et::smem_u32;
using tc::bf16;
using tc::ldsm_x4;
using tc::pack2;
using tc::swz;

constexpr int kBM = 48;                  // query rows per block
constexpr int kThreads = 256;            // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBM / kWarps;      // gather rows per warp: warp + kWarps * i
constexpr int kHS = 3;                   // 16-neighbour fragments
constexpr int kHP = 16 * kHS;            // neighbours of the fragments (H padded)
constexpr int kMinH = 33, kMaxH = kHP;
constexpr int kCW = tc::kCW;             // channels of one chunk
constexpr int kPlane = kBM * kCW + 8;    // bf16 per kernel-point plane of an A tile
constexpr int kNW = 192;                 // output columns per warpgroup
constexpr int kSlot = 2 * kNW * kCW;     // bf16 per weight slot (A*Cout <= 384 rows)
constexpr int kStages = 3;               // weight panels in the ring
constexpr int kAlign = 1024;             // the ring's alignment (wgmma's swizzle)
// phase bits (the probe's): the gather, the weight product
constexpr int kGather = 1, kProduct = 2;
constexpr int kDefaultPhases = kGather | kProduct;
static_assert(2 * kNW == kMaxAcOutMM, "two warpgroups cover the widest A*Cout");

// lane 0's arrival on the mbarrier `bar` (predicated, no branch)
__device__ __forceinline__ void arrive_lane0(uint64_t* bar, int lane) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      ::"r"(smem_u32(bar)), "r"(lane) : "memory");
}
// until the phase of the given parity has completed, the whole warp leaving
// together (a vote); traps after ~2^33 cycles (seconds) instead of hanging
// the card on an arrival that never comes (no message: a printf would make
// ptxas serialise the wgmma)
__device__ __forceinline__ void wait_warp(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (__all_sync(0xffffffffu, done)) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}
// lane 0: expect `bytes` on `bar`, and copy `bytes` from `src` to `dst`,
// signalling `bar` (predicated, no branch)
__device__ __forceinline__ void issue_lane0(void* dst, const void* src, uint32_t bytes,
                                            uint64_t* bar, int lane) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %4, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      " @p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n}\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "r"(lane) : "memory");
}

// a wgmma descriptor of K-major 64-byte rows under the 64-byte swizzle at
// shared address `addr` (atoms of 8 rows, 512 bytes apart)
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
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
// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 96; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 192: 96 floats, each warp its 16 rows in the mma.sync accumulator
// layout, n-tile j at d[4 j .. 4 j + 3]) += a (64 x 16 bf16 in registers, the
// mma.sync A layout) . b (16 x 192 behind `desc`, K-major)
__device__ __forceinline__ void wgmma_n192(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred acc;\n setp.ne.b32 acc, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, acc, 1, 1, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the chunk's channels of the h neighbour rows of one query row (row
// `row` of nbr; none where !live), zero for sentinels and channels past ac,
// into a staging buffer of h rows; every lane runs the same number of
// copies (the last ones, past row h, zero-fill the zero row)
__device__ __forceinline__ void stage_row(bf16* dst, bf16* zero, const bf16* xb,
                                          const int* __restrict__ nbr, long long row, int h,
                                          int ns, int c0, int ac, bool live, int lane) {
  const int n = (h * 4 + 31) >> 5;
  for (int it = 0; it < n; ++it) {
    const int i = it * 32 + lane, hh = i >> 2, u = i & 3;
    const int j = live && hh < h ? __ldg(nbr + row * h + hh) : ns;
    const bool ok = j >= 0 && j < ns && c0 + 8 * u < ac;
    se3et::cp_async16(hh < h ? dst + swz(hh, 8 * u) : zero,
                      ok ? xb + (long long)j * ac + c0 + 8 * u : xb, ok);
  }
}

// Rows are the flattened (b, q) rows of nbr / infl / out; block i owns rows
// 48 i .. 48 i + 47.
// B: neighbour-row buffers per warp (3 where shared memory allows, H <= 38).
template <int B>
__global__ void __launch_bounds__(kThreads, 1)
gather_wf_mm_tc48_kernel(const bf16* __restrict__ x, const int* __restrict__ nbr,
                         const bf16* __restrict__ infl, const bf16* __restrict__ panels,
                         float* __restrict__ out, int ns, int nq, int rows, int h, int hs,
                         int k, int ac, int ac_out, int phases) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  bf16* s_w = reinterpret_cast<bf16*>(smem);                     // [kStages][384][kCW]
  bf16* s_a = s_w + kStages * kSlot;                             // [2][kKP][kPlane]
  bf16* s_x = s_a + 2 * kKP * kPlane;                            // [warp][B][h][kCW]
  bf16* s_zero = s_x + kWarps * B * h * kCW;                     // [kCW]: zeros
  bf16* s_pad = s_zero + kCW;                                     // [kCW]: zeros, read only
  uint64_t* full = reinterpret_cast<uint64_t*>(s_pad + kCW);     // [kStages]
  uint64_t* empty = full + kStages;                               // [kStages]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (int)blockIdx.x * kBM;
  const int nrows = max(0, min(kBM, rows - r0));
  const int nchunks = (ac + kCW - 1) / kCW;
  const int npanels = nchunks * k;
  const int panel_elems = ac_out * kCW;
  const uint32_t panel_bytes = (uint32_t)panel_elems * 2;
  const bool gather = phases & kGather, product = phases & kProduct;
  // warp 0 produces; a value ptxas sees as warp-uniform
  const bool producer = __shfl_sync(0xffffffffu, warp == 0, 0);

  // the zero row (the staging's padding copies write zeros over it) and
  // the product's padding row (written here only)
  if (tid < 2 * kCW / 8) reinterpret_cast<uint4*>(s_zero)[tid] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this warp's rows' influence, read once as it lies in (rows, hs, k): the
  // A fragments of the gather, A[kp][hh] = infl[r][hh][kp] (zero past k, h
  // and the tile's rows)
  uint32_t wf[kRows][kHS][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i;
    const bf16* wr = infl + (long long)min(r0 + r, rows - 1) * hs * k;
    const bool live = r < nrows;
    auto w = [&](int kp, int hh) {
      return live && kp < k && hh < h ? wr[hh * k + kp] : __float2bfloat16(0.f);
    };
#pragma unroll
    for (int s = 0; s < kHS; ++s) {
      const int ha = 16 * s + 2 * t, hb = ha + 8;
      wf[i][s][0] = pack2(w(g, ha), w(g, ha + 1));
      wf[i][s][1] = pack2(w(g + 8, ha), w(g + 8, ha + 1));
      wf[i][s][2] = pack2(w(g, hb), w(g, hb + 1));
      wf[i][s][3] = pack2(w(g + 8, hb), w(g + 8, hb + 1));
    }
  }
  __syncthreads();

  // the weight ring: warp 0 keeps kStages - 1 panels in flight; panel p
  // (chunk p / k, kernel point p % k) lands in slot p % kStages once every
  // warp has released the slot
  auto produce = [&](int p) {
    const int s = p % kStages;
    if (p >= kStages) wait_warp(&empty[s], ((p / kStages) - 1) & 1);
    issue_lane0(s_w + s * kSlot, panels + (long long)p * panel_elems, panel_bytes, &full[s],
                lane);
  };
  if (product && producer)
    for (int p = 0; p < min(kStages - 1, npanels); ++p) produce(p);

  // the gather's neighbour rows: a flat per-warp sequence over (chunk, row),
  // B - 1 ahead
  bf16* my_x = s_x + warp * B * h * kCW;
  const int nloads = nchunks * kRows;
  auto stage = [&](int q) {
    const int i = q % kRows, r = warp + kWarps * i;
    const int b = min(r0 + r, rows - 1) / nq;
    stage_row(my_x + (q % B) * h * kCW, s_zero, x + (long long)b * ns * ac, nbr,
              (long long)r0 + r, h, ns, (q / kRows) * kCW, ac, r < nrows, lane);
  };
  // row i of chunk ci: the (16 x 48) @ (48 x 32) product of its influence
  // fragments and its staged neighbour rows (ldmatrix.trans; rows past h
  // read the zero row), rounded per k into chunk ci's A tile (all 16
  // planes: past k the sums are zero)
  auto gather_row = [&](int ci, int i) {
    const int q = ci * kRows + i;
    if (q + B - 1 < nloads) stage(q + B - 1);
    se3et::cp_async_commit();
    se3et::cp_async_wait<B - 1>();
    __syncwarp();
    const int r = warp + kWarps * i;
    const bf16* xs = my_x + (q % B) * h * kCW;
    bf16* as = s_a + (ci & 1) * kKP * kPlane;
    float d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
    const int mi = lane >> 3;
#pragma unroll
    for (int s = 0; s < kHS; ++s) {
      // B fragments of n-tiles 2qq, 2qq+1 over neighbour rows 16s..
      const int hh = 16 * s + (mi & 1) * 8 + (lane & 7);
      uint32_t bq[2][4];
#pragma unroll
      for (int qq = 0; qq < 2; ++qq)
        se3et::ldmatrix_x4_trans(bq[qq], hh < h ? xs + swz(hh, 8 * (2 * qq + (mi >> 1))) : s_zero);
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        se3et::mma_bf16(d[2 * qq], wf[i][s][0], wf[i][s][1], wf[i][s][2], wf[i][s][3],
                        bq[qq][0], bq[qq][1]);
        se3et::mma_bf16(d[2 * qq + 1], wf[i][s][0], wf[i][s][1], wf[i][s][2], wf[i][s][3],
                        bq[qq][2], bq[qq][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(as + g * kPlane + swz(r, c)) =
          __floats2bfloat162_rn(d[j][0], d[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(as + (g + 8) * kPlane + swz(r, c)) =
          __floats2bfloat162_rn(d[j][2], d[j][3]);
    }
    __syncwarp();
  };
  if (gather) {
#pragma unroll
    for (int q = 0; q < B - 1; ++q) {
      if (q < nloads) stage(q);
      se3et::cp_async_commit();
    }
  }

  // the product: warpgroup wg the columns wg * 192 .., its warp wq the rows
  // 16 wq .. (wq 3: rows past the tile, read from the padding row, which
  // nothing writes after the first barrier, and never stored)
  const int wq = warp & 3, wg = warp >> 2;
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
  // panel p: keep the ring full, multiply chunk ci's A tile by the panel,
  // run `shadow` (a gather row, or nothing) while the product runs, then
  // release the panel's slot
  auto panel = [&](int ci, int kk, auto shadow) {
    const int p = ci * k + kk;
    if (producer && p + kStages - 1 < npanels) produce(p + kStages - 1);
    const int slot = p % kStages;
    wait_warp(&full[slot], (p / kStages) & 1);
    const bf16* as = s_a + ((ci & 1) * kKP + kk) * kPlane;
    const int mi8 = lane >> 3;
    uint32_t a0[4], a1[4];
    const int ar = 16 * wq + (mi8 & 1) * 8 + (lane & 7);
    ldsm_x4(a0, wq < 3 ? as + swz(ar, 8 * (mi8 >> 1)) : s_pad);
    ldsm_x4(a1, wq < 3 ? as + swz(ar, 8 * (2 + (mi8 >> 1))) : s_pad);
    const uint32_t b = smem_u32(s_w + slot * kSlot + wg * kNW * kCW);
    wgmma_fence();
    wgmma_n192(acc, a0, desc64(b));
    wgmma_n192(acc, a1, desc64(b + 32));
    wgmma_commit();
    shadow();
    wgmma_wait_all();
    arrive_lane0(&empty[slot], lane);
  };
  auto nothing = [] {};

  if (gather) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) gather_row(0, i);  // chunk 0 alone
  }
  __syncthreads();
  // each later chunk's gather rows between its predecessor's products: row
  // i in the shadow of kernel point i k / 6 (where k < 6 leaves no kernel
  // point, alone)
  const int pk = product ? k : 0;
#pragma unroll 1
  for (int ci = 0; ci < nchunks; ++ci) {
    const bool next = gather && ci + 1 < nchunks;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {  // unrolled: wf[i] stays in registers
      const int kk0 = i * pk / kRows, kk1 = (i + 1) * pk / kRows;
      auto row = [&] {
        if (next) gather_row(ci + 1, i);
      };
      if (kk1 > kk0) {
        panel(ci, kk0, row);
#pragma unroll 1
        for (int kk = kk0 + 1; kk < kk1; ++kk) panel(ci, kk, nothing);
      } else {
        row();
      }
    }
    __syncthreads();  // chunk ci + 1's A tile is complete, chunk ci's free
  }
  fence_acc(acc);

#pragma unroll
  for (int j = 0; j < kNW / 8; ++j) {
    const int r = 16 * wq + g, col = wg * kNW + 8 * j + 2 * t;
    if (col < ac_out) {
      if (r < nrows)
        *reinterpret_cast<float2*>(out + (long long)(r0 + r) * ac_out + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < nrows)
        *reinterpret_cast<float2*>(out + (long long)(r0 + r + 8) * ac_out + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

constexpr size_t kMaxSmem = 232448;  // an H100 block's shared memory

size_t smem_bytes(int h, int b) {
  return (size_t)kAlign + (size_t)kStages * kSlot * 2 + (size_t)2 * kKP * kPlane * 2 +
         (size_t)kWarps * b * h * kCW * 2 + (size_t)2 * kCW * 2 + (size_t)2 * kStages * 8;
}
// neighbour-row buffers per warp: 3 where they fit, else 2
int stage_rows(int h) { return smem_bytes(h, 3) <= kMaxSmem ? 3 : 2; }

// the plan for `rows` flattened rows: shared memory, 48-row tiles (one
// block each)
void plan(int h, int rows, int* smem, int* tiles) {
  *smem = (int)smem_bytes(h, stage_rows(h));
  *tiles = (rows + kBM - 1) / kBM;
}

template <int B>
int launch_b(const void* x, const void* nbr, const void* infl, const void* panels, void* out,
             int ns, int nq, int rows, int h, int hs, int k, int ac, int ac_out, int phases,
             int tiles, size_t smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(gather_wf_mm_tc48_kernel<B>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  gather_wf_mm_tc48_kernel<B><<<tiles, kThreads, smem, stream>>>(
      (const bf16*)x, (const int*)nbr, (const bf16*)infl, (const bf16*)panels, (float*)out, ns,
      nq, rows, h, hs, k, ac, ac_out, phases);
  return (int)cudaGetLastError();
}

bool takes(int h, int hs, int k, int ac, int ac_out) {
  return k >= 1 && k <= kKP && h >= kMinH && h <= kMaxH && hs >= h && ac >= 8 && ac % 8 == 0 &&
         ac_out >= 8 && ac_out % 8 == 0 && ac_out <= kMaxAcOutMM;
}

// panels: the weight as (chunks, K, A*Cout, 32) bf16, rows swizzled as
// swz(), zero past AC (the H <= 32 tile's layout)
int launch(const void* x, const void* nbr, const void* infl, const void* panels, void* out,
           int batch, int ns, int nq, int h, int hs, int k, int ac, int ac_out, int phases,
           void* stream) {
  if (!takes(h, hs, k, ac, ac_out) || (reinterpret_cast<uintptr_t>(panels) & 15))
    return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  int smem = 0, tiles = 0;
  plan(h, batch * nq, &smem, &tiles);
  auto fn = stage_rows(h) == 3 ? &launch_b<3> : &launch_b<2>;
  return fn(x, nbr, infl, panels, out, ns, nq, batch * nq, h, hs, k, ac, ac_out, phases, tiles,
            (size_t)smem, (cudaStream_t)stream);
}

}  // namespace tc48

}  // namespace

// K12's weight panels, (chunks, K, A*Cout, 32) bf16, from rhs_t (A*Cout, K*AC)
extern "C" int se3et_gather_wf_mm_panels_bf16(const void* rhs_t, void* panels, int k, int ac,
                                              int ac_out, void* stream) {
  if (k < 1 || ac < 8 || ac % 8 || ac_out < 1) return (int)cudaErrorInvalidValue;
  const long long units = (long long)((ac + tc::kCW - 1) / tc::kCW) * k * ac_out * 4;
  const int threads = 256;
  tc::panels_kernel<<<(unsigned)((units + threads - 1) / threads), threads, 0,
                      (cudaStream_t)stream>>>((const uint4*)rhs_t, (uint4*)panels, k, ac,
                                              ac_out, units);
  return (int)cudaGetLastError();
}

// K12 in bf16, influence (B, Nq, hs, K) read in place (its first h columns),
// H <= 32, the weight as the wrapper's panels.  tc48 below takes 32 < H <=
// 48, the first design wider sets.
extern "C" int se3et_gather_wf_mm_bf16(const void* x, const void* nbr, const void* infl,
                                       const void* panels, void* out, int batch, int ns,
                                       int nq, int h, int hs, int k, int ac, int ac_out,
                                       void* stream) {
  return tc::launch(x, nbr, infl, panels, out, nullptr, nullptr, batch, ns, nq, h, hs, k, ac,
                    ac_out, 0, tc::kDefaultPhases, stream);
}

// the same with the phases chosen (bits: 1 gather, 2 weight product, 4 the
// last wave in half tiles), for scripts/probe_gather_wf_mm.py
extern "C" int se3et_gather_wf_mm_bf16_phases(const void* x, const void* nbr, const void* infl,
                                              const void* panels, void* out, int batch, int ns,
                                              int nq, int h, int hs, int k, int ac, int ac_out,
                                              int phases, void* stream) {
  return tc::launch(x, nbr, infl, panels, out, nullptr, nullptr, batch, ns, nq, h, hs, k, ac,
                    ac_out, 0, phases, stream);
}

// K13 in bf16 on K12's tensor-core tiles, H <= 32, A*Cout <= 192, AC2 a
// multiple of 8 up to 1536, influence read in place as for
// K12, the weight as K12's panels; x2 (B, Ns, AC2), pooled (B, Nq, AC2).
extern "C" int se3et_gather_wf_max_mm_tc_bf16(const void* x, const void* nbr, const void* infl,
                                              const void* panels, void* out, const void* x2,
                                              void* pooled, int batch, int ns, int nq, int h,
                                              int hs, int k, int ac, int ac_out, int ac2,
                                              void* stream) {
  if (!x2 || !pooled) return (int)cudaErrorInvalidValue;
  return tc::launch(x, nbr, infl, panels, out, x2, pooled, batch, ns, nq, h, hs, k, ac, ac_out,
                    ac2, tc::kMaxDefaultPhases, stream);
}

// the same with the phases chosen (bits: 1 gather, 2 weight product, 4 the
// last wave in half tiles, 8 the skip max, 16 the exit of tiles without a
// valid neighbour), for scripts/probe_gather_wf_mm.py
extern "C" int se3et_gather_wf_max_mm_tc_bf16_phases(
    const void* x, const void* nbr, const void* infl, const void* panels, void* out,
    const void* x2, void* pooled, int batch, int ns, int nq, int h, int hs, int k, int ac,
    int ac_out, int ac2, int phases, void* stream) {
  if (!x2 || !pooled) return (int)cudaErrorInvalidValue;
  return tc::launch(x, nbr, infl, panels, out, x2, pooled, batch, ns, nq, h, hs, k, ac, ac_out,
                    ac2, phases, stream);
}

// K12 in bf16 for 32 < H <= 48 on the tensor cores ("tc48"): the influence
// (B, Nq, hs, K) read in place (its first h columns), the weight as the
// H <= 32 form's panels, 48-row tiles
extern "C" int se3et_gather_wf_mm_tc48_bf16(const void* x, const void* nbr, const void* infl,
                                            const void* panels, void* out, int batch, int ns,
                                            int nq, int h, int hs, int k, int ac, int ac_out,
                                            void* stream) {
  return tc48::launch(x, nbr, infl, panels, out, batch, ns, nq, h, hs, k, ac, ac_out,
                      tc48::kDefaultPhases, stream);
}

// the same with the phases chosen (bits: 1 gather, 2 weight product), for
// scripts/probe_gather_wf_mm.py
extern "C" int se3et_gather_wf_mm_tc48_bf16_phases(const void* x, const void* nbr,
                                                   const void* infl, const void* panels,
                                                   void* out, int batch, int ns, int nq, int h,
                                                   int hs, int k, int ac, int ac_out, int phases,
                                                   void* stream) {
  return tc48::launch(x, nbr, infl, panels, out, batch, ns, nq, h, hs, k, ac, ac_out, phases,
                      stream);
}

// tc48's plan for `rows` flattened query rows: plan[0] shared memory bytes,
// [1] 48-row tiles (blocks), [2] rows a tile, [3] weight ring slots, [4]
// neighbour-row buffers a warp; windowed_conv.gather_wf_mm_tc48_plan
// mirrors it
extern "C" int se3et_gather_wf_mm_tc48_plan(int h, int k, int ac_out, int rows, int* plan) {
  if (!tc48::takes(h, h, k, 8, ac_out) || rows < 1) return (int)cudaErrorInvalidValue;
  tc48::plan(h, rows, &plan[0], &plan[1]);
  plan[2] = tc48::kBM;
  plan[3] = tc48::kStages;
  plan[4] = tc48::stage_rows(h);
  return 0;
}

// K12 in bf16 for H > 48 (the first design; also, with form "first" chosen
// by the caller, for any H): the CUDA-core gather of K13 without the skip,
// influence padded to 16 per (query, neighbour)
extern "C" int se3et_gather_wf_mm_wide_bf16(const void* x, const void* nbr, const void* infl,
                                            const void* rhs_t, void* out, int batch, int ns,
                                            int nq, int h, int k, int ac, int ac_out,
                                            void* stream) {
  return launch<__nv_bfloat16, false>(x, nbr, infl, rhs_t, out, nullptr, nullptr, batch, ns,
                                      nq, h, k, ac, ac_out, 0, stream);
}

extern "C" int se3et_gather_wf_mm_f32(const void* x, const void* nbr, const void* infl,
                                      const void* rhs_t, void* out, int batch, int ns, int nq,
                                      int h, int k, int ac, int ac_out, void* stream) {
  return launch<float, false>(x, nbr, infl, rhs_t, out, nullptr, nullptr, batch, ns, nq, h,
                              k, ac, ac_out, 0, stream);
}

extern "C" int se3et_gather_wf_max_mm_bf16(const void* x, const void* nbr, const void* infl,
                                           const void* rhs_t, void* out, const void* x2,
                                           void* pooled, int batch, int ns, int nq, int h,
                                           int k, int ac, int ac_out, int ac2, void* stream) {
  return launch<__nv_bfloat16, true>(x, nbr, infl, rhs_t, out, x2, pooled, batch, ns, nq, h,
                                     k, ac, ac_out, ac2, stream);
}

extern "C" int se3et_gather_wf_max_mm_f32(const void* x, const void* nbr, const void* infl,
                                          const void* rhs_t, void* out, const void* x2,
                                          void* pooled, int batch, int ns, int nq, int h,
                                          int k, int ac, int ac_out, int ac2, void* stream) {
  return launch<float, true>(x, nbr, infl, rhs_t, out, x2, pooled, batch, ns, nq, h, k, ac,
                             ac_out, ac2, stream);
}
