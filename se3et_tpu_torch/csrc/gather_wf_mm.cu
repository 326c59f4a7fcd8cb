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
// outgrow registers and shared memory; that form, the float32 K12 (the tiny
// card-vs-CPU checks only) and K13 keep the first design below, K13 bit
// for bit.
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
#include "attention_common.cuh"

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
// phase bits (the probe's): the gather, the weight product, the last wave in
// half tiles
constexpr int kGather = 1, kProduct = 2, kSplitTail = 4;
constexpr int kDefaultPhases = kGather | kProduct | kSplitTail;

// element offset of channel c (0..31) in row r of a tile of 64-byte rows,
// 16-byte units XOR-swizzled by row pair: the 8 rows an ldmatrix phase
// reads, and the rows a fragment store writes, hit 32 distinct banks.  The
// wrapper lays the weight panels out in global memory in this order.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kCW + ((((c >> 3) ^ (r >> 1)) & 3) << 3) + (c & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem)));
}

// mbarriers of the weight ring, and the bulk copy that fills a slot
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
// a bulk global -> shared copy that signals `bar` with its bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
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

template <int NT, int HS>
__global__ void __launch_bounds__(kThreads, 1)
gather_wf_mm_tc_kernel(const bf16* __restrict__ x, const int* __restrict__ nbr,
                       const bf16* __restrict__ infl, const bf16* __restrict__ panels,
                       float* __restrict__ out, int ns, int nq, int rows, int h, int hs, int k,
                       int ac, int ac_out, int nfull, int phases) {
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

  for (int i = tid; i < kBM * h; i += kThreads)
    s_nbr[i] = i < nrows * h ? nbr[(long long)r0 * h + i] : ns;
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

template <int NT, int HS>
int launch_nt(int nblocks, size_t smem, cudaStream_t stream, const void* x, const void* nbr,
              const void* infl, const void* panels, void* out, int ns, int nq, int rows, int h,
              int hs, int k, int ac, int ac_out, int nfull, int phases) {
  auto fn = gather_wf_mm_tc_kernel<NT, HS>;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<nblocks, kThreads, smem, stream>>>((const bf16*)x, (const int*)nbr, (const bf16*)infl,
                                          (const bf16*)panels, (float*)out, ns, nq, rows, h,
                                          hs, k, ac, ac_out, nfull, phases);
  return (int)cudaGetLastError();
}

template <int HS>
int launch_hs(int grid, size_t smem, cudaStream_t st, const void* x, const void* nbr,
              const void* infl, const void* panels, void* out, int ns, int nq, int rows, int h,
              int hs, int k, int ac, int ac_out, int nfull, int phases) {
  const int per = (ac_out / 8 + 3) / 4;
  if (per <= 2)
    return launch_nt<2, HS>(grid, smem, st, x, nbr, infl, panels, out, ns, nq, rows, h, hs, k,
                            ac, ac_out, nfull, phases);
  if (per <= 6)
    return launch_nt<6, HS>(grid, smem, st, x, nbr, infl, panels, out, ns, nq, rows, h, hs, k,
                            ac, ac_out, nfull, phases);
  return launch_nt<12, HS>(grid, smem, st, x, nbr, infl, panels, out, ns, nq, rows, h, hs, k,
                           ac, ac_out, nfull, phases);
}

// One block per SM (the (64, A*Cout) float32 accumulator and the influence
// fragments take up to ~170 registers a thread).  With T full tiles on S SMs
// the last wave holds T mod S tiles; when its rows fit in S half tiles, it
// runs as half tiles, so that more SMs share it (kSplitTail).  panels: the
// weight as (chunks, K, A*Cout, 32) bf16, rows swizzled as swz(), zero past AC.
int launch(const void* x, const void* nbr, const void* infl, const void* panels, void* out,
           int batch, int ns, int nq, int h, int hs, int k, int ac, int ac_out, int phases,
           void* stream) {
  if (k < 1 || k > kKP || h < 1 || h > kMaxH || hs < h || ac < 8 || ac % 8 || ac_out < 8 ||
      ac_out % 8 || ac_out > kMaxAcOutMM || (reinterpret_cast<uintptr_t>(panels) & 15))
    return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  const int rows = batch * nq;
  const int tiles = (rows + kBM - 1) / kBM;
  int nfull = tiles, nblocks = tiles;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int waves = tiles / sms;
  if ((phases & kSplitTail) && waves > 0 && tiles % sms) {
    const int rest = rows - waves * sms * kBM;
    const int halves = (rest + kBM / 2 - 1) / (kBM / 2);
    if (halves <= sms) {
      nfull = waves * sms;
      nblocks = nfull + halves;
    }
  }
  const size_t smem = smem_bytes(h, k, ac_out);
  const int grid = nblocks;
  cudaStream_t st = (cudaStream_t)stream;
  if (h <= 16)
    return launch_hs<1>(grid, smem, st, x, nbr, infl, panels, out, ns, nq, rows, h, hs, k, ac,
                        ac_out, nfull, phases);
  return launch_hs<2>(grid, smem, st, x, nbr, infl, panels, out, ns, nq, rows, h, hs, k, ac,
                      ac_out, nfull, phases);
}

}  // namespace tc

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
// H <= 32, the weight as the wrapper's panels.  The wide-neighbour form
// below takes H > 32.
extern "C" int se3et_gather_wf_mm_bf16(const void* x, const void* nbr, const void* infl,
                                       const void* panels, void* out, int batch, int ns,
                                       int nq, int h, int hs, int k, int ac, int ac_out,
                                       void* stream) {
  return tc::launch(x, nbr, infl, panels, out, batch, ns, nq, h, hs, k, ac, ac_out,
                    tc::kDefaultPhases, stream);
}

// the same with the phases chosen (bits: 1 gather, 2 weight product, 4 the
// last wave in half tiles), for scripts/probe_gather_wf_mm.py
extern "C" int se3et_gather_wf_mm_bf16_phases(const void* x, const void* nbr, const void* infl,
                                              const void* panels, void* out, int batch, int ns,
                                              int nq, int h, int hs, int k, int ac, int ac_out,
                                              int phases, void* stream) {
  return tc::launch(x, nbr, infl, panels, out, batch, ns, nq, h, hs, k, ac, ac_out, phases,
                    stream);
}

// K12 in bf16 for H > 32: the CUDA-core gather of K13 without the skip,
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
