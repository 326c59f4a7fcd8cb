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
// Design: a block owns 64 query rows and keeps their (64, A*Cout) float32
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

}  // namespace

extern "C" int se3et_gather_wf_mm_bf16(const void* x, const void* nbr, const void* infl,
                                       const void* rhs_t, void* out, int batch, int ns,
                                       int nq, int h, int k, int ac, int ac_out, void* stream) {
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
