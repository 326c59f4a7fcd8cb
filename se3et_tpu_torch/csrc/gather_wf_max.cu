// E2PN conv gather x influence contraction and the strided skip's
// neighbour max in one pass over the neighbour indices (K14).
//
//   wf[b, q, k, ac]     = sum_h infl[b, q, h, k] * x[b, nbr[b, q, h], ac]
//   pooled[b, q, ac2]   = max_h (nbr valid ? x2[b, nbr[b, q, h], ac2] : 0)
//
// with nbr == Ns a sentinel (no contribution to wf, a zero row in the max).
// Replaces the TPU kernel se3et_tpu/ops/pallas/windowed_conv.py
// windowed_gather_wf_max; the weight product follows as a torch.matmul, as
// the JAX package leaves it to XLA.
//
// Bound: device memory.  At the serving shape (the s1 -> s2 strided block)
// the skip payload's neighbour rows and the flat wf output dominate, at
// about one operation per byte.  Design: a block takes kQB query rows and
// stages their neighbour indices and influence rows in shared memory once;
// then each thread owns one (query, channel) column of the conv, keeps its
// K sums in registers and streams its H neighbour values (the arithmetic of
// K1's first design, so wf equals that form's output bit for bit).  For the skip, each thread owns up to
// kGroups groups of 8 payload channels and keeps their maxima in registers
// through one pass over the neighbour slots, so every slot issues kGroups
// independent 16-byte loads (the max in K2's order, bit-identical to it).
// That register budget bounds the payload: kQB * A*C2 <= kGroups * 8 *
// kThreads, A*C2 <= 1536; a wider skip (the s2 -> s3 block, 3072 channels)
// pools in K2, as the JAX package pools it in windowed_max_pool there.
#include "attention_common.cuh"

namespace {

using se3et::Elem;

constexpr int kMaxK = 16;
constexpr int kQB = 4;
constexpr int kThreads = 128;
constexpr int kGroups = 6;  // 8-channel skip groups per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void gather_wf_max_kernel(const T* __restrict__ x, const int* __restrict__ nbr,
                                     const T* __restrict__ infl, T* __restrict__ wf,
                                     const T* __restrict__ x2, T* __restrict__ pooled, int ns,
                                     int nq, int h, int k, int ac, int ac2) {
  extern __shared__ float smem[];
  float* s_w = smem;                                       // [kQB][h][k]
  int* s_nbr = reinterpret_cast<int*>(s_w + kQB * h * k);  // [kQB][h]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQB;
  const int nrows = min(kQB, nq - q0);
  const long long row0 = (long long)b * nq + q0;

  for (int i = threadIdx.x; i < nrows * h; i += blockDim.x) {
    s_nbr[i] = nbr[row0 * h + i];
  }
  for (int i = threadIdx.x; i < nrows * h * k; i += blockDim.x) {
    s_w[i] = to_f(infl[row0 * h * k + i]);
  }
  __syncthreads();

  const T* xb = x + (long long)b * ns * ac;
  for (int item = threadIdx.x; item < nrows * ac; item += blockDim.x) {
    const int ql = item / ac;
    const int c = item - ql * ac;
    float acc[kMaxK];
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) acc[kk] = 0.f;
    const int* rn = s_nbr + ql * h;
    const float* rw = s_w + ql * h * k;
    for (int hh = 0; hh < h; ++hh) {
      const int j = rn[hh];
      if (j >= ns || j < 0) continue;
      const float xv = to_f(xb[(long long)j * ac + c]);
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < k) acc[kk] = fmaf(rw[hh * k + kk], xv, acc[kk]);
      }
    }
    T* o = wf + (row0 + ql) * (long long)k * ac + c;
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) {
      if (kk < k) store(o + (long long)kk * ac, acc[kk]);
    }
  }

  const T* x2b = x2 + (long long)b * ns * ac2;
  const int ng = ac2 / 8;
  float m[kGroups][8];
#pragma unroll
  for (int i = 0; i < kGroups; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) m[i][e] = __int_as_float(0xff800000);  // -inf
  for (int hh = 0; hh < h; ++hh) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int item = threadIdx.x + i * kThreads;
      if (item >= nrows * ng) continue;
      const int ql = item / ng;
      const int j = s_nbr[ql * h + hh];
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < ns && j >= 0) Elem<T>::load8(x2b + (long long)j * ac2 + (item - ql * ng) * 8, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) m[i][e] = fmaxf(m[i][e], v[e]);
    }
  }
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int item = threadIdx.x + i * kThreads;
    if (item >= nrows * ng) continue;
    const int ql = item / ng;
    T* o = pooled + (row0 + ql) * (long long)ac2 + (item - ql * ng) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) store(o + e, m[i][e]);
  }
}

template <typename T>
int launch(const void* x, const void* nbr, const void* infl, void* wf, const void* x2,
           void* pooled, int batch, int ns, int nq, int h, int k, int ac, int ac2,
           void* stream) {
  if (k > kMaxK || k < 1 || h < 1 || ac < 1 || ac2 < 8 || ac2 % 8 ||
      kQB * ac2 > kGroups * 8 * kThreads)
    return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  const size_t smem = (size_t)kQB * h * (k * sizeof(float) + sizeof(int));
  dim3 grid((nq + kQB - 1) / kQB, batch);
  gather_wf_max_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const int*)nbr, (const T*)infl, (T*)wf, (const T*)x2, (T*)pooled, ns, nq,
      h, k, ac, ac2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int se3et_gather_wf_max_bf16(const void* x, const void* nbr, const void* infl,
                                        void* wf, const void* x2, void* pooled, int batch,
                                        int ns, int nq, int h, int k, int ac, int ac2,
                                        void* stream) {
  return launch<__nv_bfloat16>(x, nbr, infl, wf, x2, pooled, batch, ns, nq, h, k, ac, ac2,
                               stream);
}

extern "C" int se3et_gather_wf_max_f32(const void* x, const void* nbr, const void* infl,
                                       void* wf, const void* x2, void* pooled, int batch,
                                       int ns, int nq, int h, int k, int ac, int ac2,
                                       void* stream) {
  return launch<float>(x, nbr, infl, wf, x2, pooled, batch, ns, nq, h, k, ac, ac2, stream);
}
