// Neighbour gather x influence contraction of the E2PN conv (K1).
//
//   wf[b, q, k, ac] = sum_h infl[b, q, h, k] * x[b, nbr[b, q, h], ac]
//
// with nbr == Ns a sentinel (the entry contributes nothing).  Replaces the
// TPU kernel se3et_tpu/ops/pallas/windowed_conv.py windowed_gather_wf and
// the gather half of windowed_gather_wf_mm / _max / _max_mm.
//
// Bound: device memory.  Each query reads H neighbour rows of AC features
// (mostly L2 hits: Morton-ordered neighbours overlap between queries) and
// writes K*AC outputs, at about one FMA per byte.  Design: a block takes
// QB query rows; their neighbour indices and influence rows are staged in
// shared memory, and each thread owns one (query, channel) column, keeps
// the K sums in registers (fp32) and streams the H neighbour values of
// its channel, so that a warp reads AC-contiguous runs of one row.  Each
// gathered value is used by exactly one thread, so the neighbour rows
// themselves are not staged in shared memory (there is no reuse to buy).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kQB = 4;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void gather_wf_kernel(const T* __restrict__ x, const int* __restrict__ nbr,
                                 const T* __restrict__ infl, T* __restrict__ out,
                                 int ns, int nq, int h, int k, int ac) {
  extern __shared__ float smem[];
  float* s_w = smem;                                  // [kQB][h][k]
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
    T* o = out + (row0 + ql) * (long long)k * ac + c;
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) {
      if (kk < k) store(o + (long long)kk * ac, acc[kk]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* nbr, const void* infl, void* out, int batch,
           int ns, int nq, int h, int k, int ac, void* stream) {
  if (k > kMaxK || k < 1 || h < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kQB * h * (k * sizeof(float) + sizeof(int));
  dim3 grid((nq + kQB - 1) / kQB, batch);
  gather_wf_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const int*)nbr, (const T*)infl, (T*)out, ns, nq, h, k, ac);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int se3et_gather_wf_bf16(const void* x, const void* nbr, const void* infl,
                                    void* out, int batch, int ns, int nq, int h, int k,
                                    int ac, void* stream) {
  return launch<__nv_bfloat16>(x, nbr, infl, out, batch, ns, nq, h, k, ac, stream);
}

extern "C" int se3et_gather_wf_f32(const void* x, const void* nbr, const void* infl,
                                   void* out, int batch, int ns, int nq, int h, int k,
                                   int ac, void* stream) {
  return launch<float>(x, nbr, infl, out, batch, ns, nq, h, k, ac, stream);
}
