// Neighbour max-pool of the strided E2PN skip (K2).
//
//   out[b, q, ac] = max_h (nbr[b, q, h] < Ns ? x[b, nbr[b, q, h], ac] : 0)
//
// A sentinel neighbour is a zero row that takes part in the max (the
// reference's zero pad row, se3et_tpu/nn/epn.py max_pool_neighbors).
// Replaces the TPU kernel se3et_tpu/ops/pallas/windowed_conv.py
// windowed_max_pool and the skip half of windowed_gather_wf_max(_mm).
//
// Bound: device memory (a gather plus a compare per element, no
// arithmetic to speak of).  Design: a block takes QB query rows with their
// indices staged in shared memory; each thread owns one (query, channel)
// column and streams its H neighbour values, so a warp reads AC-contiguous
// runs of one row.  The max is exact, so the result is bit-identical to
// the plain version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kQB = 4;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void neighbor_max_kernel(const T* __restrict__ x, const int* __restrict__ nbr,
                                    T* __restrict__ out, int ns, int nq, int h, int ac) {
  extern __shared__ int s_nbr[];  // [kQB][h]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQB;
  const int nrows = min(kQB, nq - q0);
  const long long row0 = (long long)b * nq + q0;
  for (int i = threadIdx.x; i < nrows * h; i += blockDim.x) {
    s_nbr[i] = nbr[row0 * h + i];
  }
  __syncthreads();

  const T* xb = x + (long long)b * ns * ac;
  for (int item = threadIdx.x; item < nrows * ac; item += blockDim.x) {
    const int ql = item / ac;
    const int c = item - ql * ac;
    const int* rn = s_nbr + ql * h;
    float m = __int_as_float(0xff800000);  // -inf
    for (int hh = 0; hh < h; ++hh) {
      const int j = rn[hh];
      const float v = (j < ns && j >= 0) ? to_f(xb[(long long)j * ac + c]) : 0.f;
      m = fmaxf(m, v);
    }
    store(out + (row0 + ql) * (long long)ac + c, m);
  }
}

template <typename T>
int launch(const void* x, const void* nbr, void* out, int batch, int ns, int nq, int h,
           int ac, void* stream) {
  if (h < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kQB * h * sizeof(int);
  dim3 grid((nq + kQB - 1) / kQB, batch);
  neighbor_max_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const int*)nbr, (T*)out, ns, nq, h, ac);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int se3et_neighbor_max_bf16(const void* x, const void* nbr, void* out,
                                       int batch, int ns, int nq, int h, int ac,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, nbr, out, batch, ns, nq, h, ac, stream);
}

extern "C" int se3et_neighbor_max_f32(const void* x, const void* nbr, void* out,
                                      int batch, int ns, int nq, int h, int ac,
                                      void* stream) {
  return launch<float>(x, nbr, out, batch, ns, nq, h, ac, stream);
}
