// Fused log-domain Sinkhorn iterations with fixed max-shifts (K4).
//
// Same function as the TPU kernel se3et_tpu/ops/pallas/sinkhorn.py
// sinkhorn_pallas:
//   m_row = max(max_j s[i, j], -1e30)      e_row = exp(s - m_row)
//   m_col = max(max_i s[i, j], -1e30)      e_col = exp(s - m_col)
//   repeat: u = clip(log_mu - m_row - log(sum_j e_row * exp(v) + 1e-30), +-80)
//           v = clip(log_nu - m_col - log(sum_i e_col * exp(u) + 1e-30), +-80)
//   out = s + u + v
//
// Bound: latency.  100 iterations of two small reductions per matrix are
// serial, and at the serving shape (256 patches of 65 x 65) each pass
// touches only 17 KB.  Design: one block per patch matrix, with e_row and
// its transpose e_col held in shared memory across all iterations (no
// device-memory traffic inside the loop), one warp per row (or column)
// reducing with shuffles, and exp(u) / exp(v) kept in shared memory so
// each pass reads the other's result after a single barrier.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void sinkhorn_kernel(const float* __restrict__ scores,
                                const float* __restrict__ log_mu,
                                const float* __restrict__ log_nu,
                                float* __restrict__ out, int m, int n, int iters) {
  extern __shared__ float smem[];
  float* e_row = smem;          // [m][n]
  float* e_col = e_row + m * n;  // [n][m]
  float* m_row = e_col + n * m;  // [m]
  float* m_col = m_row + m;      // [n]
  float* u = m_col + n;          // [m]
  float* v = u + m;              // [n]
  float* eu = v + n;             // [m]  exp(u)
  float* ev = eu + m;            // [n]  exp(v)

  const int b = blockIdx.x;
  const float* s = scores + (long long)b * m * n;
  const float* lmu = log_mu + (long long)b * m;
  const float* lnu = log_nu + (long long)b * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = warp; i < m; i += kWarps) {
    float mx = __int_as_float(0xff800000);
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s[i * n + j]);
    mx = warp_max(mx);
    if (lane == 0) m_row[i] = fmaxf(mx, -1e30f);
  }
  for (int j = warp; j < n; j += kWarps) {
    float mx = __int_as_float(0xff800000);
    for (int i = lane; i < m; i += 32) mx = fmaxf(mx, s[i * n + j]);
    mx = warp_max(mx);
    if (lane == 0) m_col[j] = fmaxf(mx, -1e30f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < m * n; idx += kThreads) {
    const int i = idx / n;
    const int j = idx - i * n;
    const float sv = s[idx];
    e_row[idx] = expf(sv - m_row[i]);
    e_col[j * m + i] = expf(sv - m_col[j]);
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    v[j] = 0.f;
    ev[j] = 1.f;
  }
  for (int i = threadIdx.x; i < m; i += kThreads) u[i] = 0.f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int i = warp; i < m; i += kWarps) {
      float acc = 0.f;
      for (int j = lane; j < n; j += 32) acc = fmaf(e_row[i * n + j], ev[j], acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float ui = fminf(fmaxf(lmu[i] - m_row[i] - logf(acc + 1e-30f), -80.f), 80.f);
        u[i] = ui;
        eu[i] = expf(ui);
      }
    }
    __syncthreads();
    for (int j = warp; j < n; j += kWarps) {
      float acc = 0.f;
      for (int i = lane; i < m; i += 32) acc = fmaf(e_col[j * m + i], eu[i], acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float vj = fminf(fmaxf(lnu[j] - m_col[j] - logf(acc + 1e-30f), -80.f), 80.f);
        v[j] = vj;
        ev[j] = expf(vj);
      }
    }
    __syncthreads();
  }

  float* o = out + (long long)b * m * n;
  for (int idx = threadIdx.x; idx < m * n; idx += kThreads) {
    const int i = idx / n;
    const int j = idx - i * n;
    o[idx] = s[idx] + u[i] + v[j];
  }
}

}  // namespace

extern "C" int se3et_sinkhorn_f32(const void* scores, const void* log_mu,
                                  const void* log_nu, void* out, int batch, int m,
                                  int n, int iters, void* stream) {
  const size_t smem = (2 * (size_t)m * n + 3 * (size_t)(m + n)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)log_mu, (const float*)log_nu, (float*)out, m,
      n, iters);
  return (int)cudaGetLastError();
}
