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
// are written; the (B, Nq, H, K) output dominates.  Design: a block owns
// R = 256 / H query rows, one thread per (p, h): the thread writes its K
// weights (consecutive threads write consecutive rows of the output) and
// keeps them in shared memory as float32; after a barrier one thread per
// (p, k) sums its H values in h order (no atomics, reproducible).
#include "embedding_common.cuh"

namespace {

using se3et::store;

constexpr int kThreads = 256;
constexpr int kMaxK = 16;

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
    s_kp[threadIdx.x][3] = x * x + y * y + z * z;
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
    const float rx = sp[0] - qp[0], ry = sp[1] - qp[1], rz = sp[2] - qp[2];
    const float rel2 = rx * rx + ry * ry + rz * rz;
    const float gauss = -1.f / (2.f * (0.3f * sigma) * (0.3f * sigma));
    TOut* out = infl + slot * k_dim;
    float* w_s = s_w + (pl * h + hh) * k_dim;
    for (int kk = 0; kk < k_dim; ++kk) {
      const float dot = rx * s_kp[kk][0] + ry * s_kp[kk][1] + rz * s_kp[kk][2];
      const float sq = fmaxf(rel2 - 2.f * dot + s_kp[kk][3], 0.f);
      float w;
      if (mode == 0) {
        w = fmaxf(1.f - sqrtf(sq) / sigma, 0.f);
      } else if (mode == 1) {
        w = 1.f;
      } else {
        w = expf(sq * gauss);
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
