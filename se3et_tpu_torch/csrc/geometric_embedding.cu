// Geometric-structure embedding of the coarse transformer (K3).
//
//   emb[b, n, m, :] = T_d(dist(n, m)) @ Gd + bd
//                     + max_k (T_a(angle_k(n, m)) @ Ga + ba)
//
// T_d / T_a are Chebyshev bases (three-term recurrence) of the clipped
// index variables t = clip(x * inv_half_range - 1, -1, 1); G = A @ W folds
// the static Chebyshev fit of the sinusoid features into the learned
// projection (done by the wrapper).  Same function as the TPU kernel
// se3et_tpu/ops/pallas/embedding.py geometric_embedding_pallas, except that
// the angle is the exact atan2f and the distance is the expanded
// |q|^2 - 2 q.p + |p|^2 form of the reference's pairwise_distance.
//
// Bound: fp32 FMA throughput (DD + KA*DA = 88 FMAs per output element) and
// the (B, N, N, C) output write.  Design: one block per query row, one
// thread per channel c.  Each thread keeps its columns of Gd and Ga in
// registers; per tile of TM support points the block first builds the
// bases into shared memory (read back as float4 broadcasts), then every
// thread runs the two projections for its channel and writes one
// coalesced C-wide output row per support point.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTM = 32;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// basis[0..deg) of T_k(t), t = clip(x * inv - 1, -1, 1)
template <int DEG>
__device__ __forceinline__ void cheb_basis(float x, float inv, float* dst) {
  const float t = fminf(fmaxf(x * inv - 1.f, -1.f), 1.f);
  float prev = 1.f, cur = t;
  const float two_t = 2.f * t;
#pragma unroll
  for (int k = 0; k < DEG; ++k) {
    dst[k] = prev;
    const float nxt = two_t * cur - prev;
    prev = cur;
    cur = nxt;
  }
}

template <int DD, int DA, int KA, typename TOut>
__global__ void embedding_kernel(const float* __restrict__ points,
                                 const float* __restrict__ knn,
                                 const float* __restrict__ gd, const float* __restrict__ bd,
                                 const float* __restrict__ ga, const float* __restrict__ ba,
                                 TOut* __restrict__ out, int n_pts, int c_dim,
                                 float inv_d, float inv_a) {
  __shared__ __align__(16) float s_bd[kTM][DD];
  __shared__ __align__(16) float s_ba[KA][kTM][DA];

  const int b = blockIdx.y;
  const int n = blockIdx.x;
  const int c = threadIdx.x;
  const float* pb = points + (long long)b * n_pts * 3;
  const float qx = pb[n * 3 + 0], qy = pb[n * 3 + 1], qz = pb[n * 3 + 2];
  const float q2 = qx * qx + qy * qy + qz * qz;
  float rx[KA], ry[KA], rz[KA];
  const float* kb = knn + ((long long)b * n_pts + n) * KA * 3;
#pragma unroll
  for (int k = 0; k < KA; ++k) {
    rx[k] = kb[k * 3 + 0] - qx;
    ry[k] = kb[k * 3 + 1] - qy;
    rz[k] = kb[k * 3 + 2] - qz;
  }

  float gdc[DD], gac[DA];
  float bdc = 0.f, bac = 0.f;
  if (c < c_dim) {
#pragma unroll
    for (int j = 0; j < DD; ++j) gdc[j] = gd[j * c_dim + c];
#pragma unroll
    for (int j = 0; j < DA; ++j) gac[j] = ga[j * c_dim + c];
    bdc = bd[c];
    bac = ba[c];
  }
  TOut* ob = out + ((long long)b * n_pts + n) * (long long)n_pts * c_dim;

  for (int m0 = 0; m0 < n_pts; m0 += kTM) {
    const int tm = min(kTM, n_pts - m0);
    __syncthreads();
    for (int task = threadIdx.x; task < tm * (1 + KA); task += blockDim.x) {
      const int kind = task / tm;
      const int mm = task - kind * tm;
      const int m = m0 + mm;
      const float px = pb[m * 3 + 0], py = pb[m * 3 + 1], pz = pb[m * 3 + 2];
      if (kind == 0) {
        const float p2 = px * px + py * py + pz * pz;
        const float qp = qx * px + qy * py + qz * pz;
        const float sq = fmaxf(q2 - 2.f * qp + p2, 0.f);
        cheb_basis<DD>(sqrtf(sq), inv_d, s_bd[mm]);
      } else {
        const int k = kind - 1;
        const float ax = px - qx, ay = py - qy, az = pz - qz;
        const float cx = ry[k] * az - rz[k] * ay;
        const float cy = rz[k] * ax - rx[k] * az;
        const float cz = rx[k] * ay - ry[k] * ax;
        const float sn = sqrtf(cx * cx + cy * cy + cz * cz);
        // + 0 folds a -0 dot product of a self-pair to +0: atan2(0, 0) = 0
        const float cs = rx[k] * ax + ry[k] * ay + rz[k] * az + 0.f;
        cheb_basis<DA>(atan2f(sn, cs), inv_a, s_ba[k][mm]);
      }
    }
    __syncthreads();
    if (c >= c_dim) continue;
    for (int mm = 0; mm < tm; ++mm) {
      float acc = bdc;
      const float4* bdv = reinterpret_cast<const float4*>(s_bd[mm]);
#pragma unroll
      for (int j = 0; j < DD / 4; ++j) {
        const float4 t = bdv[j];
        acc = fmaf(t.x, gdc[4 * j + 0], acc);
        acc = fmaf(t.y, gdc[4 * j + 1], acc);
        acc = fmaf(t.z, gdc[4 * j + 2], acc);
        acc = fmaf(t.w, gdc[4 * j + 3], acc);
      }
      float amax = __int_as_float(0xff800000);
#pragma unroll
      for (int k = 0; k < KA; ++k) {
        float a = bac;
        const float4* bav = reinterpret_cast<const float4*>(s_ba[k][mm]);
#pragma unroll
        for (int j = 0; j < DA / 4; ++j) {
          const float4 t = bav[j];
          a = fmaf(t.x, gac[4 * j + 0], a);
          a = fmaf(t.y, gac[4 * j + 1], a);
          a = fmaf(t.z, gac[4 * j + 2], a);
          a = fmaf(t.w, gac[4 * j + 3], a);
        }
        amax = fmaxf(amax, a);
      }
      store(ob + (long long)(m0 + mm) * c_dim + c, acc + amax);
    }
  }
}

template <typename TOut>
int launch(const void* points, const void* knn, const void* gd, const void* bd,
           const void* ga, const void* ba, void* out, int batch, int n_pts, int c_dim,
           int deg_d, int deg_a, int ka, float inv_d, float inv_a, void* stream) {
  if (deg_d != 40 || deg_a != 16 || ka != 3 || c_dim > 1024 || c_dim < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = ((c_dim + 31) / 32) * 32;
  dim3 grid(n_pts, batch);
  embedding_kernel<40, 16, 3, TOut><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)knn, (const float*)gd, (const float*)bd,
      (const float*)ga, (const float*)ba, (TOut*)out, n_pts, c_dim, inv_d, inv_a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int se3et_geometric_embedding_bf16(
    const void* points, const void* knn, const void* gd, const void* bd, const void* ga,
    const void* ba, void* out, int batch, int n_pts, int c_dim, int deg_d, int deg_a,
    int ka, float inv_d, float inv_a, void* stream) {
  return launch<__nv_bfloat16>(points, knn, gd, bd, ga, ba, out, batch, n_pts, c_dim,
                               deg_d, deg_a, ka, inv_d, inv_a, stream);
}

extern "C" int se3et_geometric_embedding_f32(
    const void* points, const void* knn, const void* gd, const void* bd, const void* ga,
    const void* ba, void* out, int batch, int n_pts, int c_dim, int deg_d, int deg_a,
    int ka, float inv_d, float inv_a, void* stream) {
  return launch<float>(points, knn, gd, bd, ga, ba, out, batch, n_pts, c_dim, deg_d,
                       deg_a, ka, inv_d, inv_a, stream);
}
