// Device functions of the geometric-structure embedding shared by K3 / K10
// (geometric_embedding.cu) and the fused-embedding attention K16
// (rpe_attention_femb.cu): the pair geometry (the expanded distance and the
// triplet angle) and the Chebyshev basis of the clipped index variable.
// Both kernels evaluate a pair with these same functions, so K16's tiles
// are K3's arithmetic up to the roundings K16 applies on top.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace se3et {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// dst[0..DEG) = T_k(t), t = clip(x * inv - 1, -1, 1), in dst's type
template <int DEG, typename T>
__device__ __forceinline__ void cheb_basis(float x, float inv, T* dst) {
  const float t = fminf(fmaxf(x * inv - 1.f, -1.f), 1.f);
  float prev = 1.f, cur = t;
  const float two_t = 2.f * t;
#pragma unroll
  for (int k = 0; k < DEG; ++k) {
    store(dst + k, prev);
    const float nxt = two_t * cur - prev;
    prev = cur;
    cur = nxt;
  }
}

// |q - p| by the reference's expanded |q|^2 - 2 q.p + |p|^2 form, clamped at 0
__device__ __forceinline__ float pair_distance(float qx, float qy, float qz, float q2,
                                               float px, float py, float pz) {
  const float p2 = px * px + py * py + pz * pz;
  const float qp = qx * px + qy * py + qz * pz;
  return sqrtf(fmaxf(q2 - 2.f * qp + p2, 0.f));
}

// angle between the neighbour offset r = knn_k - q and a = p - q, in [0, pi]
__device__ __forceinline__ float pair_angle(float rx, float ry, float rz, float ax, float ay,
                                            float az) {
  const float cx = ry * az - rz * ay;
  const float cy = rz * ax - rx * az;
  const float cz = rx * ay - ry * ax;
  const float sn = sqrtf(cx * cx + cy * cy + cz * cz);
  // + 0 folds a -0 dot product of a self-pair to +0: atan2(0, 0) = 0
  const float cs = rx * ax + ry * ay + rz * az + 0.f;
  return atan2f(sn, cs);
}

// query point, its KA neighbour offsets and |q|^2
template <int KA>
__device__ __forceinline__ void query_geometry(const float* pb, const float* knn, int n_pts,
                                               int b, int n, float& qx, float& qy, float& qz,
                                               float& q2, float* rx, float* ry, float* rz) {
  qx = pb[n * 3 + 0];
  qy = pb[n * 3 + 1];
  qz = pb[n * 3 + 2];
  q2 = qx * qx + qy * qy + qz * qz;
  const float* kb = knn + ((long long)b * n_pts + n) * KA * 3;
#pragma unroll
  for (int k = 0; k < KA; ++k) {
    rx[k] = kb[k * 3 + 0] - qx;
    ry[k] = kb[k * 3 + 1] - qy;
    rz[k] = kb[k * 3 + 2] - qz;
  }
}

}  // namespace se3et
