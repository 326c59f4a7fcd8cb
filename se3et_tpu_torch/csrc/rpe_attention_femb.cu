// Flash RPE self-attention with the geometric embedding recomputed in the
// kernel (K16).
//
// Same function as the TPU kernel se3et_tpu/ops/pallas/rpe_attention.py
// rpe_self_attention_femb: K5's attention (rpe_attention_core.cuh, the
// same kernels) with each embedding row built on chip from coordinates,
//   emb[b,n,m,:] = T_d(dist(n,m)) @ Gd + max_k T_a(angle_k(n,m)) @ Ga
// (K3's function without its biases, which are softmax no-ops), so the
// (B, N, N, C) tensor never exists.  dist and the angles are 0 where
// n == m, by index, as on the TPU; elsewhere they are K3's arithmetic
// (embedding_common.cuh).  G = A @ W, the Chebyshev fit folded into the
// projection, comes from the wrapper, rounded to the kernel's element type.
// Roundings in bf16, as in the TPU kernel: basis and G in bf16 with float32
// accumulation, the angle max rounded to bf16, the tile rounded to bf16
// before the positional product.  In float32 nothing is rounded.
//
// Bound: operations.  Per pair (40 + 3 x 16) x C projection MACs, AH x C
// positional and 2 x AH x HC content/value MACs: ~0.13 ms at AH = 24 at
// the bf16 tensor-core peak for B=2, N=1024, C=256, against K5's 0.32 ms
// of embedding bytes.
//
// Two forms, chosen by shape (the wrapper's rpe_attention_form mirrors the
// choice):
// * "ws" (bf16, head width 64 or 32, C % 32 == 0, AH 4 or 24: the serving
//   path): rpe_attention_femb_ws.cuh.  Positional warps build each 32-key
//   tile of a query row's embedding on the tensor cores from basis rows in
//   shared memory and the block's resident G, and contract it at once with
//   the row's folded queries, while K5's flash warps run the softmax and
//   p.v of the previous key tile (at head width 32 they also form the pair
//   geometry two tiles ahead);
// * "cuda" (float32 and head width 16): rpe_attention_core.cuh's CUDA-core
//   kernel with the policy EmbGeometry below; each lane evaluates the same
//   per key and contracts it against the AH folded queries held in shared
//   memory as float32.  se3et_rpe_attention_femb_cuda_bf16 takes it at the
//   ws shapes too, for tests and timings.
#include "rpe_attention_femb_ws.cuh"

namespace {

using namespace se3et;

using emb::kDA;
using emb::kDD;
using emb::kDDPad;
using emb::kKA;

// distance and angles of the pair (row, m); 0 on the diagonal, by index
__device__ __forceinline__ void pair_geometry(const float* pb3, const float* knn, int n, int b,
                                              int row, int m, float& dist, float* ang) {
  float qx, qy, qz, q2, rx[kKA], ry[kKA], rz[kKA];
  query_geometry<kKA>(pb3, knn, n, b, row, qx, qy, qz, q2, rx, ry, rz);
  const float px = pb3[m * 3 + 0], py = pb3[m * 3 + 1], pz = pb3[m * 3 + 2];
  const bool self = m == row;
  dist = self ? 0.f : pair_distance(qx, qy, qz, q2, px, py, pz);
#pragma unroll
  for (int k = 0; k < kKA; ++k)
    ang[k] = self ? 0.f : pair_angle(rx[k], ry[k], rz[k], px - qx, py - qy, pz - qz);
}

// The positional term of the CUDA-core kernel from coordinates: pts3 (B, N,
// 3), knn (B, N, 3, 3), gtab (64, C) float32 rows [Gd (40) | 0 (8) | Ga (16)]
// rounded to T.
template <typename T>
struct EmbGeometry {
  const float* pts3;
  const float* knn;
  const float* gtab;
  float inv_d, inv_a;

  template <typename TT, int AH>
  __device__ __forceinline__ void lane_scores(int b, int n, int row, int m, int cc,
                                              const float* my_qp, float (&s)[AH]) const {
    float dist, ang[kKA], td[kDD], ta[kKA][kDA];
    pair_geometry(pts3 + (long long)b * n * 3, knn, n, b, row, m, dist, ang);
    cheb_basis<kDD>(dist, inv_d, td);
#pragma unroll
    for (int j = 0; j < kDD; ++j) td[j] = Elem<TT>::round(td[j]);
#pragma unroll
    for (int k = 0; k < kKA; ++k) {
      cheb_basis<kDA>(ang[k], inv_a, ta[k]);
#pragma unroll
      for (int j = 0; j < kDA; ++j) ta[k][j] = Elem<TT>::round(ta[k][j]);
    }
    for (int c0 = 0; c0 < cc; c0 += 8) {
      float e[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float* gc = gtab + c0 + jj;
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < kDD; ++j) d = fmaf(td[j], __ldg(gc + j * cc), d);
        float amax = __int_as_float(0xff800000);
#pragma unroll
        for (int k = 0; k < kKA; ++k) {
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < kDA; ++j) a = fmaf(ta[k][j], __ldg(gc + (kDDPad + j) * cc), a);
          amax = fmaxf(amax, a);
        }
        e[jj] = Elem<TT>::round(d + Elem<TT>::round(amax));
      }
      rpe::qp_dot8<AH>(my_qp, cc, c0, e, s);
    }
  }
};

// the form the shape takes, or with `first` the CUDA-core form at any shape
template <typename T>
int run(const void* q, const void* k, const void* v, const void* qp, const void* kmask,
        const void* qw, const void* pts, const void* pts3, const void* knn, const void* g,
        const void* gt, void* out, int batch, int ah, int n, int hc, int cc, int pts_rows,
        int deg_d, int deg_a, int ka, float scale, float inv_d, float inv_a, void* stream,
        bool first = false) {
  if (deg_d != kDD || deg_a != kDA || ka != kKA) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t ws = femb_ws::smem_bytes(ah, hc, cc);
  if (std::is_same<T, __nv_bfloat16>::value && !first && ws != 0
      && ws <= (size_t)rpe_ws::kMaxSmem) {
    if (gt == nullptr) return (int)cudaErrorInvalidValue;
    return femb_ws::dispatch(q, k, v, qp, kmask, qw, pts3, knn, gt, out, batch, ah, n, hc, cc,
                             scale, inv_d, inv_a, s);
  }
  const EmbGeometry<T> pos{(const float*)pts3, (const float*)knn, (const float*)g, inv_d,
                           inv_a};
  return rpe::dispatch_cuda<T>(q, k, v, qp, kmask, qw, pts, out, nullptr, batch, ah, n, hc,
                               cc, pts_rows, scale, pos, s);
}

}  // namespace

extern "C" int se3et_rpe_attention_femb_bf16(
    const void* q, const void* k, const void* v, const void* qp, const void* kmask,
    const void* qw, const void* pts, const void* pts3, const void* knn, const void* g,
    const void* gt, void* out, int batch, int ah, int n, int hc, int cc, int pts_rows,
    int deg_d, int deg_a, int ka, float scale, float inv_d, float inv_a, void* stream) {
  return run<__nv_bfloat16>(q, k, v, qp, kmask, qw, pts, pts3, knn, g, gt, out, batch, ah, n,
                            hc, cc, pts_rows, deg_d, deg_a, ka, scale, inv_d, inv_a, stream);
}

// the CUDA-core first design in bf16 at any shape, the ws shapes too (for
// tests and timings; the serving path never reaches it)
extern "C" int se3et_rpe_attention_femb_cuda_bf16(
    const void* q, const void* k, const void* v, const void* qp, const void* kmask,
    const void* qw, const void* pts, const void* pts3, const void* knn, const void* g,
    const void* gt, void* out, int batch, int ah, int n, int hc, int cc, int pts_rows,
    int deg_d, int deg_a, int ka, float scale, float inv_d, float inv_a, void* stream) {
  return run<__nv_bfloat16>(q, k, v, qp, kmask, qw, pts, pts3, knn, g, gt, out, batch, ah, n,
                            hc, cc, pts_rows, deg_d, deg_a, ka, scale, inv_d, inv_a, stream,
                            true);
}

extern "C" int se3et_rpe_attention_femb_f32(
    const void* q, const void* k, const void* v, const void* qp, const void* kmask,
    const void* qw, const void* pts, const void* pts3, const void* knn, const void* g,
    const void* gt, void* out, int batch, int ah, int n, int hc, int cc, int pts_rows,
    int deg_d, int deg_a, int ka, float scale, float inv_d, float inv_a, void* stream) {
  return run<float>(q, k, v, qp, kmask, qw, pts, pts3, knn, g, gt, out, batch, ah, n, hc, cc,
                    pts_rows, deg_d, deg_a, ka, scale, inv_d, inv_a, stream);
}

// the shared memory of the ws form at (ah, hc, cc), 0 where it is not built
// (the wrapper's rpe_attention.femb_ws_smem_bytes is held against it)
extern "C" long long se3et_rpe_attention_femb_ws_smem(int ah, int hc, int cc) {
  return (long long)se3et::femb_ws::smem_bytes(ah, hc, cc);
}
