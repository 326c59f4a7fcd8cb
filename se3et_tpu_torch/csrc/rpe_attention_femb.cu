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
// of embedding bytes.  Design (tensor cores, bf16): the folded G sits in
// shared memory for the whole block (C x 64 bf16, transposed, row stride
// 72 so that the B fragments of a warp hit 32 banks).  Phase 1 of K5
// becomes, per query row and 32-key tile: each lane evaluates the geometry
// of one key and writes its 40 + 3 x 16 basis values (bf16) to the warp's
// slice of shared memory (32 keys x 104, 6.5 KB per warp: a row's 32-key
// tile is all a warp holds, where a whole 16 x 64 x 256 embedding tile
// would take 512 KB); then per 16 keys and 16 channels the distance
// projection (3 k-steps, the basis padded 40 -> 48 with zeros) and the
// three angle projections run on mma.sync into float32 accumulators, the
// angle max is taken elementwise, and the sum is repacked as bf16 into the
// A fragment of the positional product against qp (the accumulator layout
// of m16n8k16 is the A layout of the next product).  The embedding never
// leaves registers.  The float32 kernel evaluates the same per key on the
// CUDA cores, one lane per key.
#include "rpe_attention_core.cuh"
#include "embedding_common.cuh"

namespace {

using namespace se3et;

constexpr int kDD = 40;       // distance basis
constexpr int kDDPad = 48;    // ... padded to three k-steps of 16
constexpr int kDA = 16;       // angle basis
constexpr int kKA = 3;        // angle neighbours
constexpr int kDeg = kDDPad + kDA;  // rows of the folded G (distance, then angle)
constexpr int kGStride = kDeg + 8;  // bf16 per shared G column
constexpr int kBStride = kDDPad + kKA * kDA + 8;  // bf16 per shared basis row

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
}

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

// The positional term from coordinates: pts3 (B, N, 3), knn (B, N, 3, 3),
// gtab (64, C) float32 rows [Gd (40) | 0 (8) | Ga (16)] rounded to T, and
// its transpose gt (C, 64) in bf16 (the tensor-core path).
template <typename T>
struct EmbGeometry {
  const float* pts3;
  const float* knn;
  const float* gtab;
  const __nv_bfloat16* gt;
  float inv_d, inv_a;

  size_t smem_bytes(int cc) const {
    return ((size_t)cc * kGStride + (size_t)rpe::kTcWarps * rpe::kTcKeys * kBStride)
           * sizeof(__nv_bfloat16);
  }

  // G, transposed, into shared memory (16-byte copies)
  __device__ void init(char* smem, int cc) const {
    __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem);
    for (int i = threadIdx.x; i < cc * (kDeg / 8); i += blockDim.x) {
      const int c = i / (kDeg / 8);
      const int part = i - c * (kDeg / 8);
      *reinterpret_cast<uint4*>(sg + c * kGStride + 8 * part) =
          __ldg(reinterpret_cast<const uint4*>(gt + c * kDeg + 8 * part));
    }
  }

  template <int AH, int NT>
  __device__ __forceinline__ void tc_scores(int b, int n, int row, int key0, int cc,
                                            const __nv_bfloat16* qp, int warp, int lane,
                                            char* smem, float (&acc)[2][NT][4]) const {
    const int g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* sg = reinterpret_cast<const __nv_bfloat16*>(smem);
    __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem) + cc * kGStride
                        + warp * rpe::kTcKeys * kBStride;
    // 1. this lane's key: its distance and angle bases, bf16, into the
    //    warp's basis rows (zeros for keys past n)
    __syncwarp();  // the previous row's fragments are read
    {
      const int key = key0 + lane;
      __nv_bfloat16* mine = sb + lane * kBStride;
      if (key < n) {
        float dist, ang[kKA];
        pair_geometry(pts3 + (long long)b * n * 3, knn, n, b, row, key, dist, ang);
        cheb_basis<kDD>(dist, inv_d, mine);
#pragma unroll
        for (int k = 0; k < kKA; ++k) cheb_basis<kDA>(ang[k], inv_a, mine + kDDPad + kDA * k);
      } else {
#pragma unroll
        for (int j = 0; j < kDD; ++j) mine[j] = __float2bfloat16(0.f);
#pragma unroll
        for (int j = kDDPad; j < kDDPad + kKA * kDA; ++j) mine[j] = __float2bfloat16(0.f);
      }
#pragma unroll
      for (int j = kDD; j < kDDPad; ++j) mine[j] = __float2bfloat16(0.f);
    }
    __syncwarp();

    // 2. per 16 keys: the embedding of 16 channels at a time on the tensor
    //    cores, then its positional product with the AH folded queries
    const __nv_bfloat16* qprow = qp + ((long long)b * n + row) * AH * cc;
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      const __nv_bfloat16* r_lo = sb + (16 * mt + g) * kBStride + 2 * t;
      const __nv_bfloat16* r_hi = r_lo + 8 * kBStride;
      uint32_t ad[kDDPad / 16][4], aa[kKA][4];
#pragma unroll
      for (int s = 0; s < kDDPad / 16; ++s) {
        ad[s][0] = lds32(r_lo + 16 * s);
        ad[s][1] = lds32(r_hi + 16 * s);
        ad[s][2] = lds32(r_lo + 16 * s + 8);
        ad[s][3] = lds32(r_hi + 16 * s + 8);
      }
#pragma unroll
      for (int k = 0; k < kKA; ++k) {
        const int o = kDDPad + kDA * k;
        aa[k][0] = lds32(r_lo + o);
        aa[k][1] = lds32(r_hi + o);
        aa[k][2] = lds32(r_lo + o + 8);
        aa[k][3] = lds32(r_hi + o + 8);
      }
#pragma unroll 1
      for (int c0 = 0; c0 < cc; c0 += 16) {
        float e[2][4];
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const __nv_bfloat16* gcol = sg + (c0 + 8 * jn + g) * kGStride + 2 * t;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int s = 0; s < kDDPad / 16; ++s)
            mma_bf16(d, ad[s][0], ad[s][1], ad[s][2], ad[s][3], lds32(gcol + 16 * s),
                     lds32(gcol + 16 * s + 8));
          const uint32_t b0 = lds32(gcol + kDDPad), b1 = lds32(gcol + kDDPad + 8);
          float amax[4];
#pragma unroll
          for (int k = 0; k < kKA; ++k) {
            float cur[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(cur, aa[k][0], aa[k][1], aa[k][2], aa[k][3], b0, b1);
#pragma unroll
            for (int i = 0; i < 4; ++i) amax[i] = k == 0 ? cur[i] : fmaxf(amax[i], cur[i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) e[jn][i] = d[i] + Elem<__nv_bfloat16>::round(amax[i]);
        }
        // accumulator (keys x channels c0..c0+15) -> A fragment, rounded to bf16
        const uint32_t a0 = pack_bf16(e[0][0], e[0][1]), a1 = pack_bf16(e[0][2], e[0][3]);
        const uint32_t a2 = pack_bf16(e[1][0], e[1][1]), a3 = pack_bf16(e[1][2], e[1][3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int ah = 8 * nt + g;
          const __nv_bfloat16* qa = qprow + (long long)ah * cc + c0 + 2 * t;
          mma_bf16(acc[mt][nt], a0, a1, a2, a3, ldg32(qa, ah < AH), ldg32(qa + 8, ah < AH));
        }
      }
    }
  }

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

template <typename T>
int run(const void* q, const void* k, const void* v, const void* qp, const void* kmask,
        const void* qw, const void* pts, const void* pts3, const void* knn, const void* g,
        const void* gt, void* out, int batch, int ah, int n, int hc, int cc, int pts_rows,
        int deg_d, int deg_a, int ka, float scale, float inv_d, float inv_a, void* stream) {
  if (deg_d != kDD || deg_a != kDA || ka != kKA) return (int)cudaErrorInvalidValue;
  if (std::is_same<T, __nv_bfloat16>::value && gt == nullptr) return (int)cudaErrorInvalidValue;
  const EmbGeometry<T> pos{(const float*)pts3, (const float*)knn, (const float*)g,
                           (const __nv_bfloat16*)gt, inv_d, inv_a};
  return rpe::dispatch<T, EmbGeometry>(q, k, v, qp, kmask, qw, pts, out, nullptr, batch, ah, n,
                                       hc, cc, pts_rows, scale, pos, stream);
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

extern "C" int se3et_rpe_attention_femb_f32(
    const void* q, const void* k, const void* v, const void* qp, const void* kmask,
    const void* qw, const void* pts, const void* pts3, const void* knn, const void* g,
    const void* gt, void* out, int batch, int ah, int n, int hc, int cc, int pts_rows,
    int deg_d, int deg_a, int ka, float scale, float inv_d, float inv_a, void* stream) {
  return run<float>(q, k, v, qp, kmask, qw, pts, pts3, knn, g, gt, out, batch, ah, n, hc, cc,
                    pts_rows, deg_d, deg_a, ka, scale, inv_d, inv_a, stream);
}
