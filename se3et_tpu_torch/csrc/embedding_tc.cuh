// The geometric embedding's tile projection on the tensor cores, shared by
// K3 (geometric_embedding.cu, bf16 output) and its backward K10 (the angle
// argmax in bf16); K16's ws form (rpe_attention_femb_ws.cuh) writes its
// basis rows with key_basis and projects with fragments of its own.
// Roundings of the TPU kernel's bf16 chain
// (se3et_tpu/ops/pallas/embedding.py _cheb_project): the Chebyshev bases
// and the folded G in bf16, products summed in float32.
//
// Layouts: a warp holds the bases of its keys in shared basis rows of
// kBStride bf16, [distance (40, zero-padded to 48) | KA angles x 16 | pad];
// G sits in shared memory transposed, one row of kGStride bf16 per channel,
// [Gd (40) | 0 (8) | Ga (16) | pad] (stride 72: the B fragments of a warp
// hit 32 banks).  Per 16 keys and 8 channels the distance projection is 3
// m16n8k16 k-steps and each angle projection one.
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "embedding_common.cuh"

namespace se3et {
namespace emb {

constexpr int kDD = 40;                           // distance basis
constexpr int kDDPad = 48;                        // ... padded to three k-steps of 16
constexpr int kDA = 16;                           // angle basis
constexpr int kKA = 3;                            // angle neighbours
constexpr int kDeg = kDDPad + kDA;                // rows of the folded G
constexpr int kGStride = kDeg + 8;                // bf16 per shared G column
constexpr int kBStride = kDDPad + kKA * kDA + 8;  // bf16 per shared basis row

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// cheb_basis in bf16, two terms per 4-byte store (the same recurrence,
// the same values)
template <int DEG>
__device__ __forceinline__ void cheb_basis_bf16(float x, float inv, __nv_bfloat16* dst) {
  static_assert(DEG % 2 == 0, "pairs of terms");
  const float t = fminf(fmaxf(x * inv - 1.f, -1.f), 1.f);
  float prev = 1.f, cur = t;
  const float two_t = 2.f * t;
#pragma unroll
  for (int k = 0; k < DEG; k += 2) {
    *reinterpret_cast<__nv_bfloat162*>(dst + k) = __floats2bfloat162_rn(prev, cur);
    const float nxt = two_t * cur - prev;
    prev = cur;
    cur = nxt;
    const float nxt2 = two_t * cur - prev;
    prev = cur;
    cur = nxt2;
  }
}

// one key's bases, bf16, into its basis row (4-byte aligned)
__device__ __forceinline__ void key_basis(float dist, const float* ang, float inv_d,
                                          float inv_a, __nv_bfloat16* row) {
  cheb_basis_bf16<kDD>(dist, inv_d, row);
#pragma unroll
  for (int k = 0; k < kKA; ++k) cheb_basis_bf16<kDA>(ang[k], inv_a, row + kDDPad + kDA * k);
#pragma unroll
  for (int j = kDD; j < kDDPad; j += 2)
    *reinterpret_cast<__nv_bfloat162*>(row + j) = __floats2bfloat162_rn(0.f, 0.f);
}

// zeros for a key past the end
__device__ __forceinline__ void zero_basis(__nv_bfloat16* row) {
#pragma unroll
  for (int j = 0; j < kDDPad + kKA * kDA; j += 2)
    *reinterpret_cast<__nv_bfloat162*>(row + j) = __floats2bfloat162_rn(0.f, 0.f);
}

// A fragments of the bases of 16 keys (basis rows key0 .. key0 + 15)
struct BasisFrag {
  uint32_t d[kDDPad / 16][4];
  uint32_t a[kKA][4];
};

__device__ __forceinline__ void load_basis(const __nv_bfloat16* sb, int key0, int lane,
                                           BasisFrag& f) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* r_lo = sb + (key0 + g) * kBStride + 2 * t;
  const __nv_bfloat16* r_hi = r_lo + 8 * kBStride;
#pragma unroll
  for (int s = 0; s < kDDPad / 16; ++s) {
    f.d[s][0] = lds32(r_lo + 16 * s);
    f.d[s][1] = lds32(r_hi + 16 * s);
    f.d[s][2] = lds32(r_lo + 16 * s + 8);
    f.d[s][3] = lds32(r_hi + 16 * s + 8);
  }
#pragma unroll
  for (int k = 0; k < kKA; ++k) {
    const int o = kDDPad + kDA * k;
    f.a[k][0] = lds32(r_lo + o);
    f.a[k][1] = lds32(r_hi + o);
    f.a[k][2] = lds32(r_lo + o + 8);
    f.a[k][3] = lds32(r_hi + o + 8);
  }
}

// 16 keys x 8 channels: the distance projection d and the angle max amax,
// float32 accumulators (keys g / g + 8, channels 2t, 2t + 1 of the eight);
// gcol is the G row of this lane's channel, offset by 2t
__device__ __forceinline__ void project(const BasisFrag& f, const __nv_bfloat16* gcol,
                                        float (&d)[4], float (&amax)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kDDPad / 16; ++s)
    mma_bf16(d, f.d[s][0], f.d[s][1], f.d[s][2], f.d[s][3], lds32(gcol + 16 * s),
             lds32(gcol + 16 * s + 8));
  const uint32_t b0 = lds32(gcol + kDDPad), b1 = lds32(gcol + kDDPad + 8);
#pragma unroll
  for (int k = 0; k < kKA; ++k) {
    float cur[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(cur, f.a[k][0], f.a[k][1], f.a[k][2], f.a[k][3], b0, b1);
#pragma unroll
    for (int i = 0; i < 4; ++i) amax[i] = k == 0 ? cur[i] : fmaxf(amax[i], cur[i]);
  }
}

// the KA angle projections alone, each as project() computes it
__device__ __forceinline__ void angle_project(const BasisFrag& f, const __nv_bfloat16* gcol,
                                              float (&a)[kKA][4]) {
  const uint32_t b0 = lds32(gcol + kDDPad), b1 = lds32(gcol + kDDPad + 8);
#pragma unroll
  for (int k = 0; k < kKA; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[k][i] = 0.f;
    mma_bf16(a[k], f.a[k][0], f.a[k][1], f.a[k][2], f.a[k][3], b0, b1);
  }
}

// G (C x kDeg bf16, transposed) into shared rows of kGStride (16-byte copies)
__device__ __forceinline__ void load_g(__nv_bfloat16* sg, const __nv_bfloat16* gt, int cc) {
  for (int i = threadIdx.x; i < cc * (kDeg / 8); i += blockDim.x) {
    const int c = i / (kDeg / 8);
    const int part = i - c * (kDeg / 8);
    *reinterpret_cast<uint4*>(sg + c * kGStride + 8 * part) =
        __ldg(reinterpret_cast<const uint4*>(gt + c * kDeg + 8 * part));
  }
}

}  // namespace emb
}  // namespace se3et
