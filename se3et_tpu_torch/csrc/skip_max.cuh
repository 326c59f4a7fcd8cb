// The strided skip's max over a query row's neighbour rows, one warp per
// row at a time (K13's tensor-core form; written so that K2 and K14 can
// take it):
//
//   pooled[r, :] = max_h (nbr[r, h] valid ? x2[nbr[r, h], :] : 0)
//
// A warp owns `count` query rows of its block (local rows first + stride *
// i, their index rows in shared memory) and walks them in order.  Lane l
// keeps the maxima of a row's 16-byte payload units l, l + 32, .. (at most
// SU of them) as packed bf16 pairs; a sentinel slot costs no load, and a
// row with any sentinel starts its max at the zero row instead of -inf,
// once.  The max of bf16 values is exact in any order, so the result
// equals K2's and the plain version's (their max over h in order, the
// sentinels' zeros in place) value for value.
//
// direct() loads up to NB valid neighbour rows of a row at once straight
// into registers, then takes their max.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace se3et {

// the elementwise max of two packed bf16 pairs (a NaN loses, as in fmaxf)
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <int SU>
struct SkipMax {
  const __nv_bfloat16* x2;  // (B, ns, ac2)
  __nv_bfloat16* pooled;    // (B * nq, ac2), flattened rows
  const int* s_nbr;         // the block's index rows [rows][h], sentinel ns
  int ns, nq, h, ac2;
  int r0, nrows;            // the block's first flattened row, its live rows
  int first, stride, count;
  int lane;

  // every row in turn: each lane's units of up to NB valid neighbour rows
  // loaded (16 bytes each) into registers before their max
  template <int NB>
  __device__ __forceinline__ void direct() const {
    constexpr uint32_t kNegInf = 0xff80ff80u;
    const int units = ac2 >> 3;
    for (int i = 0; i < count; ++i) {
      const int r = first + stride * i;
      const int j = lane < h ? s_nbr[r * h + lane] : ns;
      uint32_t mask = __ballot_sync(0xffffffffu, j >= 0 && j < ns);  // the valid slots
      const uint32_t seed = __popc(mask) < h ? 0u : kNegInf;  // the zero row, or -inf
      uint32_t cur[SU][4];
#pragma unroll
      for (int u = 0; u < SU; ++u) cur[u][0] = cur[u][1] = cur[u][2] = cur[u][3] = seed;
      const __nv_bfloat16* base = x2 + (long long)(r0 + r) / nq * ns * ac2;
      while (mask) {
        uint4 v[NB][SU];
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const bool ok = mask != 0;
          const int hh = ok ? __ffs(mask) - 1 : 0;
          mask &= mask - 1;
          const uint4* row = reinterpret_cast<const uint4*>(base + (long long)s_nbr[r * h + hh] * ac2);
#pragma unroll
          for (int u = 0; u < SU; ++u)
            v[n][u] = ok && lane + 32 * u < units
                          ? __ldg(row + lane + 32 * u)
                          : make_uint4(kNegInf, kNegInf, kNegInf, kNegInf);
        }
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int u = 0; u < SU; ++u) {
            cur[u][0] = max_bf16x2(cur[u][0], v[n][u].x);
            cur[u][1] = max_bf16x2(cur[u][1], v[n][u].y);
            cur[u][2] = max_bf16x2(cur[u][2], v[n][u].z);
            cur[u][3] = max_bf16x2(cur[u][3], v[n][u].w);
          }
      }
      if (r < nrows) {
        uint4* dst = reinterpret_cast<uint4*>(pooled + (long long)(r0 + r) * ac2);
#pragma unroll
        for (int u = 0; u < SU; ++u)
          if (lane + 32 * u < units)
            dst[lane + 32 * u] = make_uint4(cur[u][0], cur[u][1], cur[u][2], cur[u][3]);
      }
    }
  }
};

}  // namespace se3et
