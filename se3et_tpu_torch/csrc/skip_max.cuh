// The strided skip's max over a query row's neighbour rows, taken by one
// warp over a slice of the row (K2's rows form, a slice per warp; K13's
// tensor-core form, whole rows; K14 can take it):
//
//   out[r, :] = max_h (nbr[r, h] valid ? x[nbr[r, h], :] : 0)
//
// Rows are whole 16-byte units (8 bf16 or 4 float32 values).  Lane l keeps
// the maxima of the slice's units u0 + l, u0 + l + 32, .. (SU of them, those
// past the row's end idle) as 32-bit words: packed bf16 pairs (max.bf16x2)
// or floats (fmaxf).  The slots are taken 32 at a time, a ballot per word,
// so H has no limit; a sentinel slot (an index outside [0, ns)) costs no
// load, and a row with any sentinel starts its max at the zero row instead
// of -inf, once, from the count of valid slots over the whole row.  Up to
// NB valid neighbour rows are loaded (16 bytes a unit) straight into
// registers before their max, each row's index read from idx (K13's index
// rows in shared memory, K2's in global memory); taking it by a shuffle of
// the word's indices instead ran K13's skip at half the rate (PERF.md).
// The max is exact and the card orders +0 above -0 (PTX max), so the
// result does not depend on the order of the slots: it equals K2's first
// design and the plain version's (their max over h in order, the
// sentinels' zeros in place) bit for bit, wherever the plain version's own
// choice between -0 and +0 does not depend on its order.
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

// the max of the 32-bit words of a 16-byte unit of T, and their -inf
template <typename T>
struct UnitMax;

template <>
struct UnitMax<__nv_bfloat16> {
  static constexpr uint32_t kNegInf = 0xff80ff80u;
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    return max_bf16x2(a, b);
  }
};

template <>
struct UnitMax<float> {
  static constexpr uint32_t kNegInf = 0xff800000u;
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  }
};

__device__ __forceinline__ bool valid_slot(int j, int ns) { return j >= 0 && j < ns; }

// dst[u] = the max over the valid rows among idx[0, h) of rows[idx][u], for
// the units u of [u0, u0 + 32 SU) that lie below `units` (the row's width);
// rows and dst in 16-byte units, idx in shared or global memory.  Every lane
// of the warp calls it with the same arguments but `lane`; `store` false
// computes without writing.
template <typename T, int SU, int NB>
__device__ __forceinline__ void skip_row_max(const uint4* __restrict__ rows,
                                             const int* __restrict__ idx, int h, int ns,
                                             int units, int u0, uint4* __restrict__ dst,
                                             bool store, int lane) {
  using M = UnitMax<T>;
  constexpr uint32_t kNegInf = M::kNegInf;
  uint32_t mask = __ballot_sync(0xffffffffu, valid_slot(lane < h ? idx[lane] : ns, ns));
  int nvalid = __popc(mask);  // the valid slots of the row; mask: of the current word
  for (int w = 32; w < h; w += 32)
    nvalid += __popc(
        __ballot_sync(0xffffffffu, valid_slot(w + lane < h ? idx[w + lane] : ns, ns)));
  const uint32_t seed = nvalid < h ? 0u : kNegInf;  // the zero row, or -inf
  uint32_t cur[SU][4];
#pragma unroll
  for (int u = 0; u < SU; ++u) cur[u][0] = cur[u][1] = cur[u][2] = cur[u][3] = seed;
  const int mine = u0 + lane;  // this lane's first unit
  for (int w = 0;;) {
    while (mask) {
      uint4 v[NB][SU];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const bool ok = mask != 0;
        const int hh = ok ? w + __ffs(mask) - 1 : 0;
        mask &= mask - 1;
        const uint4* row = rows + (long long)idx[hh] * units + mine;
#pragma unroll
        for (int u = 0; u < SU; ++u)
          v[n][u] = ok && mine + 32 * u < units ? __ldg(row + 32 * u)
                                                : make_uint4(kNegInf, kNegInf, kNegInf, kNegInf);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          cur[u][0] = M::max(cur[u][0], v[n][u].x);
          cur[u][1] = M::max(cur[u][1], v[n][u].y);
          cur[u][2] = M::max(cur[u][2], v[n][u].z);
          cur[u][3] = M::max(cur[u][3], v[n][u].w);
        }
    }
    w += 32;
    if (w >= h) break;
    mask = __ballot_sync(0xffffffffu, valid_slot(w + lane < h ? idx[w + lane] : ns, ns));
  }
  if (store) {
#pragma unroll
    for (int u = 0; u < SU; ++u)
      if (mine + 32 * u < units)
        dst[mine + 32 * u] = make_uint4(cur[u][0], cur[u][1], cur[u][2], cur[u][3]);
  }
}

}  // namespace se3et
