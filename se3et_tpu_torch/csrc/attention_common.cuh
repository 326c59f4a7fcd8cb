// Device helpers shared by the attention kernels (rpe_attention.cu,
// eq_attention.cu): warp reductions, element loads as float32, and the
// bf16 tensor-core fragments of mma.sync.m16n8k16.
//
// Fragment layout (lane = 4 g + t): an A tile (16 x 16, row-major) sits in
// four registers, rows g / g+8 and k-slots 2t+{0,1} / 2t+8+{0,1}; a B tile
// (16 x 8) in two, k-slots 2t+{0,1} / 2t+8+{0,1} of column g; the float32
// accumulator (16 x 8) in four, row g columns 2t+{0,1} and row g+8 the same.
// Q and K fragments are read 16 bytes at a time: the contraction index c is
// given to the k-slots in one fixed permutation for both operands (slot
// 2t+i of k-step 2p <-> c = 32p+8t+i, slot 2t+8+i <-> c = 32p+8t+2+i, and
// k-step 2p+1 takes c + 4), which leaves every product unchanged.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace se3et {

constexpr float kNeg = -1e9f;  // score of a masked key, as on the TPU

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

// reductions over the four lanes (t = 0..3) that share an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void unpack_bf16x8(uint4 u, float* o) {
  o[0] = __uint_as_float(u.x << 16);
  o[1] = __uint_as_float(u.x & 0xffff0000u);
  o[2] = __uint_as_float(u.y << 16);
  o[3] = __uint_as_float(u.y & 0xffff0000u);
  o[4] = __uint_as_float(u.z << 16);
  o[5] = __uint_as_float(u.z & 0xffff0000u);
  o[6] = __uint_as_float(u.w << 16);
  o[7] = __uint_as_float(u.w & 0xffff0000u);
}

// 8 consecutive elements (16-byte aligned for bf16, 32-byte for float) as
// float32: load8 through the read-only path, stream8 with evict-first; two
// consecutive elements as a float2; round() to the element type.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static void load8(const float* p, float* o) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
  __device__ static void stream8(const float* p, float* o) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
  __device__ static float2 load2(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ static float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static void load8(const __nv_bfloat16* p, float* o) {
    unpack_bf16x8(__ldg(reinterpret_cast<const uint4*>(p)), o);
  }
  __device__ static void stream8(const __nv_bfloat16* p, float* o) {
    unpack_bf16x8(__ldcs(reinterpret_cast<const uint4*>(p)), o);
  }
  __device__ static float2 load2(const __nv_bfloat16* p) {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// one A/B k-step pair (two mma) from 16-byte loads: a_lo / a_hi hold rows
// g / g+8, b column g, in the permuted c order above
__device__ __forceinline__ void mma_bf16_x2(float* d, uint4 a_lo, uint4 a_hi, uint4 b) {
  mma_bf16(d, a_lo.x, a_hi.x, a_lo.y, a_hi.y, b.x, b.y);
  mma_bf16(d, a_lo.z, a_hi.z, a_lo.w, a_hi.w, b.z, b.w);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
}

// Q fragments of one head (rows of HC bf16) for rows ra, rb (= ra + 8).
template <int HC>
__device__ __forceinline__ void load_q(const __nv_bfloat16* qh, int n, int ra, int rb,
                                       int t, uint4 (&qf)[HC / 32][2]) {
#pragma unroll
  for (int p = 0; p < HC / 32; ++p) {
    qf[p][0] = ld16(qh + (long long)ra * HC + 32 * p + 8 * t, ra < n);
    qf[p][1] = ld16(qh + (long long)rb * HC + 32 * p + 8 * t, rb < n);
  }
}

// s[j] = q . k (unscaled) for 16 query rows and keys key0 + 8j + (0..7),
// j < NT; keys at or past mlen read as zero.
template <int HC, int NT>
__device__ __forceinline__ void qk_tile(const uint4 (&qf)[HC / 32][2],
                                        const __nv_bfloat16* kh, int mlen, int key0, int g,
                                        int t, float (&s)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const int key = key0 + 8 * j + g;
#pragma unroll
    for (int p = 0; p < HC / 32; ++p)
      mma_bf16_x2(s[j], qf[p][0], qf[p][1],
                  ld16(kh + (long long)key * HC + 32 * p + 8 * t, key < mlen));
  }
}

// qk_tile from a K tile staged in shared memory (NT*8 keys x HC, row
// stride `stride` bf16, 16-byte aligned rows)
template <int HC, int NT>
__device__ __forceinline__ void qk_tile_smem(const uint4 (&qf)[HC / 32][2],
                                             const __nv_bfloat16* ks, int stride, int g,
                                             int t, float (&s)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* row = ks + (8 * j + g) * stride + 8 * t;
#pragma unroll
    for (int p = 0; p < HC / 32; ++p)
      mma_bf16_x2(s[j], qf[p][0], qf[p][1],
                  *reinterpret_cast<const uint4*>(row + 32 * p));
  }
}

// o[jn] += P . V for a 16-row probability tile of NK keys (s[j] from
// qk_tile, already exponentiated and masked) and a staged V tile vs
// (NK keys x HC values, row stride `stride` bf16, 16-byte aligned rows).
template <int HC, int NK>
__device__ __forceinline__ void pv_tile(const float (&s)[NK / 8][4],
                                        const __nv_bfloat16* vs, int stride, int lane,
                                        float (&o)[HC / 8][4]) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const uint32_t p0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    const uint32_t p1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    const uint32_t p2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    const uint32_t p3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const int vrow = 16 * kk + (mi & 1) * 8 + (lane & 7);
#pragma unroll
    for (int jn = 0; jn < HC / 8; jn += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + vrow * stride + 8 * (jn + (mi >> 1)));
      mma_bf16(o[jn], p0, p1, p2, p3, b[0], b[1]);
      mma_bf16(o[jn + 1], p0, p1, p2, p3, b[2], b[3]);
    }
  }
}

// copy an NK-key tile of rows of HC bf16 into shared memory (row stride
// `stride`), zero past mlen; thread `tid` of `nthreads` cooperating
template <int HC, int NK>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* src, int mlen, int key0,
                                           __nv_bfloat16* dst, int stride, int tid,
                                           int nthreads) {
  for (int idx = tid; idx < NK * HC / 8; idx += nthreads) {
    const int row = idx / (HC / 8);
    const int col = (idx - row * (HC / 8)) * 8;
    const int key = key0 + row;
    *reinterpret_cast<uint4*>(dst + row * stride + col) =
        ld16(src + (long long)key * HC + col, key < mlen);
  }
}

// cp.async: 16-byte global -> shared copies that complete in the
// background (zero-filled when !ok), committed and waited for in groups
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// stage_rows with cp.async (rows past mlen zero-filled)
template <int HC, int NK>
__device__ __forceinline__ void stage_rows_async(const __nv_bfloat16* src, int mlen,
                                                 int key0, __nv_bfloat16* dst, int stride,
                                                 int tid, int nthreads) {
  for (int idx = tid; idx < NK * HC / 8; idx += nthreads) {
    const int row = idx / (HC / 8);
    const int col = (idx - row * (HC / 8)) * 8;
    const int key = key0 + row;
    const bool ok = key < mlen;
    cp_async16(dst + row * stride + col, src + (ok ? (long long)key * HC + col : 0), ok);
  }
}

}  // namespace se3et
