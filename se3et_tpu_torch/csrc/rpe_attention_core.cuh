// The CUDA-core flash RPE self-attention kernel of K5 (rpe_attention.cu: the
// positional term read from a materialised embedding) and K16
// (rpe_attention_femb.cu: the embedding recomputed from coordinates), the
// form both take in float32 and at the other widths.  Their bf16 serving
// forms are warp-specialised kernels of their own: K5's
// rpe_attention_ws.cuh, K16's rpe_attention_femb_ws.cuh.
//
//   s[b,ah,n,m] = scale * (q[b,ah,n].k[b,ah,m] + qp[b,n,ah].emb[b,n,m]
//                          + rinv(n,m) * (qw_y dy + qw_z dz + qw_x dx))
//   out[b,ah,n] = sum_m softmax_m(s) v[b,ah,m]        (float32 out)
// with d = p_n - p_m, rinv = sqrt(3/4pi) / (|d| + 1e-12) and rinv = 0 where
// n == m (by index).  Keys with k_mask == 0 get s = -1e9 before the exp and
// p = 0; p is rounded to v's type before p.v, as on the TPU.
//
// The kernel is a template over a positional-term policy `Pos`, which
// supplies the qp.emb contraction and nothing else; the content term, the
// SH term, the online softmax, p.v and the epilogue are this file's, so
// K5 and K16 share them.  A policy provides
//   lane_scores<T, AH>(b, n, row, m, cc, my_qp, s)
//       s[a] += qp[b,row,a] . emb[b,row,m] for one key on the CUDA cores.
//
// rpe_attention_kernel: one block owns kWarps query rows and all AH, one
// warp per query row, one lane per key of a 32-key tile; the AH folded
// queries of a row sit in shared memory as float32 (kWarps*AH*C*4 = 192 KB
// at AH=24, C=256).  An online softmax per (row, ah) with no cross-block
// state and no atomics.  Where lse is not null, it also writes the row
// log-sum-exp lse[b,ah,n] = max + log(sum) of the scaled, masked scores.
#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace se3et {
namespace rpe {

constexpr int kWarps = 8;  // query rows per block
constexpr int kThreads = kWarps * 32;
constexpr float kSh1 = 0.48860251190291992f;  // sqrt(3 / (4 pi))

// s[a] += my_qp[a, c0..c0+8) . e[0..8) for the AH folded queries of a row
// (float32, shared memory): the CUDA-core positional contraction of one
// key's embedding channels, for every lane_scores
template <int AH>
__device__ __forceinline__ void qp_dot8(const float* my_qp, int cc, int c0, const float (&e)[8],
                                        float (&s)[AH]) {
#pragma unroll
  for (int a = 0; a < AH; ++a) {
    const float4 w0 = *reinterpret_cast<const float4*>(my_qp + a * cc + c0);
    const float4 w1 = *reinterpret_cast<const float4*>(my_qp + a * cc + c0 + 4);
    float t = s[a];
    t = fmaf(w0.x, e[0], t);
    t = fmaf(w0.y, e[1], t);
    t = fmaf(w0.z, e[2], t);
    t = fmaf(w0.w, e[3], t);
    t = fmaf(w1.x, e[4], t);
    t = fmaf(w1.y, e[5], t);
    t = fmaf(w1.z, e[6], t);
    t = fmaf(w1.w, e[7], t);
    s[a] = t;
  }
}

// q, k, v (B, AH, N, HC); qp (B, N, AH, C); kmask (B, N); qw (B, 3, AH, N)
// f32 rows (y, z, x) or null; pts (B, pts_rows, N) f32 rows (x, y, z[, pad]);
// out (B, AH, N, HC) f32.
template <typename T, int AH, int HC, class Pos>
__global__ void __launch_bounds__(kThreads, 1)
rpe_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ qp,
                     const uint8_t* __restrict__ kmask, const float* __restrict__ qw,
                     const float* __restrict__ pts, float* __restrict__ out,
                     float* __restrict__ lse, int n, int cc, int pts_rows, float scale,
                     const Pos pos) {
  extern __shared__ float smem[];
  float* qp_s = smem;                      // [kWarps][AH][cc]
  float* p_s = qp_s + kWarps * AH * cc;    // [kWarps][AH][32]

  const int nblk = (n + kWarps - 1) / kWarps;
  const int b = blockIdx.x / nblk;
  const int row0 = (blockIdx.x - b * nblk) * kWarps;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the block's folded positional queries, as float32
  const int rows = min(kWarps, n - row0);
  const T* qp_blk = qp + ((long long)b * n + row0) * AH * cc;
  for (int i = threadIdx.x * 8; i < rows * AH * cc; i += kThreads * 8) {
    float t[8];
    Elem<T>::load8(qp_blk + i, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) qp_s[i + j] = t[j];
  }
  __syncthreads();
  const int row = row0 + warp;
  if (row >= n) return;

  const float* my_qp = qp_s + warp * AH * cc;
  float* my_p = p_s + warp * AH * 32;
  const uint8_t* km = kmask + (long long)b * n;
  const bool with_sh = qw != nullptr;
  const float* pb = with_sh ? pts + (long long)b * pts_rows * n : nullptr;
  const float* qwb = with_sh ? qw + (long long)b * 3 * AH * n : nullptr;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (with_sh) {
    px = pb[row];
    py = pb[n + row];
    pz = pb[2 * n + row];
  }
  // value columns are taken two per lane: at head width 16 and 32 the lanes
  // from HC / 2 on hold no pair and write nothing
  constexpr int kPairs = HC / 2;
  static_assert(HC % 8 == 0 && kPairs <= 32, "head width: a multiple of 8, at most 64");
  const bool pv_lane = lane < kPairs;

  float mrun[AH], lrun[AH], acc[AH][2];
#pragma unroll
  for (int a = 0; a < AH; ++a) {
    mrun[a] = __int_as_float(0xff800000);  // -inf
    lrun[a] = 0.f;
    acc[a][0] = acc[a][1] = 0.f;
  }

  for (int m0 = 0; m0 < n; m0 += 32) {
    const int m = m0 + lane;
    const bool in_range = m < n;
    const bool valid = in_range && km[m] != 0;
    float s[AH];
#pragma unroll
    for (int a = 0; a < AH; ++a) s[a] = 0.f;
    if (in_range) {
      // positional term
      pos.template lane_scores<T, AH>(b, n, row, m, cc, my_qp, s);
      // content term q[row] . k[m]
#pragma unroll
      for (int a = 0; a < AH; ++a) {
        const T* kr = k + ((long long)(b * AH + a) * n + m) * HC;
        const T* qr = q + ((long long)(b * AH + a) * n + row) * HC;
        float t = 0.f;
#pragma unroll
        for (int c0 = 0; c0 < HC; c0 += 8) {
          float kv[8], qv[8];
          Elem<T>::load8(kr + c0, kv);
          Elem<T>::load8(qr + c0, qv);
#pragma unroll
          for (int j = 0; j < 8; ++j) t = fmaf(qv[j], kv[j], t);
        }
        s[a] += t;
      }
      // degree-1 SH term from coordinate differences
      if (with_sh) {
        const float dx = px - pb[m];
        const float dy = py - pb[n + m];
        const float dz = pz - pb[2 * n + m];
        const float r = sqrtf(dx * dx + dy * dy + dz * dz);
        const float rinv = (m == row) ? 0.f : kSh1 / (r + 1e-12f);
#pragma unroll
        for (int a = 0; a < AH; ++a) {
          const float pre = qwb[a * n + row] * dy + qwb[(AH + a) * n + row] * dz
                            + qwb[(2 * AH + a) * n + row] * dx;
          s[a] += rinv * pre;
        }
      }
    }

    // online softmax per anchor-head
#pragma unroll
    for (int a = 0; a < AH; ++a) {
      const float sv = valid ? s[a] * scale : kNeg;
      const float mnew = fmaxf(mrun[a], warp_max(sv));
      const float alpha = expf(mrun[a] - mnew);
      const float p = valid ? expf(sv - mnew) : 0.f;
      lrun[a] = lrun[a] * alpha + warp_sum(p);
      acc[a][0] *= alpha;
      acc[a][1] *= alpha;
      mrun[a] = mnew;
      my_p[a * 32 + lane] = Elem<T>::round(p);
    }
    __syncwarp();
    if (pv_lane) {
      const int mcount = min(32, n - m0);
#pragma unroll
      for (int a = 0; a < AH; ++a) {
        const T* vb = v + ((long long)(b * AH + a) * n + m0) * HC + 2 * lane;
        float a0 = acc[a][0], a1 = acc[a][1];
        for (int j = 0; j < mcount; ++j) {
          const float p = my_p[a * 32 + j];
          const float2 vv = Elem<T>::load2(vb + (long long)j * HC);
          a0 = fmaf(p, vv.x, a0);
          a1 = fmaf(p, vv.y, a1);
        }
        acc[a][0] = a0;
        acc[a][1] = a1;
      }
    }
    __syncwarp();
  }

  if (pv_lane) {
#pragma unroll
    for (int a = 0; a < AH; ++a) {
      const float denom = fmaxf(lrun[a], 1e-30f);
      float* o = out + ((long long)(b * AH + a) * n + row) * HC + 2 * lane;
      o[0] = acc[a][0] / denom;
      o[1] = acc[a][1] / denom;
    }
  }
  if (lse != nullptr && lane == 0) {
#pragma unroll
    for (int a = 0; a < AH; ++a)
      lse[(long long)(b * AH + a) * n + row] = mrun[a] + logf(fmaxf(lrun[a], 1e-30f));
  }
}

template <typename T, int AH, int HC, class Pos>
int launch(const void* q, const void* k, const void* v, const void* qp, const void* kmask,
           const void* qw, const void* pts, void* out, void* lse, int batch, int n, int cc,
           int pts_rows, float scale, const Pos& pos, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * AH * (cc + 32) * sizeof(float);
  static size_t attr = 0;  // the kernel's shared-memory attribute, raised once per size
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(rpe_attention_kernel<T, AH, HC, Pos>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  const int grid = batch * ((n + kWarps - 1) / kWarps);
  rpe_attention_kernel<T, AH, HC, Pos><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)qp, (const uint8_t*)kmask,
      (const float*)qw, (const float*)pts, (float*)out, (float*)lse, n, cc, pts_rows, scale,
      pos);
  return (int)cudaGetLastError();
}

// The CUDA-core kernel for (T, AH, head width hc) with the policy `pos`: AH
// 4 or 24, head width 16, 32 or 64; cudaErrorInvalidValue where none is
// built.
template <typename T, class Pos>
int dispatch_cuda(const void* q, const void* k, const void* v, const void* qp,
                  const void* kmask, const void* qw, const void* pts, void* out, void* lse,
                  int batch, int ah, int n, int hc, int cc, int pts_rows, float scale,
                  const Pos& pos, cudaStream_t s) {
  if (cc % 16 != 0) return (int)cudaErrorInvalidValue;
  if (ah == 24 && hc == 64)
    return launch<T, 24, 64>(q, k, v, qp, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, pos, s);
  if (ah == 4 && hc == 64)
    return launch<T, 4, 64>(q, k, v, qp, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, pos, s);
  if (ah == 24 && hc == 32)
    return launch<T, 24, 32>(q, k, v, qp, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, pos, s);
  if (ah == 4 && hc == 32)
    return launch<T, 4, 32>(q, k, v, qp, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, pos, s);
  if (ah == 24 && hc == 16)
    return launch<T, 24, 16>(q, k, v, qp, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, pos, s);
  if (ah == 4 && hc == 16)
    return launch<T, 4, 16>(q, k, v, qp, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, pos, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace rpe
}  // namespace se3et
