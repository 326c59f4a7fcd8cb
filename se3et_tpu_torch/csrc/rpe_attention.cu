// Flash RPE self-attention (K5).
//
// Same function as the TPU kernel se3et_tpu/ops/pallas/rpe_attention.py
// rpe_self_attention (_rpe_fwd):
//   s[b,ah,n,m] = scale * (q[b,ah,n].k[b,ah,m] + qp[b,n,ah].emb[b,n,m]
//                          + rinv(n,m) * (qw_y dy + qw_z dz + qw_x dx))
//   out[b,ah,n] = sum_m softmax_m(s) v[b,ah,m]        (float32 out)
// with d = p_n - p_m, rinv = sqrt(3/4pi) / (|d| + 1e-12) and rinv = 0 where
// n == m (by index).  Keys with k_mask == 0 get s = -1e9 before the exp and
// p = 0; p is rounded to v's type before p.v, as on the TPU.
//
// Bound: bytes.  At the serving shape (B=2, AH=24, N=1024, C=256, bf16)
// the embedding is 1.07 GB per launch against ~60 MB for everything else,
// so the card needs >= 0.32 ms; the ~39 GFLOP would take 0.04 ms on the
// tensor cores.  A textbook flash layout (one block per (b, ah, query
// block)) would read each emb[b,n,m,:] row AH = 24 times.
//
// Two kernels compute it, chosen by element type:
// * bf16 (the serving path; head width 64, C % 32 == 0):
//   rpe_attention_tc_kernel below, on the tensor cores (mma.sync).  A block
//   owns 16 query rows of one cloud and ALL AH anchor-heads, so each
//   emb[b,n,m,:] row is streamed from device memory exactly once (evict-
//   first loads straight into A fragments) and contracted against the AH
//   folded queries at once; the positional scores go through shared memory
//   to a flash-attention phase with one warp per anchor-head.
// * float32 (and other widths): rpe_attention_kernel, on the CUDA cores.
//   One block owns kWarps query rows and all AH, one warp per query row,
//   one lane per key of a 32-key tile; each lane streams its own embedding
//   row once and contracts it against the AH folded queries held in shared
//   memory as float32 (kWarps*AH*C*4 = 192 KB at AH=24, C=256).
// Both use an online softmax per (row, ah) with no cross-block state and
// no atomics.  wgmma and TMA are later work.  Where lse is not null, each
// also writes the row log-sum-exp lse[b,ah,n] = max + log(sum) of the
// scaled, masked scores (the row statistics _rpe_fwd returns for the
// backward, rpe_attention_bwd.cu); serving passes null.
#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace se3et;

constexpr int kWarps = 8;  // query rows per block
constexpr int kThreads = kWarps * 32;
constexpr float kSh1 = 0.48860251190291992f;  // sqrt(3 / (4 pi))

// q, k, v (B, AH, N, HC); qp (B, N, AH, C); emb (B, N, N, C); kmask (B, N);
// qw (B, 3, AH, N) f32 rows (y, z, x) or null; pts (B, pts_rows, N) f32
// rows (x, y, z[, pad]); out (B, AH, N, HC) f32.
template <typename T, int AH, int HC>
__global__ void __launch_bounds__(kThreads, 1)
rpe_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ qp,
                     const T* __restrict__ emb, const uint8_t* __restrict__ kmask,
                     const float* __restrict__ qw, const float* __restrict__ pts,
                     float* __restrict__ out, float* __restrict__ lse, int n, int cc,
                     int pts_rows, float scale) {
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
  constexpr int kPairs = HC / 2;  // value columns are taken two per lane
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
      // positional term: this lane's embedding row, read once for all AH
      const T* erow = emb + (((long long)b * n + row) * n + m) * cc;
      for (int c0 = 0; c0 < cc; c0 += 8) {
        float e[8];
        Elem<T>::stream8(erow + c0, e);
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

// Tensor-core kernel (bf16, head width 64, C a multiple of 32), with the
// same function.  One block owns 16 query rows of one cloud and all AH
// anchor-heads; per tile of 32 keys it runs two phases:
//  1. positional scores, one warp per query row n: S^T(keys x AH) =
//     emb[b,n,keys,:] (A, 16 keys x C, streamed from device memory once)
//     . qp[b,n,:,:]^T (B, C x 8 anchor-heads per n-tile), plus the SH term,
//     into shared memory as float32;
//  2. flash attention per anchor-head, one warp per ah: content scores
//     q . k on the tensor cores, plus phase 1's scores, online softmax,
//     p (rounded to bf16) . v with v staged through ldmatrix.trans.
constexpr int kTcRows = 16;   // query rows per block
constexpr int kTcKeys = 32;   // keys per tile
constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kSpKeyStride = kTcKeys + 4;  // float32; phase-1 stores spread over banks

template <int AH>
struct SpLayout {
  // row stride = 8 (mod 32) floats: phase 2's float2 reads of rows g and
  // keys 2t fall on distinct banks
  static constexpr int kRowStride =
      AH * kSpKeyStride + (((8 - AH * kSpKeyStride) % 32) + 32) % 32;
  static constexpr int kFloats = kTcRows * kRowStride;
};

template <int AH, int HC>
__global__ void __launch_bounds__(kTcThreads, 1)
rpe_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ qp,
                        const __nv_bfloat16* __restrict__ emb,
                        const uint8_t* __restrict__ kmask, const float* __restrict__ qw,
                        const float* __restrict__ pts, float* __restrict__ out,
                        float* __restrict__ lse, int n, int cc, int pts_rows, float scale) {
  constexpr int kRS = SpLayout<AH>::kRowStride;
  constexpr int kNT = (AH + 7) / 8;  // anchor-head n-tiles (phase 1) = ah per warp (phase 2)
  constexpr int kVStride = HC + 8;   // bf16 per staged v row
  extern __shared__ __align__(16) float tc_smem[];
  float* sp = tc_smem;                                          // [16][kRS]
  __nv_bfloat16* vbuf = reinterpret_cast<__nv_bfloat16*>(sp + SpLayout<AH>::kFloats);

  const int nblk = (n + kTcRows - 1) / kTcRows;
  const int b = blockIdx.x / nblk;
  const int row0 = (blockIdx.x - b * nblk) * kTcRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint8_t* km = kmask + (long long)b * n;
  const bool with_sh = qw != nullptr;
  const float* pb = with_sh ? pts + (long long)b * pts_rows * n : nullptr;
  const float* qwb = with_sh ? qw + (long long)b * 3 * AH * n : nullptr;
  __nv_bfloat16* my_v = vbuf + warp * kTcKeys * kVStride;
  const int ra = row0 + g, rb = ra + 8;

  float o[kNT][HC / 8][4], mrun[kNT][2], lrun[kNT][2];
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) o[i][j][0] = o[i][j][1] = o[i][j][2] = o[i][j][3] = 0.f;
    mrun[i][0] = mrun[i][1] = __int_as_float(0xff800000);  // -inf
    lrun[i][0] = lrun[i][1] = 0.f;
  }

  for (int key0 = 0; key0 < n; key0 += kTcKeys) {
    // phase 1: positional (+ SH) scores of rows warp and warp + 8
#pragma unroll 1
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp + 8 * rr;
      const int row = row0 + r;
      if (row >= n) continue;
      const __nv_bfloat16* erow = emb + ((long long)b * n + row) * n * cc;
      const __nv_bfloat16* qprow = qp + ((long long)b * n + row) * AH * cc;
      float acc[2][kNT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
#pragma unroll 2
      for (int c0 = 0; c0 < cc; c0 += 32) {
        uint4 ua[2][2], ub[kNT];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int key = key0 + 16 * mt + 8 * hh + g;
            ua[mt][hh] = key < n ? __ldcs(reinterpret_cast<const uint4*>(
                                       erow + (long long)key * cc + c0 + 8 * t))
                                 : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int ah = 8 * nt + g;
          ub[nt] = ld16(qprow + (long long)ah * cc + c0 + 8 * t, ah < AH);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_bf16_x2(acc[mt][nt], ua[mt][0], ua[mt][1], ub[nt]);
      }
      float px = 0.f, py = 0.f, pz = 0.f;
      if (with_sh) {
        px = pb[row];
        py = pb[n + row];
        pz = pb[2 * n + row];
      }
      float* sprow = sp + r * kRS;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int kl = 16 * mt + 8 * hh + g;
          const int key = key0 + kl;
          float fx = 0.f, fy = 0.f, fz = 0.f;
          if (with_sh && key < n) {
            const float dx = px - pb[key];
            const float dy = py - pb[n + key];
            const float dz = pz - pb[2 * n + key];
            const float rr2 = sqrtf(dx * dx + dy * dy + dz * dz);
            const float rinv = (key == row) ? 0.f : kSh1 / (rr2 + 1e-12f);
            fx = rinv * dx;
            fy = rinv * dy;
            fz = rinv * dz;
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int ah = 8 * nt + 2 * t + i;
              if (ah >= AH) continue;
              float val = acc[mt][nt][2 * hh + i];
              if (with_sh)
                val += qwb[ah * n + row] * fy + qwb[(AH + ah) * n + row] * fz
                       + qwb[(2 * AH + ah) * n + row] * fx;
              sprow[ah * kSpKeyStride + kl] = val;
            }
        }
    }
    __syncthreads();

    // phase 2: flash attention of anchor-heads warp, warp + 8, ...
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int ah = warp + 8 * i;
      if (ah >= AH) break;
      const long long head = (long long)b * AH + ah;
      stage_rows<HC, kTcKeys>(v + head * n * HC, n, key0, my_v, kVStride, lane, 32);
      uint4 qf[HC / 32][2];
      load_q<HC>(q + head * n * HC, n, ra, rb, t, qf);
      float s[kTcKeys / 8][4];
      qk_tile<HC, kTcKeys / 8>(qf, k + head * n * HC, n, key0, g, t, s);
      float mxa = kNeg, mxb = kNeg;
      bool kv[kTcKeys / 8][2];
#pragma unroll
      for (int j = 0; j < kTcKeys / 8; ++j) {
        const int kl = 8 * j + 2 * t;
        const float2 pa = *reinterpret_cast<const float2*>(sp + g * kRS + ah * kSpKeyStride + kl);
        const float2 pbb =
            *reinterpret_cast<const float2*>(sp + (g + 8) * kRS + ah * kSpKeyStride + kl);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int key = key0 + kl + ii;
          kv[j][ii] = key < n && km[key] != 0;
          const float va = (s[j][ii] + (ii ? pa.y : pa.x)) * scale;
          const float vb = (s[j][2 + ii] + (ii ? pbb.y : pbb.x)) * scale;
          s[j][ii] = kv[j][ii] ? va : kNeg;
          s[j][2 + ii] = kv[j][ii] ? vb : kNeg;
          mxa = fmaxf(mxa, s[j][ii]);
          mxb = fmaxf(mxb, s[j][2 + ii]);
        }
      }
      const float ma = fmaxf(mrun[i][0], quad_max(mxa));
      const float mb = fmaxf(mrun[i][1], quad_max(mxb));
      const float alpha_a = expf(mrun[i][0] - ma);
      const float alpha_b = expf(mrun[i][1] - mb);
      float suma = 0.f, sumb = 0.f;
#pragma unroll
      for (int j = 0; j < kTcKeys / 8; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const float pa = kv[j][ii] ? expf(s[j][ii] - ma) : 0.f;
          const float pbv = kv[j][ii] ? expf(s[j][2 + ii] - mb) : 0.f;
          s[j][ii] = pa;
          s[j][2 + ii] = pbv;
          suma += pa;
          sumb += pbv;
        }
      lrun[i][0] = lrun[i][0] * alpha_a + suma;
      lrun[i][1] = lrun[i][1] * alpha_b + sumb;
      mrun[i][0] = ma;
      mrun[i][1] = mb;
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        o[i][j][0] *= alpha_a;
        o[i][j][1] *= alpha_a;
        o[i][j][2] *= alpha_b;
        o[i][j][3] *= alpha_b;
      }
      __syncwarp();  // v tile staged
      pv_tile<HC, kTcKeys>(s, my_v, kVStride, lane, o[i]);
      __syncwarp();  // before the next staging overwrites it
    }
    __syncthreads();  // phase-1 scores are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const int ah = warp + 8 * i;
    if (ah >= AH) break;
    const float la = fmaxf(quad_sum(lrun[i][0]), 1e-30f);
    const float lb = fmaxf(quad_sum(lrun[i][1]), 1e-30f);
    float* oh = out + ((long long)b * AH + ah) * n * HC;
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) {
      if (ra < n)
        *reinterpret_cast<float2*>(oh + (long long)ra * HC + 8 * j + 2 * t) =
            make_float2(o[i][j][0] / la, o[i][j][1] / la);
      if (rb < n)
        *reinterpret_cast<float2*>(oh + (long long)rb * HC + 8 * j + 2 * t) =
            make_float2(o[i][j][2] / lb, o[i][j][3] / lb);
    }
    if (lse != nullptr && t == 0) {
      float* lh = lse + ((long long)b * AH + ah) * n;
      if (ra < n) lh[ra] = mrun[i][0] + logf(la);
      if (rb < n) lh[rb] = mrun[i][1] + logf(lb);
    }
  }
}

template <int AH, int HC>
int launch_tc(const void* q, const void* k, const void* v, const void* qp, const void* emb,
              const void* kmask, const void* qw, const void* pts, void* out, void* lse,
              int batch, int n, int cc, int pts_rows, float scale, cudaStream_t stream) {
  const size_t smem = SpLayout<AH>::kFloats * sizeof(float)
                      + (size_t)kTcWarps * kTcKeys * (HC + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(rpe_attention_tc_kernel<AH, HC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = batch * ((n + kTcRows - 1) / kTcRows);
  rpe_attention_tc_kernel<AH, HC><<<grid, kTcThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)qp, (const __nv_bfloat16*)emb, (const uint8_t*)kmask,
      (const float*)qw, (const float*)pts, (float*)out, (float*)lse, n, cc, pts_rows, scale);
  return (int)cudaGetLastError();
}

template <typename T, int AH, int HC>
int launch(const void* q, const void* k, const void* v, const void* qp, const void* emb,
           const void* kmask, const void* qw, const void* pts, void* out, void* lse,
           int batch, int n, int cc, int pts_rows, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * AH * (cc + 32) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rpe_attention_kernel<T, AH, HC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = batch * ((n + kWarps - 1) / kWarps);
  rpe_attention_kernel<T, AH, HC><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)qp, (const T*)emb,
      (const uint8_t*)kmask, (const float*)qw, (const float*)pts, (float*)out, (float*)lse,
      n, cc, pts_rows, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* qp,
             const void* emb, const void* kmask, const void* qw, const void* pts,
             void* out, void* lse, int batch, int ah, int n, int hc, int cc, int pts_rows,
             float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cc % 16 != 0) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (hc == 64 && cc % 32 == 0) {
      if (ah == 24)
        return launch_tc<24, 64>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, s);
      if (ah == 4)
        return launch_tc<4, 64>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, s);
    }
  }
  if (ah == 24 && hc == 64)
    return launch<T, 24, 64>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, s);
  if (ah == 4 && hc == 64)
    return launch<T, 4, 64>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, s);
  if (ah == 24 && hc == 16)
    return launch<T, 24, 16>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, s);
  if (ah == 4 && hc == 16)
    return launch<T, 4, 16>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, n, cc, pts_rows, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int se3et_rpe_attention_bf16(const void* q, const void* k, const void* v,
                                        const void* qp, const void* emb,
                                        const void* kmask, const void* qw,
                                        const void* pts, void* out, void* lse, int batch,
                                        int ah, int n, int hc, int cc, int pts_rows,
                                        float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, ah, n,
                                 hc, cc, pts_rows, scale, stream);
}

extern "C" int se3et_rpe_attention_f32(const void* q, const void* k, const void* v,
                                       const void* qp, const void* emb, const void* kmask,
                                       const void* qw, const void* pts, void* out,
                                       void* lse, int batch, int ah, int n, int hc, int cc,
                                       int pts_rows, float scale, void* stream) {
  return dispatch<float>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, ah, n, hc, cc,
                         pts_rows, scale, stream);
}
