// Backward score recompute of the flash RPE self-attention (K11).
//
// For the scores s of K5 (rpe_attention.cu), recomputed from (q, k, qp,
// emb, the SH term, the key mask) exactly as K5 defines them, and the row
// log-sum-exp lse that K5 writes:
//   P[b,ah,n,m]  = k_mask[m] ? exp(scale * s - lse[b,ah,n]) : 0
//   dS[b,ah,n,m] = P * (dO[b,ah,n] . v[b,ah,m] - D[b,ah,n])
// with D = rowsum(dO * out) from the float32 forward output.  Replaces the
// TPU kernel se3et_tpu/ops/pallas/rpe_attention.py _rpe_bwd, whose Pallas
// piece (_bwd_p_kernel) writes P; here dS is formed in the same pass.  The
// gradient contractions over P and dS (dv, dk, dq, dqp, d_emb, dqw) run as
// matmuls in the wrapper, as the JAX package runs them as XLA einsums.
//
// Bound: the embedding's bytes (1.07 GB per launch at B=2, N=1024, C=256,
// bf16) and the two (B, AH, N, N) float32 outputs.  Design: K5's CUDA-core
// layout -- a block owns kWarps query rows and all AH anchor-heads, so each
// emb[b,n,m,:] row is streamed once; one warp per query row, one lane per
// key of a 32-key tile, the block's folded positional queries in shared
// memory as float32.  Each lane writes its P and dS entries, so a warp
// stores 32 consecutive keys.  Float32 FMA on the CUDA cores throughout; a
// tensor-core version that also runs the contractions in-kernel is later
// work.
#include "attention_common.cuh"

namespace {

using namespace se3et;

constexpr int kWarps = 8;  // query rows per block
constexpr int kThreads = kWarps * 32;
constexpr float kSh1 = 0.48860251190291992f;  // sqrt(3 / (4 pi))

// q, k, v (B, AH, N, HC); qp (B, N, AH, C); emb (B, N, N, C); kmask (B, N);
// qw (B, 3, AH, N) f32 rows (y, z, x) or null; pts (B, pts_rows, N) f32;
// dout (B, AH, N, HC) f32; lse, dd (B, AH, N) f32; p_out, ds_out
// (B, AH, N, N) f32.
template <typename T, int AH, int HC>
__global__ void __launch_bounds__(kThreads, 1)
rpe_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ qp,
                         const T* __restrict__ emb, const uint8_t* __restrict__ kmask,
                         const float* __restrict__ qw, const float* __restrict__ pts,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ dd, float* __restrict__ p_out,
                         float* __restrict__ ds_out, int n, int cc, int pts_rows, float scale) {
  extern __shared__ float smem[];
  float* qp_s = smem;  // [kWarps][AH][cc]

  const int nblk = (n + kWarps - 1) / kWarps;
  const int b = blockIdx.x / nblk;
  const int row0 = (blockIdx.x - b * nblk) * kWarps;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

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
  float lse_r[AH], dd_r[AH];
#pragma unroll
  for (int a = 0; a < AH; ++a) {
    lse_r[a] = lse[(long long)(b * AH + a) * n + row];
    dd_r[a] = dd[(long long)(b * AH + a) * n + row];
  }

  for (int m0 = 0; m0 < n; m0 += 32) {
    const int m = m0 + lane;
    if (m >= n) continue;  // no warp collectives below
    const bool valid = km[m] != 0;
    float s[AH];
#pragma unroll
    for (int a = 0; a < AH; ++a) s[a] = 0.f;
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
    float rinv = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    if (with_sh) {
      dx = px - pb[m];
      dy = py - pb[n + m];
      dz = pz - pb[2 * n + m];
      const float r = sqrtf(dx * dx + dy * dy + dz * dz);
      rinv = (m == row) ? 0.f : kSh1 / (r + 1e-12f);
    }
#pragma unroll
    for (int a = 0; a < AH; ++a) {
      const long long head = (long long)(b * AH + a) * n;
      const T* kr = k + (head + m) * HC;
      const T* qr = q + (head + row) * HC;
      const T* vr = v + (head + m) * HC;
      const float* dr = dout + (head + row) * HC;
      float qk = 0.f, dv = 0.f;
#pragma unroll
      for (int c0 = 0; c0 < HC; c0 += 8) {
        float kv[8], qv[8], vv[8], dv8[8];
        Elem<T>::load8(kr + c0, kv);
        Elem<T>::load8(qr + c0, qv);
        Elem<T>::load8(vr + c0, vv);
        Elem<float>::load8(dr + c0, dv8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          qk = fmaf(qv[j], kv[j], qk);
          dv = fmaf(dv8[j], vv[j], dv);
        }
      }
      float sv = s[a] + qk;
      if (with_sh) {
        const float pre = qwb[a * n + row] * dy + qwb[(AH + a) * n + row] * dz
                          + qwb[(2 * AH + a) * n + row] * dx;
        sv += rinv * pre;
      }
      const float p = valid ? expf(sv * scale - lse_r[a]) : 0.f;
      const long long o = (head + row) * n + m;
      p_out[o] = p;
      ds_out[o] = p * (dv - dd_r[a]);
    }
  }
}

template <typename T, int AH, int HC>
int launch(const void* q, const void* k, const void* v, const void* qp, const void* emb,
           const void* kmask, const void* qw, const void* pts, const void* dout,
           const void* lse, const void* dd, void* p_out, void* ds_out, int batch, int n,
           int cc, int pts_rows, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * AH * cc * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rpe_attention_bwd_kernel<T, AH, HC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = batch * ((n + kWarps - 1) / kWarps);
  rpe_attention_bwd_kernel<T, AH, HC><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)qp, (const T*)emb,
      (const uint8_t*)kmask, (const float*)qw, (const float*)pts, (const float*)dout,
      (const float*)lse, (const float*)dd, (float*)p_out, (float*)ds_out, n, cc, pts_rows,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* qp, const void* emb,
             const void* kmask, const void* qw, const void* pts, const void* dout,
             const void* lse, const void* dd, void* p_out, void* ds_out, int batch, int ah,
             int n, int hc, int cc, int pts_rows, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cc % 8 != 0) return (int)cudaErrorInvalidValue;
  if (ah == 24 && hc == 64)
    return launch<T, 24, 64>(q, k, v, qp, emb, kmask, qw, pts, dout, lse, dd, p_out, ds_out,
                             batch, n, cc, pts_rows, scale, s);
  if (ah == 4 && hc == 64)
    return launch<T, 4, 64>(q, k, v, qp, emb, kmask, qw, pts, dout, lse, dd, p_out, ds_out,
                            batch, n, cc, pts_rows, scale, s);
  if (ah == 24 && hc == 16)
    return launch<T, 24, 16>(q, k, v, qp, emb, kmask, qw, pts, dout, lse, dd, p_out, ds_out,
                             batch, n, cc, pts_rows, scale, s);
  if (ah == 4 && hc == 16)
    return launch<T, 4, 16>(q, k, v, qp, emb, kmask, qw, pts, dout, lse, dd, p_out, ds_out,
                            batch, n, cc, pts_rows, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int se3et_rpe_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* qp, const void* emb,
    const void* kmask, const void* qw, const void* pts, const void* dout, const void* lse,
    const void* dd, void* p_out, void* ds_out, int batch, int ah, int n, int hc, int cc,
    int pts_rows, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, qp, emb, kmask, qw, pts, dout, lse, dd, p_out,
                                 ds_out, batch, ah, n, hc, cc, pts_rows, scale, stream);
}

extern "C" int se3et_rpe_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* qp, const void* emb,
    const void* kmask, const void* qw, const void* pts, const void* dout, const void* lse,
    const void* dd, void* p_out, void* ds_out, int batch, int ah, int n, int hc, int cc,
    int pts_rows, float scale, void* stream) {
  return dispatch<float>(q, k, v, qp, emb, kmask, qw, pts, dout, lse, dd, p_out, ds_out,
                         batch, ah, n, hc, cc, pts_rows, scale, stream);
}
