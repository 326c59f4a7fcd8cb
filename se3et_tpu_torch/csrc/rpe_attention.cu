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
// The kernels (rpe_attention_core.cuh, shared with K16) take the
// positional term from the policy EmbRows below:
// * bf16 (the serving path; head width 64, C % 32 == 0): on the tensor
//   cores, each emb[b,n,m,:] row is streamed from device memory exactly once
//   (evict-first loads straight into A fragments) and contracted against
//   the AH folded queries of its row at once;
// * float32 (and other widths): on the CUDA cores, each lane streams its
//   own embedding row once and contracts it against the AH folded queries
//   held in shared memory as float32.
// wgmma and TMA are later work.  Where lse is not null, the kernel also
// writes the row log-sum-exp (the row statistics _rpe_fwd returns for the
// backward, rpe_attention_bwd.cu); serving passes null.
#include "rpe_attention_core.cuh"

namespace {

using namespace se3et;

// The positional term qp . emb from a materialised embedding emb (B, N, N, C).
template <typename T>
struct EmbRows {
  const T* emb;

  size_t smem_bytes(int) const { return 0; }
  __device__ void init(char*, int) const {}

  template <int AH, int NT>
  __device__ __forceinline__ void tc_scores(int b, int n, int row, int key0, int cc,
                                            const __nv_bfloat16* qp, int, int lane, char*,
                                            float (&acc)[2][NT][4]) const {
    const int g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* erow = emb + ((long long)b * n + row) * n * cc;
    const __nv_bfloat16* qprow = qp + ((long long)b * n + row) * AH * cc;
#pragma unroll 2
    for (int c0 = 0; c0 < cc; c0 += 32) {
      uint4 ua[2][2], ub[NT];
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
      for (int nt = 0; nt < NT; ++nt) {
        const int ah = 8 * nt + g;
        ub[nt] = ld16(qprow + (long long)ah * cc + c0 + 8 * t, ah < AH);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16_x2(acc[mt][nt], ua[mt][0], ua[mt][1], ub[nt]);
    }
  }

  template <typename TT, int AH>
  __device__ __forceinline__ void lane_scores(int b, int n, int row, int m, int cc,
                                              const float* my_qp, float (&s)[AH]) const {
    // this lane's embedding row, read once for all AH
    const TT* erow = emb + (((long long)b * n + row) * n + m) * cc;
    for (int c0 = 0; c0 < cc; c0 += 8) {
      float e[8];
      Elem<TT>::stream8(erow + c0, e);
      rpe::qp_dot8<AH>(my_qp, cc, c0, e, s);
    }
  }
};

template <typename T>
int run(const void* q, const void* k, const void* v, const void* qp, const void* emb,
        const void* kmask, const void* qw, const void* pts, void* out, void* lse, int batch,
        int ah, int n, int hc, int cc, int pts_rows, float scale, void* stream) {
  const EmbRows<T> pos{(const T*)emb};
  return rpe::dispatch<T, EmbRows>(q, k, v, qp, kmask, qw, pts, out, lse, batch, ah, n, hc,
                                   cc, pts_rows, scale, pos, stream);
}

}  // namespace

extern "C" int se3et_rpe_attention_bf16(const void* q, const void* k, const void* v,
                                        const void* qp, const void* emb,
                                        const void* kmask, const void* qw,
                                        const void* pts, void* out, void* lse, int batch,
                                        int ah, int n, int hc, int cc, int pts_rows,
                                        float scale, void* stream) {
  return run<__nv_bfloat16>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, ah, n, hc, cc,
                            pts_rows, scale, stream);
}

extern "C" int se3et_rpe_attention_f32(const void* q, const void* k, const void* v,
                                       const void* qp, const void* emb, const void* kmask,
                                       const void* qw, const void* pts, void* out,
                                       void* lse, int batch, int ah, int n, int hc, int cc,
                                       int pts_rows, float scale, void* stream) {
  return run<float>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, ah, n, hc, cc,
                    pts_rows, scale, stream);
}
