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
// Two forms, chosen by shape (the wrapper's rpe_attention_form mirrors
// the choice):
// * "ws" (bf16, head widths 64 and 32, C % 32 == 0, where its plan fits a
//   block: the serving path): rpe_attention_ws.cuh.  A producer warp
//   streams each emb[b,n,m,:] row from device memory exactly once, as bulk
//   copies into a ring of shared memory, while positional warps contract it
//   against the AH folded queries of its row on the tensor cores and flash
//   warps run the softmax and p.v of the previous key tile;
// * "cuda" (float32 and head width 16): rpe_attention_core.cuh's
//   CUDA-core kernel with the policy EmbRows below; each lane streams its
//   own embedding row once and contracts it against the AH folded queries
//   held in shared memory as float32.  It is also the first design of the
//   bf16 shapes "ws" takes, reachable there only by its own entry
//   (se3et_rpe_attention_cuda_bf16), for tests and timings.
// Where lse is not null, the kernel also writes the row log-sum-exp (the
// row statistics _rpe_fwd returns for the backward, rpe_attention_bwd.cu);
// serving passes null.
#include "rpe_attention_ws.cuh"

namespace {

using namespace se3et;

// The positional term qp . emb of the CUDA-core kernel, from a
// materialised embedding emb (B, N, N, C).
template <typename T>
struct EmbRows {
  const T* emb;

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

// first: the CUDA-core kernel whatever the shape
template <typename T>
int run(const void* q, const void* k, const void* v, const void* qp, const void* emb,
        const void* kmask, const void* qw, const void* pts, void* out, void* lse, int batch,
        int ah, int n, int hc, int cc, int pts_rows, float scale, void* stream,
        bool first = false) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t ws = rpe_ws::smem_bytes(ah, hc, cc);
  if (std::is_same<T, __nv_bfloat16>::value && !first && ws != 0
      && ws <= (size_t)rpe_ws::kMaxSmem)
    return rpe_ws::dispatch(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, ah, n, hc, cc,
                            pts_rows, scale, s);
  const EmbRows<T> pos{(const T*)emb};
  return rpe::dispatch_cuda<T>(q, k, v, qp, kmask, qw, pts, out, lse, batch, ah, n, hc, cc,
                               pts_rows, scale, pos, s);
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

// the first design (the CUDA-core kernel) at any bf16 shape it takes
extern "C" int se3et_rpe_attention_cuda_bf16(const void* q, const void* k, const void* v,
                                             const void* qp, const void* emb,
                                             const void* kmask, const void* qw,
                                             const void* pts, void* out, void* lse,
                                             int batch, int ah, int n, int hc, int cc,
                                             int pts_rows, float scale, void* stream) {
  return run<__nv_bfloat16>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, ah, n, hc, cc,
                            pts_rows, scale, stream, true);
}

extern "C" int se3et_rpe_attention_f32(const void* q, const void* k, const void* v,
                                       const void* qp, const void* emb, const void* kmask,
                                       const void* qw, const void* pts, void* out,
                                       void* lse, int batch, int ah, int n, int hc, int cc,
                                       int pts_rows, float scale, void* stream) {
  return run<float>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, ah, n, hc, cc,
                    pts_rows, scale, stream);
}

// the shared memory of the ws form at (ah, hc, cc), 0 where it is not built
// (the wrapper's rpe_attention.ws_smem_bytes is held against it)
extern "C" long long se3et_rpe_attention_ws_smem(int ah, int hc, int cc) {
  return (long long)se3et::rpe_ws::smem_bytes(ah, hc, cc);
}
