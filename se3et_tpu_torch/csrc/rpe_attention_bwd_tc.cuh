// K11's bf16 form ("tc"; head width 64, C = 256, AH 4 or 24), included only
// by rpe_attention_bwd.cu.  For the scores s of K5, recomputed as K5
// defines them, and its row log-sum-exp lse:
//   P   = k_mask[m] ? exp(scale * s - lse) : 0
//   dS' = scale * P * (dO . v - D),   D = rowsum(dO * out)
// it writes P and dS' as bf16 (B, AH, N, N), and from dS' the gradients
//   dqp[b,n,ah,:]  = sum_m dS'[b,ah,n,m] emb[b,n,m,:]        (bf16)
//   demb[b,n,m,:]  = sum_ah dS'[b,ah,n,m] qp[b,n,ah,:]       (bf16)
//   dqw[b,d,ah,n]  = sum_m dS'[b,ah,n,m] rinv(n,m) d_yzx[d]  (float32)
// dq = dS' k, dk = dS'^T q and dv = P^T dO (dO rounded to bf16) are left to
// the wrapper's matrix products over the stored P and dS', as the JAX
// package leaves every contraction of its _rpe_bwd to XLA.  Keeping dq in
// the kernel would take 96 more registers a lane at AH = 24, beside dqp's
// 96; reading dS' once more costs ~0.03 ms.
//
// Bound: bytes.  The embedding is read once and d_emb written once: 2 x
// 1.07 GB per launch at B = 2, N = 1024, C = 256, >= 0.64 ms on the card;
// P and dS' add 2 x 100 MB at AH = 24.  No float32 (B, AH, N, N) tensor and
// no float32 copy of the embedding is made.
//
// A block owns kRows = 4 query rows of one cloud and all AH anchor-heads,
// so each embedding row is read from device memory once and dqp[b, n]
// (AH x C float32, 24 KB a row at AH = 24) stays in registers for the whole
// key loop: at AH = 24 16 warps (4 a row, 64 channels each, 48
// accumulators a lane), at AH = 4 8 warps (2 a row).  Per 32-key tile,
// with the next tile's slabs (kRows x 32 keys x C, 64 KB) already on their
// way by cp.async (16 bytes a thread, evict-first in L2, chunks
// XOR-swizzled by key so ldmatrix reads them without bank conflicts),
// three phases between block barriers, every product on mma.sync with
// float32 sums:
// 1. positional, 8 warps: warp w, row w / 2, keys 16 (w & 1) ..: S_pos^T
//    (16 keys x AH) = slab (ldmatrix) . qp^T (ldmatrix of the row's
//    resident qp), plus the SH term, into a float32 score buffer; the row's
//    SH geometry rinv * d_yzx per key into a small table;
// 2. content, every warp: per (anchor-head, 16-key m-tile) item, 3 a warp
//    at AH = 24, 1 at AH = 4: S^T = k . q^T and dP^T = v . dO^T (keys as M,
//    the 4 rows as N, k and v read from L2 as A fragments, q and dO
//    resident), then P (in place of its positional score) and dS' (rounded
//    to bf16 into a shared buffer), and dqw's sums in registers;
// 3. every warp: the tile's P and dS' to device memory in 16-byte stores
//    (4 threads a (row, head) run of 32 keys); then for its row and
//    channels: dqp^T += slab^T (ldmatrix.trans) . dS'^T, and d_emb (32 keys
//    x its channels) = dS'^T (ldmatrix.trans) . qp (ldmatrix.trans), the
//    anchor-heads as K (16 + an m16n8k8 step at AH = 24, one m16n8k8 step
//    over 8 padded ones at AH = 4), transposed within each quad of lanes so
//    that each lane stores 16 contiguous bytes, once.
// dqw sums over the keys of each item; the two m-tiles of an anchor-head
// add their sums onto the zeroed output, and two addends onto zero give the
// same float32 in either order, so the form is deterministic.
// What bounds it (scripts/probe_rpe_attention_bwd.py): at AH = 4 the
// stream of the embedding and d_emb; at AH = 24 the content phase, which
// reads k and v from L2 once per 4 rows (~3 GB a launch against the
// embedding's 1.07).  RPE_BWD_TC_STAGE cuts the kernel for the probe's
// ablations: 0 positional scores only, 1 + the content phase (scores, P,
// dS'), 2 + dqp, 3 + d_emb, 4 (the form) + the P and dS' stores.
#pragma once

#include "async_copy.cuh"
#include "attention_common.cuh"

#ifndef RPE_BWD_TC_STAGE
#define RPE_BWD_TC_STAGE 4
#endif
#ifndef RPE_BWD_TC_WARPS24  // warps a block at AH = 24 (the probe also tries 8)
#define RPE_BWD_TC_WARPS24 16
#endif

namespace se3et {
namespace rpe_bwd_tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 4;    // query rows per block
constexpr int kKeys = 32;   // keys per tile
constexpr int kHC = 64;     // head width
constexpr int kC = 256;     // embedding width
constexpr int kChunks = kC / 8;  // 16-byte chunks of an embedding row
constexpr int kMaxSmem = 232448;
constexpr float kSh1 = 0.48860251190291992f;  // sqrt(3 / (4 pi))
constexpr int kStage = RPE_BWD_TC_STAGE;
constexpr int kPosWarps = 2 * kRows;  // phase 1: a warp per (row, 16-key m-tile)

template <int AH>
struct Layout {
  // 16 warps at AH = 24 (a block of 512 threads, 128 registers each), 8
  // at AH = 4
  static constexpr int kWarps = AH >= 16 ? RPE_BWD_TC_WARPS24 : 8;
  static constexpr int kThreads = kWarps * 32;
  static_assert((2 * AH) % kWarps == 0, "content items per warp");
  static constexpr int kSlices = kWarps / kRows;   // phase 3: channel slices a row
  static constexpr int kSliceC = kC / kSlices;     // channels a slice (64, 128)
  static constexpr int kMC = kSliceC / 16;         // dqp^T m-tiles a warp
  static constexpr int kGroups = kSliceC / 32;     // d_emb groups of 4 n-tiles a warp
  static constexpr int kAHP = (AH + 7) / 8 * 8;  // anchor-heads padded to n-tiles of 8
  static constexpr int kNT = kAHP / 8;
  static constexpr bool kK16 = kAHP >= 16;       // d_emb: one m16n8k16 step over AH
  static constexpr bool kK8 = kAHP % 16 != 0;    // and one m16n8k8 step
  static constexpr int kItems = 2 * AH / kWarps;  // content items a warp, of distinct heads
  static constexpr int kSpRow = 36;               // floats per (head, row): = 4 (mod 16)
  static constexpr int kSpHead = kRows * kSpRow + 4;  // = 4 (mod 16)
  static constexpr int kDsRow = 40;               // bf16 per (row, head) of dS'
  static constexpr size_t kSlab = (size_t)kKeys * kC;  // bf16 of one (row, tile) slab
  // byte offsets of the shared-memory plan (mirrored by the wrapper's
  // rpe_attention.bwd_tc_smem_bytes)
  static constexpr size_t emb = 0;                                       // [2][kRows] slabs
  static constexpr size_t qp = emb + 2 * kRows * kSlab * 2;              // [kRows][kAHP][kC]
  static constexpr size_t qd = qp + (size_t)kRows * kAHP * kC * 2;       // [q, dO][AH][kRows][kHC]
  static constexpr size_t sp = qd + 2 * (size_t)AH * kRows * kHC * 2;    // [AH][kSpHead] f32
  static constexpr size_t ds = sp + (size_t)AH * kSpHead * 4;            // [kRows][kAHP][kDsRow]
  static constexpr size_t geo = ds + (size_t)kRows * kAHP * kDsRow * 2;  // [kRows][kKeys] float4
  static constexpr size_t qw = geo + (size_t)kRows * kKeys * 16;         // [kRows][3][AH] f32
  static constexpr size_t stats = qw + (size_t)kRows * 3 * AH * 4;       // lse, D [AH][kRows]
  static constexpr size_t bytes = stats + 2 * (size_t)AH * kRows * 4;
};

// element offsets of 16-byte chunks: an embedding slab's rows (keys) XOR
// their chunks by key & 7, qp's rows (anchor-heads) by ah & 7, the q / dO
// rows (128 bytes) by (row & 1) << 2
__device__ __forceinline__ int slab_chunk(int key, int ch) {
  return key * kC + ((ch ^ (key & 7)) << 3);
}
template <int AH>
__device__ __forceinline__ int qp_chunk(int r, int ah, int ch) {
  return (r * Layout<AH>::kAHP + ah) * kC + ((ch ^ (ah & 7)) << 3);
}
template <int AH>
__device__ __forceinline__ int qd_chunk(int which, int ah, int r, int ch) {
  return ((which * AH + ah) * kRows + r) * kHC + ((ch ^ ((r & 1) << 2)) << 3);
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(smem)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(smem)));
}

// d += a . b, 16 x 8 A (rows g / g + 8, k-slots 2t, 2t + 1), 8 x 8 B
__device__ __forceinline__ void mma_k8(float* d, uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// A 4 x 4 transpose of 32-bit words across the four lanes of a quad (t =
// lane & 3): lane t gives w[0..3] and gets (lane 0's w[t], lane 1's w[t],
// lane 2's w[t], lane 3's w[t]); two butterfly stages of two shuffles
__device__ __forceinline__ uint4 quad_transpose(uint32_t w0, uint32_t w1, uint32_t w2,
                                                uint32_t w3, int t) {
  const bool p = t & 1, h = t & 2;
  // 2 x 2 blocks: swap with lane t ^ 1 the words of the other parity
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, p ? w0 : w1, 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, p ? w2 : w3, 1);
  const uint32_t x0 = p ? r0 : w0, x1 = p ? w1 : r0, x2 = p ? r1 : w2, x3 = p ? w3 : r1;
  // off-diagonal 2 x 2 blocks: swap with lane t ^ 2
  r0 = __shfl_xor_sync(0xffffffffu, h ? x0 : x2, 2);
  r1 = __shfl_xor_sync(0xffffffffu, h ? x1 : x3, 2);
  return h ? make_uint4(r0, r1, x2, x3) : make_uint4(x0, x1, r0, r1);
}

// q, k, v (B, AH, N, 64) bf16; qp (B, N, AH, 256); emb (B, N, N, 256);
// kmask (B, N); qw (B, 3, AH, N) f32 rows (y, z, x) or null; pts (B,
// pts_rows, N) f32; dout (B, AH, N, 64) bf16; lse, dd (B, AH, N) f32;
// p_out, ds_out (B, AH, N, N) bf16; dqp as qp; demb as emb; dqw as qw,
// zeroed by the caller (null without qw).
template <int AH>
__global__ void __launch_bounds__(Layout<AH>::kThreads, 1)
rpe_attention_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ qp,
                            const bf16* __restrict__ emb, const uint8_t* __restrict__ kmask,
                            const float* __restrict__ qw, const float* __restrict__ pts,
                            const bf16* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ dd, bf16* __restrict__ p_out,
                            bf16* __restrict__ ds_out, bf16* __restrict__ dqp,
                            bf16* __restrict__ demb, float* __restrict__ dqw, int n,
                            int pts_rows, float scale) {
  using L = Layout<AH>;
  constexpr int kWarps = L::kWarps, kThreads = L::kThreads;
  extern __shared__ __align__(128) char bwd_smem[];
  bf16* emb_s = reinterpret_cast<bf16*>(bwd_smem + L::emb);
  bf16* qp_s = reinterpret_cast<bf16*>(bwd_smem + L::qp);
  bf16* qd_s = reinterpret_cast<bf16*>(bwd_smem + L::qd);
  float* sp_s = reinterpret_cast<float*>(bwd_smem + L::sp);
  bf16* ds_s = reinterpret_cast<bf16*>(bwd_smem + L::ds);
  float4* geo_s = reinterpret_cast<float4*>(bwd_smem + L::geo);
  float* qw_s = reinterpret_cast<float*>(bwd_smem + L::qw);
  float* lse_s = reinterpret_cast<float*>(bwd_smem + L::stats);  // [AH][kRows]
  float* dd_s = lse_s + AH * kRows;

  const int nblk = (n + kRows - 1) / kRows;
  const int b = blockIdx.x / nblk;
  const int row0 = (blockIdx.x - b * nblk) * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row a lane addresses
  const int ntiles = (n + kKeys - 1) / kKeys;
  const bool with_sh = qw != nullptr;
  const float* pb = with_sh ? pts + (long long)b * pts_rows * n : nullptr;
  const uint8_t* km = kmask + (long long)b * n;
  const uint64_t policy = evict_first_policy();

  // the slabs emb[b, row0 + r, key0 .. key0 + 31, :] of tile j into buffer
  // j & 1, zero past n
  auto stage_emb = [&](int j) {
    bf16* dst = emb_s + (size_t)(j & 1) * kRows * L::kSlab;
    const int key0 = j * kKeys;
    for (int i = tid; i < kRows * kKeys * kChunks; i += kThreads) {
      const int r = i / (kKeys * kChunks), key = (i / kChunks) % kKeys, ch = i % kChunks;
      const bool ok = row0 + r < n && key0 + key < n;
      const bf16* src =
          ok ? emb + (((long long)b * n + row0 + r) * n + key0 + key) * kC + ch * 8 : emb;
      cp_async16_hint(dst + r * L::kSlab + slab_chunk(key, ch), src, ok, policy);
    }
    cp_async_commit();
  };
  stage_emb(0);

  // resident for the block: qp of its rows (zero past n and for the padded
  // anchor-heads), q and dO, the zero rows of dS' past AH, lse, D and qw
  for (int i = tid; i < kRows * L::kAHP * kChunks; i += kThreads) {
    const int r = i / (L::kAHP * kChunks), ah = (i / kChunks) % L::kAHP, ch = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && ah < AH)
      val = __ldg(reinterpret_cast<const uint4*>(
          qp + (((long long)b * n + row0 + r) * AH + ah) * kC + ch * 8));
    *reinterpret_cast<uint4*>(qp_s + qp_chunk<AH>(r, ah, ch)) = val;
  }
  for (int i = tid; i < 2 * AH * kRows * (kHC / 8); i += kThreads) {
    const int ch = i % (kHC / 8), r = (i / (kHC / 8)) % kRows;
    const int ah = (i / (kHC / 8 * kRows)) % AH, which = i / (kHC / 8 * kRows * AH);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = __ldg(reinterpret_cast<const uint4*>(
          (which ? dout : q) + (((long long)b * AH + ah) * n + row0 + r) * kHC + ch * 8));
    *reinterpret_cast<uint4*>(qd_s + qd_chunk<AH>(which, ah, r, ch)) = val;
  }
  if constexpr (L::kAHP > AH) {
    constexpr int kPad = (L::kAHP - AH) * L::kDsRow;
    for (int i = tid; i < kRows * kPad; i += kThreads)
      ds_s[((i / kPad) * L::kAHP + AH) * L::kDsRow + i % kPad] = __float2bfloat16(0.f);
  }
  for (int i = tid; i < AH * kRows; i += kThreads) {
    const int ah = i / kRows, r = i % kRows;
    const bool ok = row0 + r < n;
    const long long o = ((long long)b * AH + ah) * n + row0 + r;
    lse_s[i] = ok ? lse[o] : 0.f;
    dd_s[i] = ok ? dd[o] : 0.f;
  }
  if (with_sh) {  // qw_s[r][d][ah] = qw[b, d, ah, row0 + r]
    for (int i = tid; i < kRows * 3 * AH; i += kThreads) {
      const int r = i / (3 * AH), da = i % (3 * AH);
      qw_s[i] = row0 + r < n ? qw[((long long)b * 3 * AH + da) * n + row0 + r] : 0.f;
    }
  }

  // phase 1: row pr, keys 16 pm .. (warps < kPosWarps); phase 3: row wr,
  // channels c0 .. c0 + kSliceC - 1
  const int pr = warp >> 1, pm = warp & 1;
  const int wr = warp / L::kSlices, c0 = (warp % L::kSlices) * L::kSliceC;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (with_sh && row0 + pr < n && warp < kPosWarps) {
    px = pb[row0 + pr];
    py = pb[n + row0 + pr];
    pz = pb[2 * n + row0 + pr];
  }
  float dqp_acc[L::kMC][L::kNT][4];  // dqp^T: channel c0 + 16 mc + g (+8), ah 8 nt + 2t (+1)
#pragma unroll
  for (int mc = 0; mc < L::kMC; ++mc)
#pragma unroll
    for (int nt = 0; nt < L::kNT; ++nt)
      dqp_acc[mc][nt][0] = dqp_acc[mc][nt][1] = dqp_acc[mc][nt][2] = dqp_acc[mc][nt][3] = 0.f;
  float dqw_acc[L::kItems][2][3];  // (item, row 2t + i, d)
#pragma unroll
  for (int it = 0; it < L::kItems; ++it)
#pragma unroll
    for (int i = 0; i < 2; ++i) dqw_acc[it][i][0] = dqw_acc[it][i][1] = dqw_acc[it][i][2] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int key0 = j * kKeys;
    const bf16* slabs = emb_s + (size_t)(j & 1) * kRows * L::kSlab;
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; tile j - 1's phase 3 is done
    if (j + 1 < ntiles) stage_emb(j + 1);

    // 1. positional scores of row pr, keys 16 pm .. 16 pm + 15
    if (warp < kPosWarps) {
      const bf16* slab = slabs + pr * L::kSlab;
      float acc[L::kNT][4];
#pragma unroll
      for (int nt = 0; nt < L::kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kC / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, slab + slab_chunk(16 * pm + (mi & 1) * 8 + mr, 2 * kk + (mi >> 1)));
        uint32_t bq[L::kNT][2];
#pragma unroll
        for (int nt = 0; nt + 1 < L::kNT; nt += 2) {
          uint32_t r4[4];
          ldmatrix_x4(r4, qp_s + qp_chunk<AH>(pr, 8 * (nt + (mi >> 1)) + mr, 2 * kk + (mi & 1)));
          bq[nt][0] = r4[0];
          bq[nt][1] = r4[1];
          bq[nt + 1][0] = r4[2];
          bq[nt + 1][1] = r4[3];
        }
        if (L::kNT & 1)
          ldmatrix_x2(bq[L::kNT - 1],
                      qp_s + qp_chunk<AH>(pr, 8 * (L::kNT - 1) + mr, 2 * kk + (mi & 1)));
#pragma unroll
        for (int nt = 0; nt < L::kNT; ++nt)
          mma_bf16(acc[nt], a[0], a[1], a[2], a[3], bq[nt][0], bq[nt][1]);
      }
      const int row = row0 + pr;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kl = 16 * pm + 8 * hh + g, key = key0 + kl;
        float fx = 0.f, fy = 0.f, fz = 0.f;
        if (with_sh && key < n && row < n) {
          const float dx = px - pb[key], dy = py - pb[n + key], dz = pz - pb[2 * n + key];
          const float r = sqrtf(dx * dx + dy * dy + dz * dz);
          const float rinv = (key == row) ? 0.f : kSh1 / (r + 1e-12f);
          fx = rinv * dx;
          fy = rinv * dy;
          fz = rinv * dz;
        }
        if (with_sh && t == 0) geo_s[pr * kKeys + kl] = make_float4(fy, fz, fx, 0.f);
#pragma unroll
        for (int nt = 0; nt < L::kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int ah = 8 * nt + 2 * t + i;
            if (ah >= AH) continue;
            float val = acc[nt][2 * hh + i];
            if (with_sh) {
              const float* qwr = qw_s + pr * 3 * AH;
              val += qwr[ah] * fy + qwr[AH + ah] * fz + qwr[2 * AH + ah] * fx;
            }
            sp_s[ah * L::kSpHead + pr * L::kSpRow + kl] = val;
          }
      }
    }
    __syncthreads();

    // 2. content scores, P and dS' of the warp's (anchor-head, m-tile)
    // items: item warp + kWarps it, m-tile item / AH, anchor-head item % AH
    if (kStage >= 1) {
      // bit kl: key key0 + kl is valid
      const unsigned kvalid = __ballot_sync(0xffffffffu, key0 + lane < n && km[key0 + lane] != 0);
#pragma unroll
      for (int it = 0; it < L::kItems; ++it) {
        const int item = warp + kWarps * it;
        const int mt = item / AH, ah = item - mt * AH;
        const long long head = (long long)b * AH + ah;
        const int ka = key0 + 16 * mt + g, kb = ka + 8;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < kHC / 32; ++p) {
          const uint4 klo = ld16(k + (head * n + ka) * kHC + 32 * p + 8 * t, ka < n);
          const uint4 khi = ld16(k + (head * n + kb) * kHC + 32 * p + 8 * t, kb < n);
          const uint4 vlo = ld16(v + (head * n + ka) * kHC + 32 * p + 8 * t, ka < n);
          const uint4 vhi = ld16(v + (head * n + kb) * kHC + 32 * p + 8 * t, kb < n);
          uint4 qb = make_uint4(0u, 0u, 0u, 0u), db = qb;
          if (g < kRows) {
            qb = *reinterpret_cast<const uint4*>(qd_s + qd_chunk<AH>(0, ah, g, 4 * p + t));
            db = *reinterpret_cast<const uint4*>(qd_s + qd_chunk<AH>(1, ah, g, 4 * p + t));
          }
          mma_bf16_x2(s, klo, khi, qb);
          mma_bf16_x2(dp, vlo, vhi, db);
        }
        // s[e], dp[e]: key 16 mt + g + 8 (e >> 1), row 2t + (e & 1).  P
        // goes in place of the positional score it was made from (read and
        // written by this lane alone), for the stores of phase 3
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = 2 * t + (e & 1);
          if (rr >= kRows) continue;
          const int kl = 16 * mt + 8 * (e >> 1) + g;
          float* spe = sp_s + ah * L::kSpHead + rr * L::kSpRow + kl;
          const float sv = (s[e] + *spe) * scale;
          const float pv = (kvalid >> kl) & 1u ? expf(sv - lse_s[ah * kRows + rr]) : 0.f;
          const float dsv = scale * pv * (dp[e] - dd_s[ah * kRows + rr]);
          ds_s[(rr * L::kAHP + ah) * L::kDsRow + kl] = __float2bfloat16(dsv);
          *spe = pv;
          if (with_sh) {
            const float4 f = geo_s[rr * kKeys + kl];
            dqw_acc[it][e & 1][0] += dsv * f.x;
            dqw_acc[it][e & 1][1] += dsv * f.y;
            dqw_acc[it][e & 1][2] += dsv * f.z;
          }
        }
      }
    }
    __syncthreads();

    // 3. the tile's P and dS' to device memory (16 bytes a thread), then
    // dqp and d_emb of row wr, channels c0 ..
    if (kStage >= 4) {
      // (which, row, anchor-head, 8-key chunk): P from the score buffer
      // (float32), dS' from its buffer
      for (int i = tid; i < 2 * kRows * AH * 4; i += kThreads) {
        const int ch = i & 3, ah = (i >> 2) % AH, rr = (i >> 2) / AH % kRows, which = i / (4 * AH * kRows);
        const int key = key0 + 8 * ch;
        if (row0 + rr >= n || key >= n) continue;
        uint4 val;
        if (which) {
          val = *reinterpret_cast<const uint4*>(ds_s + (rr * L::kAHP + ah) * L::kDsRow + 8 * ch);
        } else {
          const float* pe = sp_s + ah * L::kSpHead + rr * L::kSpRow + 8 * ch;
          const float4 lo = *reinterpret_cast<const float4*>(pe);
          const float4 hi = *reinterpret_cast<const float4*>(pe + 4);
          val = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                           pack_bf16(hi.z, hi.w));
        }
        bf16* dst = (which ? ds_out : p_out) + (((long long)b * AH + ah) * n + row0 + rr) * n + key;
        if (key + 8 <= n && (n & 7) == 0) {
          *reinterpret_cast<uint4*>(dst) = val;
        } else {  // a ragged key tail, or rows not 16-byte aligned
          const bf16* e = reinterpret_cast<const bf16*>(&val);
          for (int kk = 0; kk < 8 && key + kk < n; ++kk) dst[kk] = e[kk];
        }
      }
    }
    if (kStage >= 2) {
      const bf16* slab = slabs + wr * L::kSlab;
      const bf16* dsr = ds_s + wr * L::kAHP * L::kDsRow;
      uint32_t bd[L::kNT][4];  // dS'^T (keys x ah): keys 8 i .. 8 i + 7 in bd[nt][i]
#pragma unroll
      for (int nt = 0; nt < L::kNT; ++nt)
        ldmatrix_x4(bd[nt], dsr + (8 * nt + mr) * L::kDsRow + 8 * mi);
#pragma unroll
      for (int mc = 0; mc < L::kMC; ++mc)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a[4];  // slab^T: channels c0 + 16 mc .., keys 16 ks ..
          ldmatrix_x4_trans(a, slab + slab_chunk(16 * ks + (mi >> 1) * 8 + mr,
                                                 c0 / 8 + 2 * mc + (mi & 1)));
#pragma unroll
          for (int nt = 0; nt < L::kNT; ++nt)
            mma_bf16(dqp_acc[mc][nt], a[0], a[1], a[2], a[3], bd[nt][2 * ks],
                     bd[nt][2 * ks + 1]);
        }
      if (kStage >= 3) {
        const bool row_ok = row0 + wr < n;
        bf16* drow = demb + ((long long)b * n + row0 + wr) * n * kC;
#pragma unroll
        for (int km2 = 0; km2 < 2; ++km2) {  // keys 16 km2 ..
          uint32_t a16[4], a8[2];  // dS'^T (keys x ah)
          if constexpr (L::kK16)
            ldmatrix_x4_trans(a16, dsr + ((mi >> 1) * 8 + mr) * L::kDsRow
                                       + (2 * km2 + (mi & 1)) * 8);
          if constexpr (L::kK8)
            ldmatrix_x2_trans(a8, dsr + (16 * L::kK16 + mr) * L::kDsRow + (2 * km2 + (mi & 1)) * 8);
#pragma unroll
          for (int G = 0; G < L::kGroups; ++G) {  // n-tiles of 32 channels
            const int ch0 = c0 / 8 + 4 * G;  // first 16-byte chunk of the group
            uint32_t b16[4][2], b8[4];
            if constexpr (L::kK16) {
#pragma unroll
              for (int jp = 0; jp < 2; ++jp) {
                uint32_t r4[4];
                ldmatrix_x4_trans(r4, qp_s + qp_chunk<AH>(wr, (mi & 1) * 8 + mr,
                                                           ch0 + 2 * jp + (mi >> 1)));
                b16[2 * jp][0] = r4[0];
                b16[2 * jp][1] = r4[1];
                b16[2 * jp + 1][0] = r4[2];
                b16[2 * jp + 1][1] = r4[3];
              }
            }
            if constexpr (L::kK8)
              ldmatrix_x4_trans(b8, qp_s + qp_chunk<AH>(wr, 16 * L::kK16 + mr, ch0 + mi));
            float acc[4][4];
#pragma unroll
            for (int jn = 0; jn < 4; ++jn) {
              acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
              if constexpr (L::kK16)
                mma_bf16(acc[jn], a16[0], a16[1], a16[2], a16[3], b16[jn][0], b16[jn][1]);
              if constexpr (L::kK8) mma_k8(acc[jn], a8[0], a8[1], b8[jn]);
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const uint4 o = quad_transpose(pack_bf16(acc[0][2 * hh], acc[0][2 * hh + 1]),
                                             pack_bf16(acc[1][2 * hh], acc[1][2 * hh + 1]),
                                             pack_bf16(acc[2][2 * hh], acc[2][2 * hh + 1]),
                                             pack_bf16(acc[3][2 * hh], acc[3][2 * hh + 1]), t);
              const int key = key0 + 16 * km2 + 8 * hh + g;
              if (row_ok && key < n)
                __stcs(reinterpret_cast<uint4*>(drow + (long long)key * kC + (ch0 + t) * 8), o);
            }
          }
        }
      }
    }
  }

  // dqp: staged as [kRows][AH][kC] bf16 in the first slab buffer, then
  // stored 16 bytes a thread
  cp_async_wait<0>();
  __syncthreads();
  bf16* st = emb_s;
#pragma unroll
  for (int mc = 0; mc < L::kMC; ++mc)
#pragma unroll
    for (int nt = 0; nt < L::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ah = 8 * nt + 2 * t + (e & 1);
        if (ah < AH)
          st[(wr * AH + ah) * kC + c0 + 16 * mc + 8 * (e >> 1) + g] =
              __float2bfloat16(dqp_acc[mc][nt][e]);
      }
  __syncthreads();
  for (int i = tid; i < kRows * AH * kChunks; i += kThreads) {
    const int r = i / (AH * kChunks);
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dqp + ((long long)b * n + row0) * AH * kC + (long long)i * 8) =
          *reinterpret_cast<const uint4*>(st + i * 8);
  }
  if (with_sh) {
    // dqw: the sum over the keys (lanes g) of each item; the two m-tiles of
    // an anchor-head are two items, in two warps (or one, twice): two
    // addends onto the zeroed output, equal in either order
#pragma unroll
    for (int it = 0; it < L::kItems; ++it)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float val = dqw_acc[it][i][d];
          val += __shfl_xor_sync(0xffffffffu, val, 4);
          val += __shfl_xor_sync(0xffffffffu, val, 8);
          val += __shfl_xor_sync(0xffffffffu, val, 16);
          const int rr = 2 * t + i, ah = (warp + kWarps * it) % AH;
          if (g == 0 && rr < kRows && row0 + rr < n)
            atomicAdd(dqw + (((long long)b * 3 + d) * AH + ah) * n + row0 + rr, val);
        }
  }
}

// The shared memory of the (ah, hc, cc) kernel; 0 where none is built.
inline size_t smem_bytes(int ah, int hc, int cc) {
  if (hc != kHC || cc != kC) return 0;
  if (ah == 24) return Layout<24>::bytes;
  if (ah == 4) return Layout<4>::bytes;
  return 0;
}

// static: internal linkage, so that each library built from this header
// keeps its own record of the attribute below
template <int AH>
static int launch(const void* q, const void* k, const void* v, const void* qp,
                  const void* emb, const void* kmask, const void* qw, const void* pts,
                  const void* dout, const void* lse, const void* dd, void* p_out,
                  void* ds_out, void* dqp, void* demb, void* dqw, int batch, int n,
                  int pts_rows, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<AH>::bytes;
  static_assert(smem <= (size_t)kMaxSmem, "the plan fits a block");
  static bool attr = false;  // raised once per kernel instance
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        rpe_attention_bwd_tc_kernel<AH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int grid = batch * ((n + kRows - 1) / kRows);
  rpe_attention_bwd_tc_kernel<AH><<<grid, Layout<AH>::kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)qp, (const bf16*)emb,
      (const uint8_t*)kmask, (const float*)qw, (const float*)pts, (const bf16*)dout,
      (const float*)lse, (const float*)dd, (bf16*)p_out, (bf16*)ds_out, (bf16*)dqp,
      (bf16*)demb, (float*)dqw, n, pts_rows, scale);
  return (int)cudaGetLastError();
}

// K11 in the tc form where smem_bytes(ah, hc, cc) is non-zero;
// cudaErrorInvalidValue otherwise
inline int dispatch(const void* q, const void* k, const void* v, const void* qp,
                    const void* emb, const void* kmask, const void* qw, const void* pts,
                    const void* dout, const void* lse, const void* dd, void* p_out,
                    void* ds_out, void* dqp, void* demb, void* dqw, int batch, int ah, int n,
                    int hc, int cc, int pts_rows, float scale, cudaStream_t s) {
  if (smem_bytes(ah, hc, cc) == 0 || (qw != nullptr) != (dqw != nullptr))
    return (int)cudaErrorInvalidValue;
  if (ah == 24)
    return launch<24>(q, k, v, qp, emb, kmask, qw, pts, dout, lse, dd, p_out, ds_out, dqp,
                      demb, dqw, batch, n, pts_rows, scale, s);
  return launch<4>(q, k, v, qp, emb, kmask, qw, pts, dout, lse, dd, p_out, ds_out, dqp, demb,
                   dqw, batch, n, pts_rows, scale, s);
}

}  // namespace rpe_bwd_tc
}  // namespace se3et
