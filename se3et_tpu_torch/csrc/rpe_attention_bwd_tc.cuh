// K11's bf16 form ("tc"; AH 4 or 24 at head width 64 with C = 256 and at
// head width 32 with C = 128, each width its plan), included only by
// rpe_attention_bwd.cu.  For the scores s of K5, recomputed as K5
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
// 1.07 GB per launch at B = 2, N = 1024, C = 256 (0.54 GB each at C =
// 128), >= 0.64 ms on the card; P and dS' add 2 x 100 MB at AH = 24.  No
// float32 (B, AH, N, N) tensor and no float32 copy of the embedding is made.
//
// A block owns kRows query rows of one cloud and all AH anchor-heads, so
// each embedding row is read from device memory once and dqp[b, n] (AH x
// C float32) stays in registers for the whole key loop: at AH = 24 16
// warps, at AH = 4 8 warps, each a slice of one row's channels.  The plan
// of each width (WidthPlan): C, rows a block, keys a tile, k and v staged
// or not, rows padded or not -- at 64 4 rows of 32-key tiles (4 warps a
// row, 64 channels each, 48 dqp accumulators a lane at AH = 24), k and v
// read from L2; at 32 8 rows of 16-key tiles (a warp a row: 96 dqp
// accumulators a lane at AH = 24, 255 registers), each tile's k and v of every
// anchor-head staged in shared memory by cp.async during the previous
// tile's phase 3, and the geometry's and dS' query rows padded so that the
// rows 2t, 2t + 1 of a quad's lanes fall in distinct banks
// (scripts/probe_rpe_attention_bwd.py --head-width 32 chose it over 64's
// plan halved; PERF.md).  Per tile, with the next tile's slabs (kRows x
// kKeys keys x C) already on their way by cp.async (16 bytes a thread,
// evict-first in L2, chunks XOR-swizzled by key so ldmatrix reads them
// without bank conflicts), three phases between block barriers, every
// product on mma.sync with float32 sums:
// 1. positional, a warp per (row, 16-key m-tile): S_pos^T (16 keys x AH) =
//    slab (ldmatrix) . qp^T (ldmatrix of the row's resident qp), plus the
//    SH term, into a float32 score buffer; the row's SH geometry rinv *
//    d_yzx per key into a small table;
// 2. content, every warp: per (anchor-head, 16-key m-tile) item: S^T = k .
//    q^T and dP^T = v . dO^T (keys as M, the block's rows as N, k and v
//    read as A fragments from L2 or the staged tile, q and dO resident),
//    then P (in place of its positional score) and dS' (rounded to bf16
//    into a shared buffer), and dqw's sums in registers;
// 3. every warp: the tile's P and dS' to device memory in 16-byte stores;
//    then for its row and channels: dqp^T += slab^T (ldmatrix.trans) .
//    dS'^T, and d_emb (the tile's keys x its channels) = dS'^T
//    (ldmatrix.trans) . qp (ldmatrix.trans), the anchor-heads as K (16 +
//    an m16n8k8 step at AH = 24, one m16n8k8 step over 8 padded ones at AH
//    = 4), transposed within each quad of lanes so that each lane stores
//    16 contiguous bytes, once.
// dqw sums over the keys of each item; the m-tiles of an anchor-head (two
// at 32-key tiles) add their sums onto the zeroed output, and two addends
// onto zero give the same float32 in either order, so the form is
// deterministic.
// What bounds it (scripts/probe_rpe_attention_bwd.py): at AH = 4 the
// stream of the embedding and d_emb; at AH = 24 the content phase, which
// reads k and v from L2 once per kRows rows (~3 GB a launch at 64 against
// the embedding's 1.07).  RPE_BWD_TC_STAGE cuts the kernel for the
// probe's ablations: 0 positional scores only, 1 + the content phase
// (scores, P, dS'), 2 + dqp, 3 + d_emb, 4 (the form) + the P and dS'
// stores; RPE_BWD_TC_NO_CONTENT leaves out the content phase alone.
#pragma once

#include "async_copy.cuh"
#include "attention_common.cuh"

#ifndef RPE_BWD_TC_STAGE
#define RPE_BWD_TC_STAGE 4
#endif
#ifndef RPE_BWD_TC_WARPS24  // warps a block at AH = 24 at 64 (the probe also tries 8)
#define RPE_BWD_TC_WARPS24 16
#endif
#ifndef RPE_BWD_TC_NO_CONTENT  // the probe's ablation: the content phase left out
#define RPE_BWD_TC_NO_CONTENT 0
#endif
// head width 32's plan: query rows a block (4 or 8), keys a tile (16 or
// 32), k and v of a tile staged in shared memory (or read from L2), the
// geometry and dS' rows padded against bank conflicts, warps a block at AH
// = 24; the probe builds the others
#ifndef RPE_BWD_TC32_ROWS
#define RPE_BWD_TC32_ROWS 8
#endif
#ifndef RPE_BWD_TC32_KEYS
#define RPE_BWD_TC32_KEYS 16
#endif
#ifndef RPE_BWD_TC32_KV_SMEM
#define RPE_BWD_TC32_KV_SMEM 1
#endif
#ifndef RPE_BWD_TC32_PAD
#define RPE_BWD_TC32_PAD 1
#endif
#ifndef RPE_BWD_TC32_WARPS24  // warps a block at AH = 24 at 32
#define RPE_BWD_TC32_WARPS24 8
#endif

namespace se3et {
namespace rpe_bwd_tc {

using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;
constexpr float kSh1 = 0.48860251190291992f;  // sqrt(3 / (4 pi))
constexpr int kStage = RPE_BWD_TC_STAGE;
constexpr bool kContentPhase = RPE_BWD_TC_NO_CONTENT == 0;

// each head width its plan: the embedding width C, query rows a block and
// keys a tile (mirrored by the wrapper's rpe_attention.BWD_TC_PLANS)
template <int HC>
struct WidthPlan;
template <>
struct WidthPlan<64> {
  static constexpr int kC = 256, kRows = 4, kKeys = 32, kWarps24 = RPE_BWD_TC_WARPS24;
  static constexpr bool kKVSmem = false, kPad = false;
};
template <>
struct WidthPlan<32> {
  static constexpr int kC = 128, kRows = RPE_BWD_TC32_ROWS, kKeys = RPE_BWD_TC32_KEYS;
  static constexpr int kWarps24 = RPE_BWD_TC32_WARPS24;
  static constexpr bool kKVSmem = RPE_BWD_TC32_KV_SMEM != 0, kPad = RPE_BWD_TC32_PAD != 0;
};

template <int AH, int HC>
struct Layout {
  static constexpr int kC = WidthPlan<HC>::kC;
  static constexpr int kRows = WidthPlan<HC>::kRows;
  static constexpr int kKeys = WidthPlan<HC>::kKeys;
  static constexpr int kChunks = kC / 8;         // 16-byte chunks of an embedding row
  static constexpr int kMT = kKeys / 16;         // 16-key m-tiles of a tile
  static constexpr int kKC = kKeys / 8;          // 8-key chunks of a tile
  static constexpr int kKCShift = kKC == 4 ? 2 : 1;
  static constexpr int kPosWarps = kRows * kMT;  // phase 1: a warp per (row, m-tile)
  // at AH = 24 the plan's (at 64 16 warps, a block of 512 threads with 128
  // registers each; at 32 8 warps, one a row), at AH = 4 8 warps
  static constexpr int kWarps = AH >= 16 ? WidthPlan<HC>::kWarps24 : 8;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kContent = kMT * AH;      // phase 2: (m-tile, anchor-head) items a tile
  static constexpr int kItems = (kContent + kWarps - 1) / kWarps;  // a warp, of distinct heads
  static constexpr int kSlices = kWarps / kRows;   // phase 3: channel slices a row
  static constexpr int kSliceC = kC / kSlices;     // channels a slice
  static constexpr int kMC = kSliceC / 16;         // dqp^T m-tiles a warp
  static constexpr int kGroups = kSliceC / 32;     // d_emb groups of 4 n-tiles a warp
  static constexpr int kAHP = (AH + 7) / 8 * 8;  // anchor-heads padded to n-tiles of 8
  static constexpr int kNT = kAHP / 8;
  static constexpr bool kK16 = kAHP >= 16;       // d_emb: one m16n8k16 step over AH
  static constexpr bool kK8 = kAHP % 16 != 0;    // and one m16n8k8 step
  static constexpr int kSpRow = kKeys + 4;       // floats per (head, row): = 4 (mod 16)
  static constexpr int kSpHead = kRows * kSpRow + 4;  // = 4 (mod 16)
  static constexpr int kDsRow = kKeys + 8;       // bf16 per (row, head) of dS'
  // with kPad, the query rows of dS' 16 bytes apart more (so that a quad's
  // rows 2t, 2t + 1 fall in other banks) and the geometry's keys a float4
  static constexpr bool kPad = WidthPlan<HC>::kPad;
  static constexpr int kDsStride = kAHP * kDsRow + (kPad ? 8 : 0);  // bf16 a query row
  static constexpr int kGeoRow = kKeys + (kPad ? 1 : 0);            // float4 a query row
  static constexpr size_t kSlab = (size_t)kKeys * kC;  // bf16 of one (row, tile) slab
  static_assert(kKeys == 16 || kKeys == 32, "keys a tile");
  static_assert(kRows <= 8, "phase 2 takes the block's rows as the N of an m16n8 product");
  static_assert(kPosWarps <= kWarps && kWarps % kRows == 0 && kSliceC % 32 == 0,
                "warps of phases 1 and 3");
  static_assert((size_t)kRows * AH * kC <= 2 * kRows * kSlab, "dqp is staged in the slabs");
  // byte offsets of the shared-memory plan (mirrored by the wrapper's
  // rpe_attention.bwd_tc_smem_bytes)
  static constexpr size_t emb = 0;                                       // [2][kRows] slabs
  static constexpr size_t qp = emb + 2 * kRows * kSlab * 2;              // [kRows][kAHP][kC]
  static constexpr size_t qd = qp + (size_t)kRows * kAHP * kC * 2;       // [q, dO][AH][kRows][HC]
  static constexpr size_t sp = qd + 2 * (size_t)AH * kRows * HC * 2;     // [AH][kSpHead] f32
  static constexpr size_t ds = sp + (size_t)AH * kSpHead * 4;            // [kRows][kDsStride]
  static constexpr size_t geo = ds + (size_t)kRows * kDsStride * 2;      // [kRows][kGeoRow] float4
  static constexpr size_t qw = geo + (size_t)kRows * kGeoRow * 16;       // [kRows][3][AH] f32
  static constexpr size_t stats = qw + (size_t)kRows * 3 * AH * 4;       // lse, D [AH][kRows]
  static constexpr bool kKVSmem = WidthPlan<HC>::kKVSmem;
  static constexpr size_t kv = (stats + 2 * (size_t)AH * kRows * 4 + 15) & ~(size_t)15;
  // [k, v][AH][kKeys][HC] bf16 of one tile, where kKVSmem
  static constexpr size_t bytes =
      kKVSmem ? kv + 2 * (size_t)AH * kKeys * HC * 2 : stats + 2 * (size_t)AH * kRows * 4;
};

// element offsets of 16-byte chunks: an embedding slab's rows (keys) XOR
// their chunks by key & 7, qp's rows (anchor-heads) by ah & 7, the q / dO
// rows by the swizzle of their width: (row & 1) << 2 for 128-byte rows
// (head width 64), (row >> 1) & 3 for 64-byte rows (32)
template <int C>
__device__ __forceinline__ int slab_chunk(int key, int ch) {
  return key * C + ((ch ^ (key & 7)) << 3);
}
template <int AH, int HC>
__device__ __forceinline__ int qp_chunk(int r, int ah, int ch) {
  using L = Layout<AH, HC>;
  return (r * L::kAHP + ah) * L::kC + ((ch ^ (ah & 7)) << 3);
}
// element offset of dS' at (query row rr, anchor-head ah): kDsStride bf16
// a row, written so that it folds to the unpadded layout's expression
template <int AH, int HC>
__device__ __forceinline__ int ds_row(int rr, int ah) {
  using L = Layout<AH, HC>;
  constexpr int kRowPad = L::kDsStride - L::kAHP * L::kDsRow;  // 8 with kPad, else 0
  return (rr * L::kAHP + ah) * L::kDsRow + (kRowPad ? rr * kRowPad : 0);
}
template <int AH, int HC>
__device__ __forceinline__ int qd_chunk(int which, int ah, int r, int ch) {
  constexpr int kRows = Layout<AH, HC>::kRows;
  if constexpr (HC == 64)
    return ((which * AH + ah) * kRows + r) * HC + ((ch ^ ((r & 1) << 2)) << 3);
  else
    return ((which * AH + ah) * kRows + r) * HC + ((ch ^ ((r >> 1) & 3)) << 3);
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

// q, k, v (B, AH, N, HC) bf16; qp (B, N, AH, C); emb (B, N, N, C); kmask
// (B, N); qw (B, 3, AH, N) f32 rows (y, z, x) or null; pts (B, pts_rows, N)
// f32; dout (B, AH, N, HC) bf16; lse, dd (B, AH, N) f32; p_out, ds_out (B,
// AH, N, N) bf16; dqp as qp; demb as emb; dqw as qw, zeroed by the caller
// (null without qw).
template <int AH, int HC>
__global__ void __launch_bounds__(Layout<AH, HC>::kThreads, 1)
rpe_attention_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ qp,
                            const bf16* __restrict__ emb, const uint8_t* __restrict__ kmask,
                            const float* __restrict__ qw, const float* __restrict__ pts,
                            const bf16* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ dd, bf16* __restrict__ p_out,
                            bf16* __restrict__ ds_out, bf16* __restrict__ dqp,
                            bf16* __restrict__ demb, float* __restrict__ dqw, int n,
                            int pts_rows, float scale) {
  using L = Layout<AH, HC>;
  constexpr int kWarps = L::kWarps, kThreads = L::kThreads;
  constexpr int kRows = L::kRows, kKeys = L::kKeys, kC = L::kC, kChunks = L::kChunks;
  constexpr int kMT = L::kMT, kKC = L::kKC;
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
  bf16* kv_s = reinterpret_cast<bf16*>(bwd_smem + L::kv);

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

  // the slabs emb[b, row0 + r, key0 .. key0 + kKeys - 1, :] of tile j into
  // buffer j & 1, zero past n
  auto stage_emb = [&](int j) {
    bf16* dst = emb_s + (size_t)(j & 1) * kRows * L::kSlab;
    const int key0 = j * kKeys;
    for (int i = tid; i < kRows * kKeys * kChunks; i += kThreads) {
      const int r = i / (kKeys * kChunks), key = (i / kChunks) % kKeys, ch = i % kChunks;
      const bool ok = row0 + r < n && key0 + key < n;
      const bf16* src =
          ok ? emb + (((long long)b * n + row0 + r) * n + key0 + key) * kC + ch * 8 : emb;
      cp_async16_hint(dst + r * L::kSlab + slab_chunk<kC>(key, ch), src, ok, policy);
    }
    cp_async_commit();
  };
  stage_emb(0);
  // where kKVSmem: k and v of tile j's keys, every anchor-head, zero past n
  auto stage_kv = [&](int j) {
    constexpr int kRowChunks = HC / 8;
    const int key0 = j * kKeys;
    for (int i = tid; i < 2 * AH * kKeys * kRowChunks; i += kThreads) {
      const int ch = i % kRowChunks, key = (i / kRowChunks) % kKeys;
      const int ah = (i / (kRowChunks * kKeys)) % AH, which = i / (kRowChunks * kKeys * AH);
      const bool ok = key0 + key < n;
      const bf16* src = (which ? v : k) + (((long long)b * AH + ah) * n + key0 + key) * HC + ch * 8;
      cp_async16(kv_s + i * 8, ok ? src : k, ok);
    }
    cp_async_commit();
  };
  if constexpr (L::kKVSmem) stage_kv(0);

  // resident for the block: qp of its rows (zero past n and for the padded
  // anchor-heads), q and dO, the zero rows of dS' past AH, lse, D and qw
  for (int i = tid; i < kRows * L::kAHP * kChunks; i += kThreads) {
    const int r = i / (L::kAHP * kChunks), ah = (i / kChunks) % L::kAHP, ch = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && ah < AH)
      val = __ldg(reinterpret_cast<const uint4*>(
          qp + (((long long)b * n + row0 + r) * AH + ah) * kC + ch * 8));
    *reinterpret_cast<uint4*>(qp_s + qp_chunk<AH, HC>(r, ah, ch)) = val;
  }
  for (int i = tid; i < 2 * AH * kRows * (HC / 8); i += kThreads) {
    const int ch = i % (HC / 8), r = (i / (HC / 8)) % kRows;
    const int ah = (i / (HC / 8 * kRows)) % AH, which = i / (HC / 8 * kRows * AH);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = __ldg(reinterpret_cast<const uint4*>(
          (which ? dout : q) + (((long long)b * AH + ah) * n + row0 + r) * HC + ch * 8));
    *reinterpret_cast<uint4*>(qd_s + qd_chunk<AH, HC>(which, ah, r, ch)) = val;
  }
  if constexpr (L::kAHP > AH) {
    constexpr int kPadHeads = (L::kAHP - AH) * L::kDsRow;
    for (int i = tid; i < kRows * kPadHeads; i += kThreads)
      ds_s[ds_row<AH, HC>(i / kPadHeads, AH) + i % kPadHeads] = __float2bfloat16(0.f);
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
  const int pr = warp >> (kMT - 1), pm = warp & (kMT - 1);
  const int wr = warp / L::kSlices, c0 = (warp % L::kSlices) * L::kSliceC;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (with_sh && row0 + pr < n && warp < L::kPosWarps) {
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
    if (warp < L::kPosWarps) {
      const bf16* slab = slabs + pr * L::kSlab;
      float acc[L::kNT][4];
#pragma unroll
      for (int nt = 0; nt < L::kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kC / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, slab + slab_chunk<kC>(16 * pm + (mi & 1) * 8 + mr, 2 * kk + (mi >> 1)));
        uint32_t bq[L::kNT][2];
#pragma unroll
        for (int nt = 0; nt + 1 < L::kNT; nt += 2) {
          uint32_t r4[4];
          ldmatrix_x4(r4, qp_s + qp_chunk<AH, HC>(pr, 8 * (nt + (mi >> 1)) + mr,
                                                   2 * kk + (mi & 1)));
          bq[nt][0] = r4[0];
          bq[nt][1] = r4[1];
          bq[nt + 1][0] = r4[2];
          bq[nt + 1][1] = r4[3];
        }
        if (L::kNT & 1)
          ldmatrix_x2(bq[L::kNT - 1],
                      qp_s + qp_chunk<AH, HC>(pr, 8 * (L::kNT - 1) + mr, 2 * kk + (mi & 1)));
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
        if (with_sh && t == 0) geo_s[pr * L::kGeoRow + kl] = make_float4(fy, fz, fx, 0.f);
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
    if (kStage >= 1 && kContentPhase) {
      // bit kl: key key0 + kl is valid
      const unsigned kvalid = __ballot_sync(0xffffffffu, key0 + lane < n && km[key0 + lane] != 0);
#pragma unroll
      for (int it = 0; it < L::kItems; ++it) {
        const int item = warp + kWarps * it;
        if (L::kContent % kWarps != 0 && item >= L::kContent) break;  // warp-uniform
        const int mt = item / AH, ah = item - mt * AH;
        const long long head = (long long)b * AH + ah;
        const int ka = key0 + 16 * mt + g, kb = ka + 8;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < HC / 32; ++p) {
          uint4 klo, khi, vlo, vhi;
          if constexpr (L::kKVSmem) {
            const bf16* kr = kv_s + ((size_t)ah * kKeys + 16 * mt + g) * HC + 32 * p + 8 * t;
            const bf16* vr = kr + (size_t)AH * kKeys * HC;
            klo = *reinterpret_cast<const uint4*>(kr);
            khi = *reinterpret_cast<const uint4*>(kr + 8 * HC);
            vlo = *reinterpret_cast<const uint4*>(vr);
            vhi = *reinterpret_cast<const uint4*>(vr + 8 * HC);
          } else {
            klo = ld16(k + (head * n + ka) * HC + 32 * p + 8 * t, ka < n);
            khi = ld16(k + (head * n + kb) * HC + 32 * p + 8 * t, kb < n);
            vlo = ld16(v + (head * n + ka) * HC + 32 * p + 8 * t, ka < n);
            vhi = ld16(v + (head * n + kb) * HC + 32 * p + 8 * t, kb < n);
          }
          uint4 qb = make_uint4(0u, 0u, 0u, 0u), db = qb;
          if (g < kRows) {
            qb = *reinterpret_cast<const uint4*>(qd_s + qd_chunk<AH, HC>(0, ah, g, 4 * p + t));
            db = *reinterpret_cast<const uint4*>(qd_s + qd_chunk<AH, HC>(1, ah, g, 4 * p + t));
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
          ds_s[ds_row<AH, HC>(rr, ah) + kl] = __float2bfloat16(dsv);
          *spe = pv;
          if (with_sh) {
            const float4 f = geo_s[rr * L::kGeoRow + kl];
            dqw_acc[it][e & 1][0] += dsv * f.x;
            dqw_acc[it][e & 1][1] += dsv * f.y;
            dqw_acc[it][e & 1][2] += dsv * f.z;
          }
        }
      }
    }
    __syncthreads();
    // the next tile's k and v, landing during phase 3 and the next phase 1
    if constexpr (L::kKVSmem)
      if (j + 1 < ntiles) stage_kv(j + 1);

    // 3. the tile's P and dS' to device memory (16 bytes a thread), then
    // dqp and d_emb of row wr, channels c0 ..
    if (kStage >= 4) {
      // (which, row, anchor-head, 8-key chunk): P from the score buffer
      // (float32), dS' from its buffer
      for (int i = tid; i < 2 * kRows * AH * kKC; i += kThreads) {
        const int ch = i & (kKC - 1), ah = (i >> L::kKCShift) % AH;
        const int rr = (i >> L::kKCShift) / AH % kRows, which = i / (kKC * AH * kRows);
        const int key = key0 + 8 * ch;
        if (row0 + rr >= n || key >= n) continue;
        uint4 val;
        if (which) {
          val = *reinterpret_cast<const uint4*>(ds_s + ds_row<AH, HC>(rr, ah) + 8 * ch);
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
      const bf16* dsr = ds_s + ds_row<AH, HC>(wr, 0);
      uint32_t bd[L::kNT][2 * kMT];  // dS'^T (keys x ah): keys 8 i .. 8 i + 7 in bd[nt][i]
#pragma unroll
      for (int nt = 0; nt < L::kNT; ++nt) {
        if constexpr (kMT == 2)
          ldmatrix_x4(bd[nt], dsr + (8 * nt + mr) * L::kDsRow + 8 * mi);
        else
          ldmatrix_x2(bd[nt], dsr + (8 * nt + mr) * L::kDsRow + 8 * (mi & 1));
      }
#pragma unroll
      for (int mc = 0; mc < L::kMC; ++mc)
#pragma unroll
        for (int ks = 0; ks < kMT; ++ks) {
          uint32_t a[4];  // slab^T: channels c0 + 16 mc .., keys 16 ks ..
          ldmatrix_x4_trans(a, slab + slab_chunk<kC>(16 * ks + (mi >> 1) * 8 + mr,
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
        for (int km2 = 0; km2 < kMT; ++km2) {  // keys 16 km2 ..
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
                ldmatrix_x4_trans(r4, qp_s + qp_chunk<AH, HC>(wr, (mi & 1) * 8 + mr,
                                                               ch0 + 2 * jp + (mi >> 1)));
                b16[2 * jp][0] = r4[0];
                b16[2 * jp][1] = r4[1];
                b16[2 * jp + 1][0] = r4[2];
                b16[2 * jp + 1][1] = r4[3];
              }
            }
            if constexpr (L::kK8)
              ldmatrix_x4_trans(b8, qp_s + qp_chunk<AH, HC>(wr, 16 * L::kK16 + mr, ch0 + mi));
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

  // dqp: staged as [kRows][AH][kC] bf16 in the slab buffers, then stored
  // 16 bytes a thread
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
    // dqw: the sum over the keys (lanes g) of each item; the m-tiles of an
    // anchor-head are items in distinct warps (or one warp's, in turn):
    // at most two addends onto the zeroed output, equal in either order
#pragma unroll
    for (int it = 0; it < L::kItems; ++it) {
      if (L::kContent % kWarps != 0 && warp + kWarps * it >= L::kContent) break;
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
}

// The shared memory of the (ah, hc, cc) kernel; 0 where none is built.
inline size_t smem_bytes(int ah, int hc, int cc) {
  if (ah != 24 && ah != 4) return 0;
  if (hc == 64 && cc == WidthPlan<64>::kC)
    return ah == 24 ? Layout<24, 64>::bytes : Layout<4, 64>::bytes;
  if (hc == 32 && cc == WidthPlan<32>::kC)
    return ah == 24 ? Layout<24, 32>::bytes : Layout<4, 32>::bytes;
  return 0;
}

// static: internal linkage, so that each library built from this header
// keeps its own record of the attribute below
template <int AH, int HC>
static int launch(const void* q, const void* k, const void* v, const void* qp,
                  const void* emb, const void* kmask, const void* qw, const void* pts,
                  const void* dout, const void* lse, const void* dd, void* p_out,
                  void* ds_out, void* dqp, void* demb, void* dqw, int batch, int n,
                  int pts_rows, float scale, cudaStream_t stream) {
  using L = Layout<AH, HC>;
  constexpr size_t smem = L::bytes;
  static_assert(smem <= (size_t)kMaxSmem, "the plan fits a block");
  static bool attr = false;  // raised once per kernel instance
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        rpe_attention_bwd_tc_kernel<AH, HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int grid = batch * ((n + L::kRows - 1) / L::kRows);
  rpe_attention_bwd_tc_kernel<AH, HC><<<grid, L::kThreads, smem, stream>>>(
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
#define SE3ET_K11_TC(AH_, HC_)                                                              \
  if (ah == AH_ && hc == HC_)                                                               \
    return launch<AH_, HC_>(q, k, v, qp, emb, kmask, qw, pts, dout, lse, dd, p_out, ds_out, \
                            dqp, demb, dqw, batch, n, pts_rows, scale, s);
  SE3ET_K11_TC(24, 64)
  SE3ET_K11_TC(4, 64)
  SE3ET_K11_TC(24, 32)
  SE3ET_K11_TC(4, 32)
#undef SE3ET_K11_TC
  return (int)cudaErrorInvalidValue;
}

}  // namespace rpe_bwd_tc
}  // namespace se3et
