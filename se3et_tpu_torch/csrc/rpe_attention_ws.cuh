// K5's bf16 serving form ("ws", warp-specialised; head widths 64 and 32,
// C % 32 == 0), included only by rpe_attention.cu.  Same function as the
// kernels of rpe_attention_core.cuh (the formula and the semantics are
// stated there): rinv = 0 where n == m by index, masked keys get -1e9 by
// selection and p = 0, p is rounded to bf16 before p.v, and the row
// log-sum-exp is written where lse is not null.
//
// Bound: bytes.  At the serving shape (B = 2, N = 1024, C = 256) the
// embedding is 1.07 GB per launch against ~40 MB of everything else: the
// card needs >= 0.32 ms, and the whole job is to keep device memory
// streaming.
//
// A block owns 16 query rows of one cloud and all AH anchor-heads (grid
// B x ceil(N / 16), one block per SM), so each emb[b,n,m,:] row is read from
// device memory once.  Its warps keep one role for the whole kernel, with
// no block barrier inside the key loop:
// * warp 0, the producer: one lane streams the embedding as 1-D bulk copies
//   (evict-first in L2) of the contiguous slab emb[b, n, key0:key0+32, :]
//   (16 KB at C = 256), one per (key tile, query row), tile-major, each with
//   its row's folded queries qp[b, n] (AH x C, 12 KB at AH = 24), into a
//   ring with full / empty mbarriers, one slot per positional warp (5 at
//   AH = 4, 3 at AH = 24).  A ragged last tile copies only its valid keys;
//   the rest of the slab is stale, and those keys are masked by selection.
// * warps 1..kPosWarps, positional: slab by slab (each owns a ring slot and
//   takes every kPosWarps-th slab), the scores S^T (32 keys x AH) = slab
//   (A) . qp[b,n]^T (B), both from shared memory, on the tensor cores
//   (mma.sync m16n8k16), plus the SH term, into the score buffer of the
//   slab's tile: float32 [16 rows][AH][32 keys], two buffers with full /
//   empty mbarriers, so tile j+1's scores are written while tile j's are
//   read.  Keys are XOR-swizzled by anchor-head pair, so both the fragment
//   stores and the flash warps' float2 reads are free of bank conflicts.
// * the last kFlashWarps warps, flash: per tile and anchor-head, the content
//   scores q . k on the tensor cores, plus the positional scores, the
//   masked online softmax and p . v, with each v tile staged by cp.async
//   one head ahead.  AH = 24: three heads per warp; AH = 4: two warps per
//   head, each over 16 keys of every tile, merged at the end.
// What bounds it at head width 64: at AH = 4, device memory (the stream
// runs near a plain copy's rate); at AH = 24, L2, which carries qp once per
// (row, key tile), k and v once per (row block, key tile, head) and q as
// often: ~2.9 GB per launch against the embedding's 1.07
// (scripts/probe_rpe_attention.py).
//
// Head width 32 (the wide-head family, C = 128) keeps the roles and the
// tiles with a plan of its own (Layout's kSlotsPerWarp, kGeoBuf,
// kQpResident, kQRegs; scripts/probe_rpe_attention.py --head-width 32
// measures each against 64's plan there).  The slabs halve (8 KB), and so
// does the positional warps' tensor-core work a slab, so what 64's plan
// leaves on their path shows: at AH = 24 they bound the kernel, and with
// the SH term its geometry (a square root and a division per (row, key))
// takes a third of their time.  So:
// * the flash warps, which have slack, form the geometry rinv * (p_n - p_m)
//   of tile j + 2's (row, key) pairs while they hold tile j, into one of
//   two shared float4 buffers [16 rows][32 keys]: the score buffers'
//   barriers order it (tile j + 2's scores wait for tile j's release), and
//   the positional warps only read it;
// * the ring holds two slots a positional warp, so a slab's copy is in
//   flight while the warp works on its previous one;
// * at AH = 4 the block's 16 rows of qp are copied to shared memory once
//   (the ring then carries only slabs), and one flash warp takes each head
//   over all 32 keys of a tile, so p rounds at the first design's running
//   maxima (AH = 24 has no room for 96 KB of resident qp beside two score
//   buffers; one buffer lost to 64's plan);
// * each flash warp keeps its heads' q fragments in registers (8 a head).
// A lost mbarrier arrival traps after seconds instead of hanging the card.
#pragma once

#include "async_copy.cuh"
#include "rpe_attention_core.cuh"

namespace se3et {
namespace rpe_ws {

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;        // query rows per block
constexpr int kKeys = 32;        // keys per tile: one slab per query row
constexpr int kFlashWarps = 8;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can have

// FW flash warps (K5: k5_flash, 4 at head width 32 and AH = 4, else
// kFlashWarps; K16's ws form, rpe_attention_femb_ws.cuh, takes 4 at AH = 4)
template <int AH, int HC, int FW = kFlashWarps>
struct Layout {
  // positional warps: 5 at AH = 4; 3 at AH = 24, so that the 12 warps of a
  // block get 168 registers each (14 get 128, and AH = 24's flash warps
  // spill there).  Each owns kSlotsPerWarp slots of the embedding ring (1
  // at 64, 2 at 32; slot k is the warp k % kPosWarps's): a slot's fills are
  // read in order by the one warp that owns it, which is what lets its
  // full / empty mbarriers be waited on by phase parity.
  static constexpr int kPosWarps = AH >= kFlashWarps ? 3 : 5;
  static constexpr int kSlotsPerWarp = HC == 32 ? 2 : 1;
  static constexpr int kSlots = kPosWarps * kSlotsPerWarp;
  static constexpr int kFlash = FW;
  static constexpr int kThreads = (1 + kPosWarps + FW) * 32;
  static_assert(AH % FW == 0 || FW % AH == 0, "AH vs the flash warps");
  static constexpr int kHeads = AH >= FW ? AH / FW : 1;  // per flash warp
  static constexpr int kSplit = AH >= FW ? 1 : FW / AH;  // flash warps per head
  static_assert(kSplit <= 2, "the end merge takes at most two warps per head");
  static constexpr int kWarpKeys = kKeys / kSplit;  // keys of a tile per flash warp
  static constexpr int kNT = (AH + 7) / 8;          // anchor-head n-tiles of a slab
  static constexpr int kRowStride = AH * kKeys + 8; // floats per score row, = 8 (mod 32)
  static constexpr int kScoreFloats = kRows * kRowStride;
  static constexpr int kVStride = HC + 8;           // bf16 per staged v row
  // head width 32's plan (the header): qp resident for the whole kernel
  // where it fits beside two score buffers (AH = 4); q fragments of every
  // head in registers
  static constexpr bool kQpResident = HC == 32 && AH < kFlashWarps;
  static constexpr bool kQRegs = HC == 32;
  // the SH geometry formed by the flash warps two tiles ahead into two
  // buffers (the header), where 64's positional warps form their own
  static constexpr bool kGeoBuf = HC == 32;
  static constexpr int kBars = 2 * kSlots + 4 + (kQpResident ? 1 : 0);
  // byte offsets of the shared-memory plan (mirrored by the wrapper's
  // rpe_attention.ws_smem_bytes); a ring slot holds the slab
  // emb[b, n, key0:key0+32, :] and, unless qp is resident, the row's folded
  // queries qp[b, n] (AH x C), all bf16
  __host__ __device__ static size_t slot_elems(int cc) {
    return (size_t)(kKeys + (kQpResident ? 0 : AH)) * cc;
  }
  __host__ __device__ static size_t qps(int cc) {  // the resident qp[b, row0:row0+16]
    return (size_t)kSlots * slot_elems(cc) * sizeof(bf16);
  }
  __host__ __device__ static size_t scores(int cc) {
    return qps(cc) + (kQpResident ? (size_t)kRows * AH * cc * sizeof(bf16) : 0);
  }
  __host__ __device__ static size_t vtiles(int cc) {
    return scores(cc) + 2 * (size_t)kScoreFloats * sizeof(float);
  }
  __host__ __device__ static size_t qws(int cc) {
    return vtiles(cc) + (size_t)FW * kWarpKeys * kVStride * sizeof(bf16);
  }
  __host__ __device__ static size_t geo(int cc) {
    return qws(cc) + (size_t)kRows * 3 * AH * sizeof(float);
  }
  __host__ __device__ static size_t bars(int cc) {
    return geo(cc) + (kGeoBuf ? 2 * (size_t)kRows * kKeys * sizeof(float4) : 0);
  }
  __host__ __device__ static size_t bytes(int cc) {
    return bars(cc) + kBars * sizeof(uint64_t);
  }
};

// flash warps of K5's kernel at (AH, HC): kFlashWarps; at head width 32 and
// AH = 4 one a head, over all 32 keys of a tile (no end merge, so p is
// rounded at the first design's running maxima)
template <int AH, int HC>
constexpr int k5_flash() { return HC == 32 && AH < kFlashWarps ? 4 : kFlashWarps; }
template <int AH, int HC>
using K5Layout = Layout<AH, HC, k5_flash<AH, HC>()>;

// float offset of (anchor-head ah, key kl) in a score row
__device__ __forceinline__ int score_col(int ah, int kl) {
  return ah * kKeys + (kl ^ (((ah >> 1) & 3) << 3));
}

// the SH term's geometry of query row `row` and key `key` (points pb, rows
// x, y, z of n): rinv * (p_row - p_key) with rinv = sqrt(3/4pi) / (|d| +
// 1e-12), 0 where key == row, and 0 past n
__device__ __forceinline__ float3 sh_geometry(const float* __restrict__ pb, int n, int row,
                                              int key) {
  if (key >= n) return make_float3(0.f, 0.f, 0.f);
  const float dx = pb[row] - pb[key];
  const float dy = pb[n + row] - pb[n + key];
  const float dz = pb[2 * n + row] - pb[2 * n + key];
  const float rr2 = sqrtf(dx * dx + dy * dy + dz * dz);
  const float rinv = (key == row) ? 0.f : rpe::kSh1 / (rr2 + 1e-12f);
  return make_float3(rinv * dx, rinv * dy, rinv * dz);
}

// tile j's geometry for the block's rows row0 .. row0 + nr - 1 into geo
// ([kRows][kKeys] float4), thread `tid` of `nthreads`
__device__ __forceinline__ void tile_geometry(const float* __restrict__ pb, int n, int row0,
                                              int nr, int j, float4* geo, int tid,
                                              int nthreads) {
  for (int i = tid; i < nr * kKeys; i += nthreads) {
    const int r = i / kKeys, kl = i - r * kKeys;
    const float3 f = sh_geometry(pb, n, row0 + r, j * kKeys + kl);
    geo[i] = make_float4(f.x, f.y, f.z, 0.f);
  }
}

// flash()'s look-ahead beside K5's SH geometry: none (kActive false, the
// default).  K16's ws form at head width 32 passes one that forms its pair
// geometry two tiles ahead (rpe_attention_femb_ws.cuh's FembAhead).
struct NoAhead {
  static constexpr bool kActive = false;
  __device__ __forceinline__ void operator()(int, int, int, int) const {}
};

// producer: every (tile, row) slab of the block, tile-major, with its row's
// folded queries unless those are resident (then copied once, first, to
// qp_s under qp_full); slab s goes to slot s % nsl (nsl slots in use, a
// multiple of the positional warps with slabs), read by positional warp
// s % npw
template <int AH, int HC>
__device__ __forceinline__ void produce(const bf16* eb, const bf16* qpb, int n, int cc,
                                        int nr, int nsl, int total, bf16* ring, bf16* qp_s,
                                        uint64_t* full, uint64_t* empty, uint64_t* qp_full) {
  using L = K5Layout<AH, HC>;
  const uint64_t policy = evict_first_policy();
  const uint32_t qp_bytes = (uint32_t)(AH * cc * (int)sizeof(bf16));
  if constexpr (L::kQpResident) {
    mbar_expect_tx(qp_full, (uint32_t)nr * qp_bytes);
    for (int r = 0; r < nr; ++r)
      bulk_load(qp_s + (size_t)r * AH * cc, qpb + (long long)r * AH * cc, qp_bytes, qp_full);
  }
  for (int s = 0; s < total; ++s) {
    const int slot = s % nsl;
    if (s >= nsl) mbar_wait_or_trap(&empty[slot], ((s / nsl) - 1) & 1, 0);
    const int j = s / nr, r = s - j * nr;
    const int key0 = j * kKeys;
    const uint32_t bytes = (uint32_t)(min(kKeys, n - key0) * cc * (int)sizeof(bf16));
    bf16* dst = ring + (size_t)slot * L::slot_elems(cc);
    mbar_expect_tx(&full[slot], bytes + (L::kQpResident ? 0u : qp_bytes));
    bulk_load(dst, eb + ((long long)r * n + key0) * cc, bytes, &full[slot], policy);
    if constexpr (!L::kQpResident)
      bulk_load(dst + kKeys * cc, qpb + (long long)r * AH * cc, qp_bytes, &full[slot]);
  }
}

// positional warp pw < npw: slabs pw, pw + npw, ... from slots pw, pw +
// npw, ... (nsl in use, read in turn).  With npw <= nr the warp has a slab
// in every tile, so it waits for the release of tile j - 2 only after that
// of tile j - 4: one phase at a time.
template <int AH, int HC, int FW>
__device__ __forceinline__ void positional(int pw, int lane, int b, int row0, int nr, int npw,
                                           int nsl, int n, int cc, int total,
                                           const float* __restrict__ pb, const float* qw_s,
                                           const bf16* ring, const bf16* qp_s, float* sp,
                                           const float4* geo, uint64_t* full, uint64_t* empty,
                                           uint64_t* sfull, uint64_t* sempty,
                                           uint64_t* qp_full) {
  using L = Layout<AH, HC, FW>;
  constexpr int kNT = L::kNT;
  const int g = lane >> 2, t = lane & 3;
  const bool with_sh = pb != nullptr;
  if constexpr (L::kQpResident) mbar_wait_or_trap(qp_full, 0, 4);
  for (int s = pw; s < total; s += npw) {
    const int j = s / nr, r = s - j * nr, slot = s % nsl;
    const int row = row0 + r, key0 = j * kKeys, buf = j & 1;
    float acc[2][kNT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    const bf16* slab = ring + (size_t)slot * L::slot_elems(cc);
    const bf16* qps = L::kQpResident ? qp_s + (size_t)r * AH * cc : slab + kKeys * cc;
    mbar_wait_or_trap(&full[slot], (s / nsl) & 1, 1);
#pragma unroll 2
    for (int c0 = 0; c0 < cc; c0 += 32) {
      uint4 ua[2][2], ub[kNT];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int ah = 8 * nt + g;
        ub[nt] = ah < AH ? *reinterpret_cast<const uint4*>(qps + ah * cc + c0 + 8 * t)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          ua[mt][hh] = *reinterpret_cast<const uint4*>(slab + (16 * mt + 8 * hh + g) * cc + c0
                                                       + 8 * t);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_bf16_x2(acc[mt][nt], ua[mt][0], ua[mt][1], ub[nt]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // the slab is read

    const float* qwr = qw_s + r * 3 * AH;
    float* sprow = sp + buf * L::kScoreFloats + r * L::kRowStride;
    // tile j - 2 is read (and, with kGeoBuf, tile j's geometry written)
    if (j >= 2) mbar_wait_or_trap(&sempty[buf], ((j >> 1) - 1) & 1, 2);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kl = 16 * mt + 8 * hh + g;
        float3 f = make_float3(0.f, 0.f, 0.f);
        if (with_sh) {
          if constexpr (L::kGeoBuf) {
            const float4 f4 = geo[(buf * kRows + r) * kKeys + kl];
            f = make_float3(f4.x, f4.y, f4.z);
          } else {
            f = sh_geometry(pb, n, row, key0 + kl);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int ah = 8 * nt + 2 * t + i;
            if (ah >= AH) continue;
            float val = acc[mt][nt][2 * hh + i];
            if (with_sh) val += qwr[ah] * f.y + qwr[AH + ah] * f.z + qwr[2 * AH + ah] * f.x;
            sprow[score_col(ah, kl)] = val;
          }
      }
    __syncwarp();
    mbar_arrive(&sfull[buf]);  // every lane: its scores are written
  }
}

// flash warp fw of FW; with the layout's kGeoBuf and the SH term (points
// pb), each tile j also forms tile j + 2's geometry for the block's nr rows
// into geo, before tile j's release; with an active look-ahead (Ahead's
// kActive), each tile j calls it for tile j + 2 at the same point
template <int AH, int HC, int FW = kFlashWarps, class Ahead = NoAhead>
__device__ __forceinline__ void flash(int fw, int lane, int b, int row0, int n, int ntiles,
                                      const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v,
                                      const uint8_t* __restrict__ km, const float* sp,
                                      bf16* my_v, float* xch, uint64_t* sfull,
                                      uint64_t* sempty, float* __restrict__ out,
                                      float* __restrict__ lse, float scale,
                                      const float* __restrict__ pb = nullptr, int nr = 0,
                                      float4* geo = nullptr, const Ahead ahead = Ahead{}) {
  using L = Layout<AH, HC, FW>;
  constexpr int kHeads = L::kHeads, NK = L::kWarpKeys, NJ = NK / 8;
  constexpr int kRS = L::kRowStride;
  constexpr int kQH = L::kQRegs ? kHeads : 1;  // heads whose q fragments stay in registers
  const int g = lane >> 2, t = lane & 3;
  const int ra = row0 + g, rb = ra + 8;
  const int koff = L::kSplit > 1 ? (fw / AH) * NK : 0;  // this warp's keys of a tile
  auto head_of = [&](int i) { return L::kSplit > 1 ? fw % AH : fw + FW * i; };
  auto stage_v = [&](int i, int key0) {
    stage_rows_async<HC, NK>(v + ((long long)b * AH + head_of(i)) * n * HC, n,
                             key0 + koff, my_v, L::kVStride, lane, 32);
    cp_async_commit();
  };

  float o[kHeads][HC / 8][4], mrun[kHeads][2], lrun[kHeads][2];
#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
#pragma unroll
    for (int jn = 0; jn < HC / 8; ++jn) o[i][jn][0] = o[i][jn][1] = o[i][jn][2] = o[i][jn][3] = 0.f;
    mrun[i][0] = mrun[i][1] = __int_as_float(0xff800000);  // -inf
    lrun[i][0] = lrun[i][1] = 0.f;
  }
  uint4 qf[kQH][HC / 32][2];
#pragma unroll
  for (int i = 0; i < kQH; ++i)
    if (L::kQRegs || kHeads == 1)
      load_q<HC>(q + ((long long)b * AH + head_of(i)) * n * HC, n, ra, rb, t, qf[i]);
  stage_v(0, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1, key0 = j * kKeys;
    const float* sb = sp + buf * L::kScoreFloats;
    mbar_wait_or_trap(&sfull[buf], (j >> 1) & 1, 3);
    if constexpr (L::kGeoBuf)
      if (pb != nullptr && j + 2 < ntiles)
        tile_geometry(pb, n, row0, nr, j + 2, geo + buf * kRows * kKeys, fw * 32 + lane,
                      FW * 32);
    if constexpr (Ahead::kActive)
      if (j + 2 < ntiles) ahead(j + 2, buf, fw * 32 + lane, FW * 32);
#pragma unroll
    for (int i = 0; i < kHeads; ++i) {
      const int ah = head_of(i);
      const long long head = (long long)b * AH + ah;
      if constexpr (!L::kQRegs && kHeads > 1) load_q<HC>(q + head * n * HC, n, ra, rb, t, qf[0]);
      float s[NJ][4];
      qk_tile<HC, NJ>(qf[L::kQRegs ? i : 0], k + head * n * HC, n, key0 + koff, g, t, s);
      float mxa = kNeg, mxb = kNeg;
      bool kv[NJ][2];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int kl = koff + 8 * jj + 2 * t;
        const float2 pa = *reinterpret_cast<const float2*>(sb + g * kRS + score_col(ah, kl));
        const float2 pbb =
            *reinterpret_cast<const float2*>(sb + (g + 8) * kRS + score_col(ah, kl));
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int key = key0 + kl + ii;
          kv[jj][ii] = key < n && km[key] != 0;
          const float va = (s[jj][ii] + (ii ? pa.y : pa.x)) * scale;
          const float vb = (s[jj][2 + ii] + (ii ? pbb.y : pbb.x)) * scale;
          s[jj][ii] = kv[jj][ii] ? va : kNeg;
          s[jj][2 + ii] = kv[jj][ii] ? vb : kNeg;
          mxa = fmaxf(mxa, s[jj][ii]);
          mxb = fmaxf(mxb, s[jj][2 + ii]);
        }
      }
      const float ma = fmaxf(mrun[i][0], quad_max(mxa));
      const float mb = fmaxf(mrun[i][1], quad_max(mxb));
      const float alpha_a = expf(mrun[i][0] - ma);
      const float alpha_b = expf(mrun[i][1] - mb);
      float suma = 0.f, sumb = 0.f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const float pa = kv[jj][ii] ? expf(s[jj][ii] - ma) : 0.f;
          const float pbv = kv[jj][ii] ? expf(s[jj][2 + ii] - mb) : 0.f;
          s[jj][ii] = pa;
          s[jj][2 + ii] = pbv;
          suma += pa;
          sumb += pbv;
        }
      lrun[i][0] = lrun[i][0] * alpha_a + suma;
      lrun[i][1] = lrun[i][1] * alpha_b + sumb;
      mrun[i][0] = ma;
      mrun[i][1] = mb;
#pragma unroll
      for (int jn = 0; jn < HC / 8; ++jn) {
        o[i][jn][0] *= alpha_a;
        o[i][jn][1] *= alpha_a;
        o[i][jn][2] *= alpha_b;
        o[i][jn][3] *= alpha_b;
      }
      cp_async_wait<0>();
      __syncwarp();  // this head's v tile has landed
      pv_tile<HC, NK>(s, my_v, L::kVStride, lane, o[i]);
      __syncwarp();  // before the next staging overwrites it
      if (i + 1 < kHeads)
        stage_v(i + 1, key0);
      else if (j + 1 < ntiles)
        stage_v(0, key0 + kKeys);
    }
    mbar_arrive(&sempty[buf]);  // every lane: tile j's scores are read
  }

  if constexpr (L::kSplit > 1) {
    // the second warp of a head hands its (max, partial sums, o) to the
    // first, lane by lane, through the ring (every slab has been read)
    constexpr int kState = HC / 2 + 4;  // floats per lane
    float* mine = xch + ((fw % AH) * 32 + lane) * kState;
    if (fw >= AH) {
#pragma unroll
      for (int jn = 0; jn < HC / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[4 * jn + e] = o[0][jn][e];
      mine[HC / 2] = mrun[0][0];
      mine[HC / 2 + 1] = mrun[0][1];
      mine[HC / 2 + 2] = lrun[0][0];
      mine[HC / 2 + 3] = lrun[0][1];
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(FW * 32) : "memory");
    if (fw >= AH) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m2 = mine[HC / 2 + h];
      const float m = fmaxf(mrun[0][h], m2);
      const float a1 = expf(mrun[0][h] - m), a2 = expf(m2 - m);
      lrun[0][h] = lrun[0][h] * a1 + mine[HC / 2 + 2 + h] * a2;
      mrun[0][h] = m;
#pragma unroll
      for (int jn = 0; jn < HC / 8; ++jn) {
        o[0][jn][2 * h] = o[0][jn][2 * h] * a1 + mine[4 * jn + 2 * h] * a2;
        o[0][jn][2 * h + 1] = o[0][jn][2 * h + 1] * a1 + mine[4 * jn + 2 * h + 1] * a2;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
    const int ah = head_of(i);
    const float la = fmaxf(quad_sum(lrun[i][0]), 1e-30f);
    const float lb = fmaxf(quad_sum(lrun[i][1]), 1e-30f);
    float* oh = out + ((long long)b * AH + ah) * n * HC;
#pragma unroll
    for (int jn = 0; jn < HC / 8; ++jn) {
      if (ra < n)
        *reinterpret_cast<float2*>(oh + (long long)ra * HC + 8 * jn + 2 * t) =
            make_float2(o[i][jn][0] / la, o[i][jn][1] / la);
      if (rb < n)
        *reinterpret_cast<float2*>(oh + (long long)rb * HC + 8 * jn + 2 * t) =
            make_float2(o[i][jn][2] / lb, o[i][jn][3] / lb);
    }
    if (lse != nullptr && t == 0) {
      float* lh = lse + ((long long)b * AH + ah) * n;
      if (ra < n) lh[ra] = mrun[i][0] + logf(la);
      if (rb < n) lh[rb] = mrun[i][1] + logf(lb);
    }
  }
}

// q, k, v (B, AH, N, HC); qp (B, N, AH, C); emb (B, N, N, C); kmask (B, N);
// qw (B, 3, AH, N) f32 rows (y, z, x) or null; pts (B, pts_rows, N) f32
// rows (x, y, z[, pad]); out (B, AH, N, HC) f32; lse (B, AH, N) f32 or null.
template <int AH, int HC>
__global__ void __launch_bounds__(K5Layout<AH, HC>::kThreads, 1)
rpe_attention_ws_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ qp,
                        const bf16* __restrict__ emb, const uint8_t* __restrict__ kmask,
                        const float* __restrict__ qw, const float* __restrict__ pts,
                        float* __restrict__ out, float* __restrict__ lse, int n, int cc,
                        int pts_rows, float scale) {
  using L = K5Layout<AH, HC>;
  extern __shared__ __align__(128) char ws_smem[];
  bf16* ring = reinterpret_cast<bf16*>(ws_smem);
  bf16* qp_s = reinterpret_cast<bf16*>(ws_smem + L::qps(cc));  // kQpResident
  float* sp = reinterpret_cast<float*>(ws_smem + L::scores(cc));
  bf16* vtiles = reinterpret_cast<bf16*>(ws_smem + L::vtiles(cc));
  float* qw_s = reinterpret_cast<float*>(ws_smem + L::qws(cc));
  float4* geo = reinterpret_cast<float4*>(ws_smem + L::geo(cc));  // kGeoBuf
  uint64_t* full = reinterpret_cast<uint64_t*>(ws_smem + L::bars(cc));
  uint64_t* empty = full + L::kSlots;
  uint64_t* sfull = empty + L::kSlots;  // [2]: a tile's scores are written
  uint64_t* sempty = sfull + 2;      // [2]: a tile's scores are read
  uint64_t* qp_full = sempty + 2;    // kQpResident: the block's qp has landed

  const int nblk = (n + kRows - 1) / kRows;
  const int b = blockIdx.x / nblk;
  const int row0 = (blockIdx.x - b * nblk) * kRows;
  const int nr = min(kRows, n - row0);  // query rows of this block
  const int ntiles = (n + kKeys - 1) / kKeys;
  const int total = ntiles * nr;  // slabs
  const int npw = min(L::kPosWarps, nr);  // positional warps with slabs
  const int nsl = npw * L::kSlotsPerWarp;  // ring slots in use
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool with_sh = qw != nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sfull[i], nr * 32);
      mbar_init(&sempty[i], L::kFlash * 32);
    }
    if (L::kQpResident) mbar_init(qp_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const float* pb = with_sh ? pts + (long long)b * pts_rows * n : nullptr;
  if (with_sh) {  // the block's SH queries, qw_s[r][d][ah] = qw[b, d, ah, row0 + r]
    const float* qwb = qw + (long long)b * 3 * AH * n;
    for (int i = threadIdx.x; i < nr * 3 * AH; i += L::kThreads) {
      const int r = i / (3 * AH), da = i - r * 3 * AH;
      qw_s[i] = qwb[(long long)da * n + row0 + r];
    }
    if constexpr (L::kGeoBuf)  // tiles 0 and 1's geometry; the flash warps form the rest
      for (int j = 0; j < 2 && j < ntiles; ++j)
        tile_geometry(pb, n, row0, nr, j, geo + j * kRows * kKeys, threadIdx.x, L::kThreads);
  }
  __syncthreads();

  if (warp == 0) {
    if (lane == 0)
      produce<AH, HC>(emb + ((long long)b * n + row0) * n * cc,
                      qp + ((long long)b * n + row0) * AH * cc, n, cc, nr, nsl, total, ring,
                      qp_s, full, empty, qp_full);
  } else if (warp <= L::kPosWarps) {
    if (warp <= npw)
      positional<AH, HC, L::kFlash>(warp - 1, lane, b, row0, nr, npw, nsl, n, cc, total, pb,
                                    qw_s, ring, qp_s, sp, geo, full, empty, sfull, sempty,
                                    qp_full);
  } else {
    const int fw = warp - 1 - L::kPosWarps;
    flash<AH, HC, L::kFlash>(fw, lane, b, row0, n, ntiles, q, k, v, kmask + (long long)b * n,
                             sp, vtiles + fw * L::kWarpKeys * L::kVStride,
                             reinterpret_cast<float*>(ring), sfull, sempty, out, lse, scale, pb,
                             nr, geo);
  }
}

// The shared memory of the (AH, HC) kernel at width cc; 0 where none is built.
inline size_t smem_bytes(int ah, int hc, int cc) {
  if ((hc != 64 && hc != 32) || cc % 32 != 0 || (ah != 24 && ah != 4)) return 0;
  if (hc == 64) return ah == 24 ? K5Layout<24, 64>::bytes(cc) : K5Layout<4, 64>::bytes(cc);
  return ah == 24 ? K5Layout<24, 32>::bytes(cc) : K5Layout<4, 32>::bytes(cc);
}

// static: internal linkage, so that each library built from this header
// keeps its own record of the attribute below
template <int AH, int HC>
static int launch(const void* q, const void* k, const void* v, const void* qp,
                  const void* emb, const void* kmask, const void* qw, const void* pts,
                  void* out, void* lse, int batch, int n, int cc, int pts_rows, float scale,
                  cudaStream_t stream) {
  const size_t smem = K5Layout<AH, HC>::bytes(cc);
  // the attribute is raised once per kernel instance and width (the port
  // serves on one card), not on every launch
  static size_t attr = 0;
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        rpe_attention_ws_kernel<AH, HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  const int grid = batch * ((n + kRows - 1) / kRows);
  rpe_attention_ws_kernel<AH, HC><<<grid, K5Layout<AH, HC>::kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)qp, (const bf16*)emb,
      (const uint8_t*)kmask, (const float*)qw, (const float*)pts, (float*)out, (float*)lse, n,
      cc, pts_rows, scale);
  return (int)cudaGetLastError();
}

// K5 in the ws form where smem_bytes(ah, hc, cc) is non-zero and fits;
// cudaErrorInvalidValue otherwise
inline int dispatch(const void* q, const void* k, const void* v, const void* qp,
                    const void* emb, const void* kmask, const void* qw, const void* pts,
                    void* out, void* lse, int batch, int ah, int n, int hc, int cc,
                    int pts_rows, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(ah, hc, cc);
  if (smem == 0 || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (hc == 64)
    return ah == 24 ? launch<24, 64>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, n, cc,
                                     pts_rows, scale, s)
                    : launch<4, 64>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, n, cc,
                                    pts_rows, scale, s);
  return ah == 24 ? launch<24, 32>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, n, cc,
                                   pts_rows, scale, s)
                  : launch<4, 32>(q, k, v, qp, emb, kmask, qw, pts, out, lse, batch, n, cc,
                                  pts_rows, scale, s);
}

}  // namespace rpe_ws
}  // namespace se3et
