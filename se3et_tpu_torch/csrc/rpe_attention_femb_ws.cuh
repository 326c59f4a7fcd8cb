// K16's bf16 serving form ("ws", warp-specialised; head widths 64 and 32,
// C % 32 == 0, AH 4 or 24), included only by rpe_attention_femb.cu.  Same
// function as the kernels of rpe_attention_core.cuh with the embedding rows
// of rpe_attention_femb.cu (the formula and the roundings are stated there).
//
// Bound: operations.  Per (query, key) pair the (40 + 3 x 16) x C
// projection MACs dominate: ~0.13 ms at AH = 24 at the bf16 tensor-core peak
// (B = 2, N = 1024, C = 256).  Beside the MACs, each (key, channel) element
// of the embedding takes a few CUDA-core instructions (the angle max, its
// rounding, the repack to bf16).
//
// A block owns 16 query rows of one cloud and all AH anchor-heads (grid B x
// ceil(N / 16)).  Its warps keep one role for the whole kernel, with no
// block barrier inside the key loop:
// * positional warps take the (key tile, query row) items of the block,
//   tile-major, in groups: at AH = 24 four pairs of warps, each warp one
//   16-key m-tile of its pair's item, at AH = 4 twelve single warps of whole
//   items.  Per item (32 keys of one row): each lane evaluates one key's
//   geometry against the row's (computed once per block into shared memory)
//   and writes its 40 + 3 x 16 bf16 basis terms to the group's basis rows
//   (K3's emb::key_basis); the warp loads the A fragments of its m-tiles
//   (ldmatrix); then per 16 channels it loads the B fragments of the folded
//   G (resident in shared memory for the whole block, rows in the
//   fragments' channel order, stride 72: ldmatrix without bank conflicts)
//   once for its m-tiles, runs the three angle projections on mma.sync,
//   takes their max rounded to bf16 as the start of the distance
//   projection's float32 sum (the products of the TPU kernel's chain, summed
//   in another order; its last 8 terms on m16n8k8, the 8 zeros of the
//   padding left out), repacks the sum as bf16 into the A fragment of the
//   positional product (the accumulator layout of m16n8k16 is its A layout)
//   and contracts it at once with qp[b, row], whose B fragments are 16 bytes
//   a lane of shared memory: each group streams its row's folded queries
//   through a ring of 32-channel chunks by cp.async, three chunks ahead, the
//   first ones behind the geometry (at AH = 24 a row's are 12 KB, and the
//   plan takes 229,920 of a block's 232,448 bytes; keeping all 16 rows'
//   resident at AH = 4 gained nothing).  The embedding never leaves
//   registers.  Scores plus the SH term (the key points by shuffle, the
//   next item's loaded during this one's geometry) go to the score buffer of
//   the item's tile, as K5's positional warps write them; each warp's lane
//   0 marks its part of the row written.
// * kFlash flash warps (8 at AH = 24, 4 at AH = 4) are K5's
//   (rpe_attention_ws.cuh rpe_ws::flash, its warp count a template
//   parameter): content scores on the tensor cores, masked online softmax,
//   p . v with v staged by cp.async, over the double-buffered float32 score
//   tiles behind full / empty mbarriers.
// Head width 32 (the wide-head family, C = 128) keeps the roles and the
// tiles with a plan of its own (Layout's kGeoAhead;
// scripts/probe_rpe_attention_femb.py --head-width 32 measures each against
// 64's plan there).  The projection halves with C, the per-key geometry
// does not: at AH = 24 64's plan spends ~0.19 of its positional warps'
// ~0.51 ms on the geometry and the basis rows, with half of each warp's
// lanes idle (a pair's warp owns 16 keys).  So at AH = 24:
// * the flash warps, which have slack, form tile j + 2's pair geometry
//   (distance, the KA angles, the SH term's rinv * (p_row - p_key)) for the
//   block's rows while they hold tile j, into one of two shared buffers
//   [16 rows][32 keys] x 2 float4 (rpe_ws::flash's look-ahead, FembAhead):
//   the score buffers' barriers order it, and a positional warp waits for
//   tile j - 2's release before it reads tile j's geometry;
// * a positional warp's 32 lanes build its 16 keys' basis rows, lanes 0-15
//   the distance terms and lanes 16-31 the angles', in one branch-free
//   sequence of 48 terms each (split_basis).
// AH = 4 keeps 64's plan: its 12 positional warps have all 32 lanes keyed,
// and its 4 flash warps, forming the geometry ahead, cost more than they
// saved.  More positional groups (20 warps, 96 registers a thread) spilled
// and gained nothing at either shape; the distance k-steps in accumulators
// of their own, beside the angle products, ran slower (more registers).
// mma.sync rather than wgmma: a form with positional warpgroups (64 pairs of
// two rows as wgmma's M, the projections m64n32k16 and m64n16k16 from basis
// and G tiles in shared memory without swizzle, the positional product from
// registers) was built and checked, and ran slower at both serving shapes:
// each warpgroup waits on its products before the epilogue can run, and one
// or two warpgroups a block leave nothing to fill the wait.
// A lost mbarrier arrival traps after seconds instead of hanging the card.
#pragma once

#include "embedding_tc.cuh"
#include "rpe_attention_ws.cuh"

namespace se3et {
namespace femb_ws {

using bf16 = __nv_bfloat16;
using rpe_ws::kFlashWarps;
using rpe_ws::kKeys;
using rpe_ws::kRows;

// floats per query row's geometry: q, |q|^2, the KA neighbour offsets' x, y, z
constexpr int kRowGeo = 16;

template <int AH, int HC>
struct Layout {
  // flash warps: K5's 8 at AH = 24 (three heads each, which need the 168
  // registers a thread that a block of 12 warps gets), 4 at AH = 4 (a head
  // each), so that 12 positional warps fit a block of 16
  static constexpr int kFlash = AH >= kFlashWarps ? kFlashWarps : 4;
  using Flash = rpe_ws::Layout<AH, HC, kFlash>;  // the flash warps' score tiles and v tiles
  // positional warps: at AH = 4, 12 of one item each (both 16-key m-tiles);
  // at AH = 24, 8 in pairs, each warp of a pair one m-tile of the pair's
  // item, so that two share a tensor-core pipe beside K5's flash warps (the
  // block of 16 warps gets 128 registers a thread; K5's flash warps spill a
  // little there)
  static constexpr int kMT = AH >= kFlashWarps ? 1 : 2;  // 16-key m-tiles a warp takes
  static constexpr int kItemWarps = 2 / kMT;             // warps an item takes
  static constexpr int kPosWarps = AH >= kFlashWarps ? 8 : 12;
  static constexpr int kGroups = kPosWarps / kItemWarps;  // items in flight
  static constexpr int kQpSlots = 4;  // 32-channel chunks of qp[b, row] in a group's ring
  static constexpr int kThreads = (kPosWarps + kFlash) * 32;
  // head width 32's plan (the header): at AH = 24 the flash warps form each
  // key tile's pair geometry two tiles ahead into two buffers, and all 32
  // lanes of a positional warp build its 16 keys' basis rows, distance and
  // angles apart; AH = 4 keeps 64's plan
  static constexpr bool kGeoAhead = HC == 32 && AH >= kFlashWarps;
  static_assert(!kGeoAhead || kMT == 1, "split_basis: a warp's 16 keys, two lanes a key");
  // byte offsets of the shared-memory plan (mirrored by the wrapper's
  // rpe_attention.femb_ws_smem_bytes): G (C rows of kGStride bf16), each
  // group's 32 basis rows and qp ring (kQpSlots x AH x 32 bf16), two score
  // buffers, the flash warps' v tiles, the block's SH queries and row
  // geometry, with kGeoAhead two buffers of pair geometry ([16 rows][32
  // keys] x 2 float4), four mbarriers
  __host__ __device__ static size_t basis(int cc) {
    return (size_t)cc * emb::kGStride * sizeof(bf16);
  }
  __host__ __device__ static size_t qring(int cc) {
    return basis(cc) + (size_t)kGroups * kKeys * emb::kBStride * sizeof(bf16);
  }
  __host__ __device__ static size_t scores(int cc) {
    return qring(cc) + (size_t)kGroups * kQpSlots * AH * 32 * sizeof(bf16);
  }
  __host__ __device__ static size_t vtiles(int cc) {
    return scores(cc) + 2 * (size_t)Flash::kScoreFloats * sizeof(float);
  }
  __host__ __device__ static size_t qws(int cc) {
    return vtiles(cc) + (size_t)kFlash * Flash::kWarpKeys * Flash::kVStride * sizeof(bf16);
  }
  __host__ __device__ static size_t rowgeo(int cc) {
    return qws(cc) + (size_t)kRows * 3 * AH * sizeof(float);
  }
  __host__ __device__ static size_t geo(int cc) {
    return rowgeo(cc) + (size_t)kRows * kRowGeo * sizeof(float);
  }
  __host__ __device__ static size_t bars(int cc) {
    return geo(cc) + (kGeoAhead ? 2 * (size_t)kRows * kKeys * 2 * sizeof(float4) : 0);
  }
  __host__ __device__ static size_t bytes(int cc) { return bars(cc) + 4 * sizeof(uint64_t); }
};

// d += a . b for a 16 x 8 bf16 A (rows g / g + 8, k-slots 2t, 2t + 1) and an
// 8 x 8 B (column g), float32 sums: mma.sync m16n8k8
__device__ __forceinline__ void mma_bf16_k8(float* d, uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The channel of G's shared row r: the rows of a 32-channel chunk are in
// the order of the positional product's k-slots (attention_common.cuh's
// permutation), so that n-block nb of the projection (rows 8 nb .. 8 nb + 7
// of the chunk) yields the A fragment of k-step nb / 2, low (nb even) or
// high (odd) slots, and qp's B fragments are 16 contiguous bytes a lane.
__device__ __forceinline__ int g_channel(int r) {
  const int nb = (r >> 3) & 3, g = r & 7;
  return (r & ~31) + 8 * (g >> 1) + 4 * (nb >> 1) + 2 * (nb & 1) + (g & 1);
}

// G, transposed (C x kDeg bf16), into shared rows of kGStride in g_channel order
__device__ __forceinline__ void load_g(bf16* sg, const bf16* gt, int cc) {
  constexpr int kParts = emb::kDeg / 8;
  for (int i = threadIdx.x; i < cc * kParts; i += blockDim.x) {
    const int r = i / kParts, part = i - r * kParts;
    *reinterpret_cast<uint4*>(sg + r * emb::kGStride + 8 * part) =
        __ldg(reinterpret_cast<const uint4*>(gt + g_channel(r) * emb::kDeg + 8 * part));
  }
}

// the key's point (zeros past the end)
__device__ __forceinline__ float3 key_point(const float* pts3b, int key, int n) {
  return key < n ? make_float3(pts3b[key * 3 + 0], pts3b[key * 3 + 1], pts3b[key * 3 + 2])
                 : make_float3(0.f, 0.f, 0.f);
}

// the kItemWarps warps of positional group grp (named barrier 2 + grp; K5's
// flash warps take barrier 1 only to merge two warps' halves of a head)
template <int W>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (W == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(2 + grp), "n"(W * 32) : "memory");
}

// head width 32: tile j's pair geometry for the block's nr rows, formed by
// the flash warps two tiles ahead (rpe_ws::flash's look-ahead) and by the
// whole block for tiles 0 and 1: per (row, key) two float4, (distance,
// angles 0-2) and the SH term's rinv * (p_row - p_key) (x, y, z, 0); every
// value 0 on the diagonal (by index) and past n.  The arithmetic of 64's
// positional warps.  kActive: the plan's kGeoAhead (rpe_ws::flash calls
// it only then).
template <bool kOn>
struct FembAhead {
  static constexpr bool kActive = kOn;
  const float* pts3b;
  const float* rowgeo;
  int n, row0, nr;
  bool with_sh;
  float4* geo;  // [2][kRows][kKeys][2]
  __device__ __forceinline__ void operator()(int j, int buf, int tid, int nthreads) const {
    float4* out = geo + buf * kRows * kKeys * 2;
    for (int i = tid; i < nr * kKeys; i += nthreads) {
      const int r = i / kKeys, key = j * kKeys + i - r * kKeys;
      const float* rg = rowgeo + r * kRowGeo;
      const float qx = rg[0], qy = rg[1], qz = rg[2];
      float dist = 0.f, ang[emb::kKA] = {0.f, 0.f, 0.f}, f[3] = {0.f, 0.f, 0.f};
      if (key != row0 + r && key < n) {
        const float3 kp = key_point(pts3b, key, n);
        dist = pair_distance(qx, qy, qz, rg[3], kp.x, kp.y, kp.z);
#pragma unroll
        for (int k = 0; k < emb::kKA; ++k)
          ang[k] = pair_angle(rg[4 + k], rg[4 + emb::kKA + k], rg[4 + 2 * emb::kKA + k],
                              kp.x - qx, kp.y - qy, kp.z - qz);
        if (with_sh) {
          const float dx = qx - kp.x, dy = qy - kp.y, dz = qz - kp.z;
          const float rinv = rpe::kSh1 / (sqrtf(dx * dx + dy * dy + dz * dz) + 1e-12f);
          f[0] = rinv * dx;
          f[1] = rinv * dy;
          f[2] = rinv * dz;
        }
      }
      out[2 * i] = make_float4(dist, ang[0], ang[1], ang[2]);
      out[2 * i + 1] = make_float4(f[0], f[1], f[2], 0.f);
    }
  }
};

// Half a key's basis row, by a lane of a pair that shares the key (K3's
// emb::key_basis split in two, both halves 48 terms in one branch-free
// sequence, so that the warp's two halves do not diverge): the distance
// lane runs one recurrence over the 40 distance terms and writes 8 zeros
// of padding after them; the angle lane restarts it at each of the KA
// angles, 16 terms each.  The terms are emb::cheb_basis_bf16's; zeros past
// the end.
__device__ __forceinline__ void split_basis(bool distance, bool valid, float4 pg, float inv_d,
                                            float inv_a, bf16* row) {
  static_assert(emb::kKA * emb::kDA == emb::kDDPad, "the two halves run alike");
  const float x[emb::kKA] = {distance ? pg.x : pg.y, pg.z, pg.w};
  bf16* dst = row + (distance ? 0 : emb::kDDPad);
  float prev = 1.f, cur = 0.f, two_t = 0.f;
#pragma unroll
  for (int seg = 0; seg < emb::kKA; ++seg) {
    if (seg == 0 || !distance) {
      const float t = fminf(fmaxf(x[seg] * (distance ? inv_d : inv_a) - 1.f, -1.f), 1.f);
      prev = 1.f;
      cur = t;
      two_t = 2.f * t;
    }
#pragma unroll
    for (int k = 0; k < emb::kDA; k += 2) {
      const bool keep = valid && !(distance && emb::kDA * seg + k >= emb::kDD);
      *reinterpret_cast<__nv_bfloat162*>(dst + emb::kDA * seg + k) =
          __floats2bfloat162_rn(keep ? prev : 0.f, keep ? cur : 0.f);
      const float nxt = two_t * cur - prev;
      prev = cur;
      cur = nxt;
      const float nxt2 = two_t * cur - prev;
      prev = cur;
      cur = nxt2;
    }
  }
}

// positional group grp < ngrp (its warp gw): items grp, grp + ngrp, ...
// (item s: key tile s / nr, query row s % nr of the block); the warp takes
// kMT m-tiles of the item's 32 keys, from key 16 kMT gw
template <int AH, int HC>
__device__ __forceinline__ void positional(
    int grp, int gw, int lane, int row0, int nr, int ngrp, int n, int cc, int total,
    const float* __restrict__ pts3b, bool with_sh, const bf16* __restrict__ qpb,
    const float* rowgeo, const float* qw_s, const bf16* sg, bf16* sbasis, bf16* qring,
    float inv_d, float inv_a, float* sp, const float4* geo, uint64_t* sfull,
    uint64_t* sempty) {
  using L = Layout<AH, HC>;
  using F = typename L::Flash;
  constexpr int kNT = F::kNT;
  constexpr int kMT = L::kMT;
  constexpr int W = L::kItemWarps;
  constexpr int kA = emb::kDDPad / 16;  // the angle k-steps' first slot in the A fragments
  constexpr int kSlots = L::kQpSlots;
  const int g = lane >> 2, t = lane & 3;
  const int nchunks = cc / 32;
  const int k16 = 16 * kMT * gw;  // this warp's first key of an item
  const bool keyed = lane < 16 * kMT;  // this lane has a key: k16 + lane
  bf16* mine = sbasis + (k16 + lane) * emb::kBStride;
  float3 next = key_point(pts3b, (grp / nr) * kKeys + k16 + lane, keyed ? n : 0);
  for (int s = grp; s < total; s += ngrp) {
    const int j = s / nr, r = s - j * nr;
    const int row = row0 + r, key0 = j * kKeys, buf = j & 1;
    const float* rg = rowgeo + r * kRowGeo;
    const float qx = rg[0], qy = rg[1], qz = rg[2];

    // 0. the row's folded queries, 32 channels a slot, into the group's
    //    ring (cp.async, one group a chunk; the geometry below hides the
    //    first)
    const bf16* qprow = qpb + (long long)row * AH * cc;
    auto issue = [&](int p) {
      if (p < nchunks) {
        bf16* dst = qring + (p % kSlots) * AH * 32;
        for (int i = 32 * gw + lane; i < AH * 4; i += 32 * W)
          cp_async16(dst + 8 * i, qprow + (i >> 2) * cc + 32 * p + 8 * (i & 3), true);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int p = 0; p + 1 < kSlots; ++p) issue(p);

    // 1. this lane's key: distance and angles against the row (0 on the
    //    diagonal, by index), its bases into the group's basis rows; the
    //    next item's key point is fetched meanwhile.  With kGeoAhead the
    //    flash warps formed the geometry (released with tile j - 2), and at
    //    AH = 24 lanes 0-15 build the distance terms of the warp's 16 keys,
    //    lanes 16-31 their angles'.
    const float4* pg = geo + (size_t)(buf * kRows + r) * kKeys * 2;
    if constexpr (L::kGeoAhead) {
      if (j >= 2) mbar_wait_or_trap(&sempty[buf], ((j >> 1) - 1) & 1, 2);
      __syncwarp();  // the previous item's basis rows are read
      const int kl = k16 + (lane & 15);
      split_basis(lane < 16, key0 + kl < n, pg[2 * kl], inv_d, inv_a,
                  sbasis + kl * emb::kBStride);
    }
    const float3 kp = next;
    if constexpr (!L::kGeoAhead)
      next = key_point(pts3b, ((s + ngrp) / nr) * kKeys + k16 + lane,
                       keyed && s + ngrp < total ? n : 0);
    if constexpr (!L::kGeoAhead) __syncwarp();  // the previous item's basis rows are read
    if (!L::kGeoAhead && keyed) {
      const int key = key0 + k16 + lane;
      float dist = 0.f, ang[emb::kKA] = {0.f, 0.f, 0.f};
      if (key < n && key != row) {
        dist = pair_distance(qx, qy, qz, rg[3], kp.x, kp.y, kp.z);
#pragma unroll
        for (int k = 0; k < emb::kKA; ++k)
          ang[k] = pair_angle(rg[4 + k], rg[4 + emb::kKA + k], rg[4 + 2 * emb::kKA + k],
                              kp.x - qx, kp.y - qy, kp.z - qz);
      }
      if (key < n)
        emb::key_basis(dist, ang, inv_d, inv_a, mine);
      else
        emb::zero_basis(mine);
    }
    __syncwarp();

    // 2. the A fragments of the warp's m-tiles: 3 distance k-steps, then the
    //    KA angles
    uint32_t fa[kMT][kA + emb::kKA][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int st = 0; st < kA + emb::kKA; ++st)
        ldmatrix_x4(fa[mt][st], sbasis + (k16 + 16 * mt + (lane & 15)) * emb::kBStride
                                    + 16 * st + 8 * (lane >> 4));

    // 3. per 16 channels: the embedding tile on the tensor cores, rounded to
    //    bf16, and at once its positional product with the AH folded queries
    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
#pragma unroll 1
    for (int p = 0; p < nchunks; ++p) {
      cp_async_wait<kSlots - 2>();
      group_sync<W>(grp);  // chunk p of qp has landed, from every lane's copies; the
                           // slot of chunk p - 1 is read
      issue(p + kSlots - 1);
      uint4 qf[kNT];  // B fragments of k-steps 2p (x, y) and 2p + 1 (z, w)
      const bf16* slot = qring + (p % kSlots) * AH * 32 + 8 * t;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        qf[nt] = 8 * nt + g < AH ? *reinterpret_cast<const uint4*>(slot + (8 * nt + g) * 32)
                                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t gb[2][8];  // n-blocks 2h, 2h + 1: k-steps 0-3 (b0, b1 each)
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const bf16* gr = sg + (32 * p + 8 * (2 * h + y) + (lane & 7)) * emb::kGStride
                           + 8 * (lane >> 3);
          ldmatrix_x4(gb[y], gr);
          ldmatrix_x4(gb[y] + 4, gr + 32);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          uint32_t ea[4];
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            float am[emb::kKA][4];
#pragma unroll
            for (int k = 0; k < emb::kKA; ++k) {
              am[k][0] = am[k][1] = am[k][2] = am[k][3] = 0.f;
              const uint32_t* a = fa[mt][kA + k];
              mma_bf16(am[k], a[0], a[1], a[2], a[3], gb[y][6], gb[y][7]);
            }
            // the angle max rounded to bf16, two values a conversion
            uint32_t mx[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              mx[i] = pack_bf16(fmaxf(fmaxf(am[0][2 * i], am[1][2 * i]), am[2][2 * i]),
                                fmaxf(fmaxf(am[0][2 * i + 1], am[1][2 * i + 1]),
                                      am[2][2 * i + 1]));
            float d[4] = {__uint_as_float(mx[0] << 16), __uint_as_float(mx[0] & 0xffff0000u),
                          __uint_as_float(mx[1] << 16), __uint_as_float(mx[1] & 0xffff0000u)};
            // the distance: terms 0-31 in two k-steps, 32-39 on m16n8k8 (40-47
            // are the zero padding)
#pragma unroll
            for (int st = 0; st + 1 < kA; ++st)
              mma_bf16(d, fa[mt][st][0], fa[mt][st][1], fa[mt][st][2], fa[mt][st][3],
                       gb[y][2 * st], gb[y][2 * st + 1]);
            mma_bf16_k8(d, fa[mt][kA - 1][0], fa[mt][kA - 1][1], gb[y][2 * (kA - 1)]);
            ea[2 * y] = pack_bf16(d[0], d[1]);
            ea[2 * y + 1] = pack_bf16(d[2], d[3]);
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            mma_bf16(acc[mt][nt], ea[0], ea[1], ea[2], ea[3], h ? qf[nt].z : qf[nt].x,
                     h ? qf[nt].w : qf[nt].y);
        }
      }
    }

    // 4. the SH term (the key points by shuffle from the lanes that hold
    //    them), and the scores into the tile's buffer (K5's layout)
    const float* qwr = qw_s + r * 3 * AH;
    float* sprow = sp + buf * F::kScoreFloats + r * F::kRowStride;
    float f[kMT][2][3] = {};  // [mt][hh]: rinv * (dx, dy, dz) of key 16 mt + 8 hh + g
#pragma unroll
    for (int mt = 0; mt < kMT && with_sh && L::kGeoAhead; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float4 v = pg[2 * (k16 + 16 * mt + 8 * hh + g) + 1];
        f[mt][hh][0] = v.x;
        f[mt][hh][1] = v.y;
        f[mt][hh][2] = v.z;
      }
#pragma unroll
    for (int mt = 0; mt < kMT && with_sh && !L::kGeoAhead; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kl = 16 * mt + 8 * hh + g;  // of the warp's keys
        const int key = key0 + k16 + kl;
        const float dx = qx - __shfl_sync(0xffffffffu, kp.x, kl);
        const float dy = qy - __shfl_sync(0xffffffffu, kp.y, kl);
        const float dz = qz - __shfl_sync(0xffffffffu, kp.z, kl);
        const float rr2 = sqrtf(dx * dx + dy * dy + dz * dz);
        const float rinv = (key == row || key >= n) ? 0.f : rpe::kSh1 / (rr2 + 1e-12f);
        f[mt][hh][0] = rinv * dx;
        f[mt][hh][1] = rinv * dy;
        f[mt][hh][2] = rinv * dz;
      }
    if (!L::kGeoAhead && j >= 2)
      mbar_wait_or_trap(&sempty[buf], ((j >> 1) - 1) & 1, 2);  // tile j - 2 is read
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kl = k16 + 16 * mt + 8 * hh + g;  // of the item's keys
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int ah = 8 * nt + 2 * t + i;
            if (ah >= AH) continue;
            float val = acc[mt][nt][2 * hh + i];
            if (with_sh)
              val += qwr[ah] * f[mt][hh][1] + qwr[AH + ah] * f[mt][hh][2]
                     + qwr[2 * AH + ah] * f[mt][hh][0];
            sprow[rpe_ws::score_col(ah, kl)] = val;
          }
      }
    __syncwarp();  // the warp's scores are written
    if (lane == 0) mbar_arrive(&sfull[buf]);
  }
}

// q, k, v (B, AH, N, HC); qp (B, N, AH, C); kmask (B, N); qw (B, 3, AH, N)
// f32 rows (y, z, x) or null; pts3 (B, N, 3), knn (B, N, KA, 3) f32 (the
// SH term's coordinates are pts3's too); gt (C, 64) bf16, G transposed; out
// (B, AH, N, HC) f32.
template <int AH, int HC>
__global__ void __launch_bounds__(Layout<AH, HC>::kThreads, 1)
rpe_attention_femb_ws_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ qp,
                             const uint8_t* __restrict__ kmask, const float* __restrict__ qw,
                             const float* __restrict__ pts3,
                             const float* __restrict__ knn, const bf16* __restrict__ gt,
                             float* __restrict__ out, int n, int cc, float scale,
                             float inv_d, float inv_a) {
  using L = Layout<AH, HC>;
  using F = typename L::Flash;
  extern __shared__ __align__(128) char fw_smem[];
  bf16* sg = reinterpret_cast<bf16*>(fw_smem);
  bf16* sbasis = reinterpret_cast<bf16*>(fw_smem + L::basis(cc));
  bf16* qring = reinterpret_cast<bf16*>(fw_smem + L::qring(cc));
  float* sp = reinterpret_cast<float*>(fw_smem + L::scores(cc));
  bf16* vtiles = reinterpret_cast<bf16*>(fw_smem + L::vtiles(cc));
  float* qw_s = reinterpret_cast<float*>(fw_smem + L::qws(cc));
  float* rowgeo = reinterpret_cast<float*>(fw_smem + L::rowgeo(cc));
  float4* geo = reinterpret_cast<float4*>(fw_smem + L::geo(cc));  // kGeoAhead
  uint64_t* sfull = reinterpret_cast<uint64_t*>(fw_smem + L::bars(cc));  // [2]
  uint64_t* sempty = sfull + 2;                                        // [2]

  const int nblk = (n + kRows - 1) / kRows;
  const int b = blockIdx.x / nblk;
  const int row0 = (blockIdx.x - b * nblk) * kRows;
  const int nr = min(kRows, n - row0);  // query rows of this block
  const int ntiles = (n + kKeys - 1) / kKeys;
  const int total = ntiles * nr;          // (key tile, row) items
  const int ngrp = min(L::kGroups, nr);  // positional groups with items
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool with_sh = qw != nullptr;
  const float* pts3b = pts3 + (long long)b * n * 3;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sfull[i], nr * L::kItemWarps);  // one arrival a warp of a (tile, row) item
      mbar_init(&sempty[i], L::kFlash * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < nr) {  // the row's point, |q|^2 and neighbour offsets, once
    float* rg = rowgeo + threadIdx.x * kRowGeo;
    query_geometry<emb::kKA>(pts3b, knn, n, b, row0 + threadIdx.x, rg[0], rg[1], rg[2], rg[3],
                             rg + 4, rg + 4 + emb::kKA, rg + 4 + 2 * emb::kKA);
  }
  if (with_sh) {  // the block's SH queries, qw_s[r][d][ah] = qw[b, d, ah, row0 + r]
    const float* qwb = qw + (long long)b * 3 * AH * n;
    for (int i = threadIdx.x; i < nr * 3 * AH; i += L::kThreads) {
      const int r = i / (3 * AH), da = i - r * 3 * AH;
      qw_s[i] = qwb[(long long)da * n + row0 + r];
    }
  }
  load_g(sg, gt, cc);
  __syncthreads();
  const FembAhead<L::kGeoAhead> ahead{pts3b, rowgeo, n, row0, nr, with_sh, geo};
  if constexpr (L::kGeoAhead) {  // tiles 0 and 1's geometry; the flash warps form the rest
    for (int j = 0; j < 2 && j < ntiles; ++j) ahead(j, j, threadIdx.x, L::kThreads);
    __syncthreads();
  }

  if (warp < L::kPosWarps) {
    const int grp = warp / L::kItemWarps;
    if (grp < ngrp)
      positional<AH, HC>(grp, warp % L::kItemWarps, lane, row0, nr, ngrp, n, cc, total, pts3b,
                         with_sh, qp + (long long)b * n * AH * cc, rowgeo, qw_s, sg,
                         sbasis + grp * kKeys * emb::kBStride,
                         qring + grp * L::kQpSlots * AH * 32, inv_d, inv_a, sp, geo, sfull,
                         sempty);
  } else {
    const int fw = warp - L::kPosWarps;
    static_assert(F::kSplit == 1, "one flash warp a head: no end merge");
    rpe_ws::flash<AH, HC, L::kFlash>(fw, lane, b, row0, n, ntiles, q, k, v,
                                     kmask + (long long)b * n, sp,
                                     vtiles + fw * F::kWarpKeys * F::kVStride, nullptr, sfull,
                                     sempty, out, nullptr, scale, nullptr, 0, nullptr,
                                     ahead);
  }
}

// The shared memory of the (AH, HC) kernel at width cc; 0 where none is built.
inline size_t smem_bytes(int ah, int hc, int cc) {
  if ((hc != 64 && hc != 32) || cc % 32 != 0 || (ah != 24 && ah != 4)) return 0;
  if (hc == 64) return ah == 24 ? Layout<24, 64>::bytes(cc) : Layout<4, 64>::bytes(cc);
  return ah == 24 ? Layout<24, 32>::bytes(cc) : Layout<4, 32>::bytes(cc);
}

// static: internal linkage, as rpe_ws::launch
template <int AH, int HC>
static int launch(const void* q, const void* k, const void* v, const void* qp,
                  const void* kmask, const void* qw, const void* pts3, const void* knn,
                  const void* gt, void* out, int batch, int n, int cc, float scale,
                  float inv_d, float inv_a, cudaStream_t stream) {
  const size_t smem = Layout<AH, HC>::bytes(cc);
  static size_t attr = 0;  // raised once per kernel instance and width
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        rpe_attention_femb_ws_kernel<AH, HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  const int grid = batch * ((n + kRows - 1) / kRows);
  rpe_attention_femb_ws_kernel<AH, HC><<<grid, Layout<AH, HC>::kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)qp, (const uint8_t*)kmask,
      (const float*)qw, (const float*)pts3, (const float*)knn, (const bf16*)gt, (float*)out,
      n, cc, scale, inv_d, inv_a);
  return (int)cudaGetLastError();
}

// K16 in the ws form where smem_bytes(ah, hc, cc) is non-zero and fits;
// cudaErrorInvalidValue otherwise
inline int dispatch(const void* q, const void* k, const void* v, const void* qp,
                    const void* kmask, const void* qw, const void* pts3, const void* knn,
                    const void* gt, void* out, int batch, int ah, int n, int hc, int cc,
                    float scale, float inv_d, float inv_a, cudaStream_t s) {
  const size_t smem = smem_bytes(ah, hc, cc);
  if (smem == 0 || smem > (size_t)rpe_ws::kMaxSmem) return (int)cudaErrorInvalidValue;
  if (hc == 64) {
    if (ah == 24)
      return launch<24, 64>(q, k, v, qp, kmask, qw, pts3, knn, gt, out, batch, n, cc, scale,
                            inv_d, inv_a, s);
    return launch<4, 64>(q, k, v, qp, kmask, qw, pts3, knn, gt, out, batch, n, cc, scale,
                         inv_d, inv_a, s);
  }
  if (ah == 24)
    return launch<24, 32>(q, k, v, qp, kmask, qw, pts3, knn, gt, out, batch, n, cc, scale,
                          inv_d, inv_a, s);
  return launch<4, 32>(q, k, v, qp, kmask, qw, pts3, knn, gt, out, batch, n, cc, scale, inv_d,
                       inv_a, s);
}

}  // namespace femb_ws
}  // namespace se3et
