// K1's tensor-core gather of wf over a run of (query row, channel chunk)
// items, taken by one warp (K1's tc form; K14's tc form takes the same
// routine, so its wf equals K1's bit for bit):
//
//   wf[row, k, ac] = sum_h infl[row, h, k] * x[b, nbr[row, h], ac]
//
// rows the flattened (b, q) rows of nbr / infl / out (b = row / nq), items
// (row, chunk) in row-major order, sentinels (indices outside [0, ns))
// contributing nothing, the influence read in place as (rows, hs, K) with
// hs >= H (its first H columns), the float32 sums rounded once to bf16.
//  * the row's influence is read once into registers as the A fragments of
//    an m16n8k16 mma.sync: A[kp][hh] = infl[row][hh][kp], K padded to 16 and
//    H to 16 * HS with zeros;
//  * the row's neighbour rows of the chunk are staged by 16-byte cp.async
//    into a per-warp ring of Tile::stages slots, Tile::stages - 1 items ahead
//    (across rows), sentinels zero-filled (no load) and the padding rows past
//    H zeroed once; they are read with ldmatrix.trans from rows of
//    Tile::cw channels whose 16-byte units are placed by Tile::at;
//  * per item the (16 x 16 HS) @ (16 HS x cw) product runs on the tensor
//    cores, its sums are rounded to bf16 into a per-warp (16 x cw) shared
//    tile, read back as 16-byte units and written with streaming stores
//    (st.global.cs), each of the K output rows of a chunk one contiguous run.
// The tiling is a policy (Tile: cw, stages, at(row, channel)); WfTile is
// K1's: 32-channel chunks (64-byte rows, units XOR-swizzled by row pair, so
// that ldmatrix phases and fragment stores are conflict-free) and a 4-slot
// ring (K14 takes the same chunks on a 3-slot ring).  The ring's depth
// does not change the sums.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace se3et {

// element offset of channel c (0..31) in row r >= 0 of a tile of 64-byte
// rows, 16-byte units XOR-swizzled by row pair.  The three terms' bits are
// disjoint, and written with `|` they compile to the code K1's kernel had
// before this routine was factored out of it; with `+` K1 ran 7-9 % slower
// at its stage 2-3 shapes (PERF.md)
__device__ __forceinline__ int wf_swz32(int r, int c) {
  return (r << 5) | ((((c >> 3) ^ (r >> 1)) & 3) << 3) | (c & 7);
}

struct WfTile {
  static constexpr int cw = 32, stages = 4;
  static __device__ __forceinline__ int at(int r, int c) { return wf_swz32(r, c); }
};

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// shared bytes of one warp: the ring and the output tile
template <class Tile, int HS>
__host__ __device__ constexpr size_t wf_warp_smem() {
  return (size_t)(Tile::stages * 16 * HS * Tile::cw + 16 * Tile::cw) * sizeof(__nv_bfloat16);
}

// items [i0, i1) of this warp, its shared region `wsmem` (wf_warp_smem bytes,
// 16-byte aligned); every lane calls it with the same arguments but `lane`
template <class Tile, int HS>
__device__ __forceinline__ void gather_wf_tc_items(const __nv_bfloat16* x, const int* nbr,
                                                   const __nv_bfloat16* infl,
                                                   __nv_bfloat16* out, int ns, int nq, int h,
                                                   int hs, int k, int ac, int nchunks, int i0,
                                                   int i1, unsigned char* wsmem, int lane) {
  using bf16 = __nv_bfloat16;
  constexpr int kCW = Tile::cw;
  constexpr int kU = kCW / 8;                 // 16-byte units per shared row
  constexpr int kStages = Tile::stages;
  constexpr int kAhead = kStages - 1;         // items staged ahead
  constexpr int hp = 16 * HS;
  constexpr int kSlot = hp * kCW;             // bf16 per ring slot
  constexpr int kRowsPerLane = hp * kU / 32;  // neighbour rows a lane stages
  if (i0 >= i1) return;
  const int g = lane >> 2, t = lane & 3;
  bf16* ring = reinterpret_cast<bf16*>(wsmem);  // [kStages][hp][kCW]
  bf16* otile = ring + kStages * kSlot;         // [16][kCW]

  // padding rows h..hp of every slot are never staged: zero them once
  for (int i = lane; i < kStages * (hp - h) * kU; i += 32) {
    const int slot = i / ((hp - h) * kU), rem = i - slot * (hp - h) * kU;
    *reinterpret_cast<uint4*>(ring + slot * kSlot + Tile::at(h + rem / kU, 8 * (rem % kU))) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // the staging cursor's row: lane stages units u of neighbour rows
  // hh = lane / kU + (32 / kU) m, whose indices it holds in idx[m]
  const int u = lane % kU;
  int idx[kRowsPerLane];
  int srow = -1;
  auto stage = [&](int j) {
    const int row = j / nchunks, c0 = (j - row * nchunks) * kCW;
    if (row != srow) {
      srow = row;
      const int* rn = nbr + (long long)row * h;
#pragma unroll
      for (int m = 0; m < kRowsPerLane; ++m) {
        const int hh = lane / kU + (32 / kU) * m;
        idx[m] = hh < h ? __ldg(rn + hh) : ns;
      }
    }
    const bf16* xb = x + (long long)(row / nq) * ns * ac;
    bf16* dst = ring + (j % kStages) * kSlot;
    const bool col_ok = c0 + 8 * u < ac;
#pragma unroll
    for (int m = 0; m < kRowsPerLane; ++m) {
      const int hh = lane / kU + (32 / kU) * m;
      if (hh < h) {
        const int jn = idx[m];
        const bool ok = col_ok && jn >= 0 && jn < ns;
        cp_async16(dst + Tile::at(hh, 8 * u), ok ? xb + (long long)jn * ac + c0 + 8 * u : xb,
                   ok);
      }
    }
  };
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    if (i0 + a < i1) stage(i0 + a);
    cp_async_commit();
  }

  uint32_t wf[HS][4];
  int crow = -1;
  for (int i = i0; i < i1; ++i) {
    if (i + kAhead < i1) stage(i + kAhead);
    cp_async_commit();
    cp_async_wait<kAhead>();
    __syncwarp();
    const int row = i / nchunks, c0 = (i - row * nchunks) * kCW;
    if (row != crow) {
      // A[kp][hh] = infl[row][hh][kp]: rows kp = g, g + 8 (zero past k),
      // columns hh (zero past h)
      crow = row;
      const bf16* wr = infl + (long long)row * hs * k;
      auto w = [&](int kp, int hh) {
        return kp < k && hh < h ? wr[hh * k + kp] : __float2bfloat16(0.f);
      };
#pragma unroll
      for (int s = 0; s < HS; ++s) {
        const int ha = 16 * s + 2 * t, hb = ha + 8;
        wf[s][0] = pack_bf16x2(w(g, ha), w(g, ha + 1));
        wf[s][1] = pack_bf16x2(w(g + 8, ha), w(g + 8, ha + 1));
        wf[s][2] = pack_bf16x2(w(g, hb), w(g, hb + 1));
        wf[s][3] = pack_bf16x2(w(g + 8, hb), w(g + 8, hb + 1));
      }
    }
    // B fragments of n-tiles 2qq, 2qq+1 over neighbour rows 16s.. (by
    // ldmatrix.trans), all loaded before the products use them
    const bf16* xs = ring + (i % kStages) * kSlot;
    const int mi = lane >> 3;
    uint32_t bq[HS][kCW / 16][4];
#pragma unroll
    for (int s = 0; s < HS; ++s)
#pragma unroll
      for (int qq = 0; qq < kCW / 16; ++qq)
        ldmatrix_x4_trans(
            bq[s][qq], xs + Tile::at(16 * s + (mi & 1) * 8 + (lane & 7), 8 * (2 * qq + (mi >> 1))));
    float d[kCW / 8][4];
#pragma unroll
    for (int j = 0; j < kCW / 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < HS; ++s) {
#pragma unroll
      for (int qq = 0; qq < kCW / 16; ++qq) {
        mma_bf16(d[2 * qq], wf[s][0], wf[s][1], wf[s][2], wf[s][3], bq[s][qq][0], bq[s][qq][1]);
        mma_bf16(d[2 * qq + 1], wf[s][0], wf[s][1], wf[s][2], wf[s][3], bq[s][qq][2],
                 bq[s][qq][3]);
      }
    }
    // the (16, cw) tile rounded to bf16 through shared memory, then the K
    // valid rows' units as streaming 16-byte stores
#pragma unroll
    for (int j = 0; j < kCW / 8; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(otile + Tile::at(g, c)) =
          __floats2bfloat162_rn(d[j][0], d[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(otile + Tile::at(g + 8, c)) =
          __floats2bfloat162_rn(d[j][2], d[j][3]);
    }
    __syncwarp();
    bf16* orow = out + (long long)row * k * ac + c0;
#pragma unroll
    for (int m = 0; m < 16 * kU / 32; ++m) {
      const int v = lane + 32 * m, kp = v / kU, uu = v % kU;
      if (kp < k && c0 + 8 * uu < ac)
        __stcs(reinterpret_cast<uint4*>(orow + (long long)kp * ac + 8 * uu),
               *reinterpret_cast<const uint4*>(otile + Tile::at(kp, 8 * uu)));
    }
    __syncwarp();  // the slot and the tile are free for the next items
  }
  cp_async_wait<0>();
}

}  // namespace se3et
