// K9's "tiles" form: the backward of the strided skip's neighbour max
// (neighbor_max_bwd.cu states the function) in two kernels, each written
// around the reads that held the first design back.
//
// 1. max_bwd_share_rows_kernel, the shares and the tie bits: K2's rows form
//    (neighbor_max.cu, skip_max.cuh) with a tie count in place of the max.
//    A warp takes a (query row, slice of 32 x SU 16-byte units); a lane
//    keeps its SU units of the row's forward max `out` in registers,
//    compacts the row's valid slots by a ballot per 32 slots and loads NB
//    valid neighbour rows' units at a time straight into registers (no
//    load for a sentinel or a negative index).  Each unit is compared with
//    `out`: its four ties are counted in four 8-bit fields of one word (H
//    <= 64) and written as the slot's nibble for that unit (a byte a unit,
//    32 consecutive bytes a warp store).  The shadow zeros of the sentinel
//    slots add (H - valid) where out == 0.f (-0.f too), as the first
//    design counts them.  share = dout / (float)count, 0 where count is 0:
//    the first design's IEEE division, so its bits.  dout is read once
//    after the walk of the slots, share written by 16-byte stores.
// 2. max_bwd_tiles_kernel, the sums: K8's tile walk (gather_wf_bwd_tiles.cuh)
//    over the same tile plan, which K8 builds for the same neighbour tensor
//    (the strided conv and its skip share `neighbor_indices`).  A one-warp
//    block owns a tile of 32 source rows x a slice of 64 channels (2 a
//    lane): the tile's float32 sums lie in the warp's own columns of shared
//    memory (a lane reads and writes only its own channels, so no atomics).
//    It walks the tile's valid slots in ascending (q, h) order;
//    share[q, slice] goes once per (tile, query run) through a ring of R
//    slots by cp.async, issued up to R - 1 runs ahead (the next runs found
//    by ballots over the entries in registers), and the slots' tie bits of
//    the slice (16 bytes each) are loaded a batch of 32 entries ahead and
//    staged in shared memory.  Each slot adds share where its tie bit is
//    set into its source row's sum: x and out are not read again.  The sums
//    start at +0.f and take their slots in ascending slot order, the first
//    design's reverse-index order, by the same float32 adds and the same
//    ties, so dx is its bits (a tile writes every row, +0.f where no slot
//    lands; sentinel and negative slots are not in the plan).  Warps are
//    persistent and take items (tile, then slice) from a counter the
//    launch zeroes.
//
// Bound: bytes.  Pass 1 gathers the valid rows of x (3.0-6.5 reads a row
// on a real pair's sets, mostly from L2); pass 2 reads a query's share row
// once per source tile (1.7-3.4 reads a row there) and writes dx.  The share
// scratch (Nq AC floats) and the tie bits (a byte per 4 channels of a
// valid slot) are written and read once; share, tie bits and dx are
// stored evict-first, so that they leave L2 to the gathered rows.
//
// scripts/probe_neighbor_max_bwd.py builds copies of this source cut at a
// stage (MAX_BWD_TILES_STAGE 0: pass 2's stream alone, no tie test and no
// sum; MAX_BWD_SHARE_STORE 0: pass 1 without its share store) and at other
// cuts: MAX_BWD_TIE_MASK 0 (the tie test of pass 2 against x and out,
// which then reads the tile's x slice into shared memory and out with
// share, the form first built), 1 (tie bits as four ballot words a 128
// channels); MAX_BWD_SHARE_WORDS 48 (4 neighbour rows in flight a lane,
// not 2); MAX_BWD_DOUT_EARLY 1 (dout read before the walk);
// MAX_BWD_STREAM_STORES 0 (plain stores); MAX_BWD_BITS_SMEM 0 (tie bits
// taken by shuffles); MAX_BWD_TILES_T 64 rows a tile, _VEC channels a lane
// (with the x tile), _RING runs in flight; MAX_BWD_INTERLEAVE 1 (with the
// x tile: out and share interleaved by channel into one scratch of 2 Nq AC
// floats, one gathered read a run).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MAX_BWD_TILES_STAGE
#define MAX_BWD_TILES_STAGE 1
#endif
#ifndef MAX_BWD_SHARE_STORE
#define MAX_BWD_SHARE_STORE 1
#endif
#ifndef MAX_BWD_TILES_T
#define MAX_BWD_TILES_T 32
#endif
#ifndef MAX_BWD_TILES_VEC
#define MAX_BWD_TILES_VEC 2
#endif
#ifndef MAX_BWD_TILES_RING
#define MAX_BWD_TILES_RING 4
#endif
#ifndef MAX_BWD_INTERLEAVE
#define MAX_BWD_INTERLEAVE 0
#endif
#ifndef MAX_BWD_TIE_MASK
#define MAX_BWD_TIE_MASK 2
#endif
#ifndef MAX_BWD_STREAM_STORES
#define MAX_BWD_STREAM_STORES 1
#endif
#ifndef MAX_BWD_SHARE_WORDS
#define MAX_BWD_SHARE_WORDS 24
#endif
#ifndef MAX_BWD_DOUT_EARLY
#define MAX_BWD_DOUT_EARLY 0
#endif
#ifndef MAX_BWD_BITS_SMEM
#define MAX_BWD_BITS_SMEM 1
#endif

namespace k9_tiles {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxH = 64;
constexpr bool kInterleave = MAX_BWD_INTERLEAVE != 0;
// pass 2's tie test: 0 x against out (the x tile), 1 tie bits as ballot
// words, 2 tie bits as a nibble a unit
constexpr int kMaskMode = MAX_BWD_TIE_MASK;
constexpr bool kMask = kMaskMode != 0;

// stores of what no later read of the kernel wants (share, tie bits, dx)
// marked evict-first (st.global.cs), so that they leave L2 to the rows that
// are read again
template <typename T>
__device__ __forceinline__ void store_once(T* p, T v) {
  if constexpr (MAX_BWD_STREAM_STORES != 0) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// 16-byte units of tie bits a slot's row holds, for rows of `units` units
__host__ __device__ inline int tie_units(int units) {
  return kMaskMode == 1 ? (units + 31) / 32 : (units + 15) / 16;
}

// ---------------------------------------------------------------- pass 1

constexpr int kMaxSU = 3;       // 16-byte units a lane of a slice
// registers of loads in flight a lane: NB = 24 / (4 SU)
constexpr int kLoadWords = MAX_BWD_SHARE_WORDS;
constexpr int kShareWarps = 8;  // warps a block

struct ShareArgs {
  const float* x;     // (B, Ns, AC)
  const int* nbr;     // (B, Nq, H)
  const float* out;   // (B, Nq, AC) the forward max
  const float* dout;  // (B, Nq, AC)
  float* share;       // (B, Nq, AC), or (B, Nq, 2 AC) out and share interleaved
  uint4* mask;        // (B, Nq * H, mask_units) the tie bits, where compiled with them
  int ns, nq, h, units, slices, mask_units;
  long long items;
};

__device__ __forceinline__ bool valid_slot(int j, int ns) { return j >= 0 && j < ns; }

// one bit per equal word, in the low bit of four bytes
__device__ __forceinline__ uint32_t ties(uint4 v, uint4 m) {
  return (uint32_t)(__uint_as_float(v.x) == __uint_as_float(m.x)) |
         (uint32_t)(__uint_as_float(v.y) == __uint_as_float(m.y)) << 8 |
         (uint32_t)(__uint_as_float(v.z) == __uint_as_float(m.z)) << 16 |
         (uint32_t)(__uint_as_float(v.w) == __uint_as_float(m.w)) << 24;
}

// The tie bits of a warp's 32 consecutive units (128 channels; t a lane's
// ties()) as four ballots, one per channel of a unit, regrouped by
// 64-channel halves so that a half is one 8-byte pair: (A0, B0, A1, B1),
// bit k of A_h the first channel of unit 16 h + k and bit 16 + k its
// second, B_h the third and fourth.
__device__ __forceinline__ uint4 tie_bits(uint32_t t) {
  const uint32_t w0 = __ballot_sync(kFull, t & 1u);
  const uint32_t w1 = __ballot_sync(kFull, t >> 8 & 1u);
  const uint32_t w2 = __ballot_sync(kFull, t >> 16 & 1u);
  const uint32_t w3 = __ballot_sync(kFull, t >> 24 & 1u);
  return make_uint4((w0 & 0xffffu) | w1 << 16, (w2 & 0xffffu) | w3 << 16,
                    w0 >> 16 | (w1 & 0xffff0000u), w2 >> 16 | (w3 & 0xffff0000u));
}

__device__ __forceinline__ float share_of(float d, float m, uint32_t count, int shadow) {
  const int c = (int)count + (m == 0.f ? shadow : 0);
  return c > 0 ? d / (float)c : 0.f;
}

template <int SU, int NB>
__global__ void __launch_bounds__(32 * kShareWarps) max_bwd_share_rows_kernel(ShareArgs a) {
  constexpr uint32_t kNaN = 0x7fffffffu;  // equal to nothing
  const long long item = (long long)blockIdx.x * kShareWarps + (threadIdx.x >> 5);
  if (item >= a.items) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const long long row = item / a.slices;  // (b, q) flattened
  const int slice = (int)(item - row * a.slices);
  const uint4* xb = reinterpret_cast<const uint4*>(a.x) + row / a.nq * a.ns * a.units;
  const int* idx = a.nbr + row * a.h;
  const int mine = slice * 32 * SU + lane;  // this lane's first unit
  const long long rbase = row * a.units;
  uint4 m[SU], d[SU];
  uint32_t cnt[SU];
#pragma unroll
  for (int u = 0; u < SU; ++u) {
    const bool ok = mine + 32 * u < a.units;
    m[u] = ok ? __ldg(reinterpret_cast<const uint4*>(a.out) + rbase + mine + 32 * u)
              : make_uint4(kNaN, kNaN, kNaN, kNaN);
    if constexpr (MAX_BWD_DOUT_EARLY != 0) {
      d[u] = ok ? __ldg(reinterpret_cast<const uint4*>(a.dout) + rbase + mine + 32 * u)
                : make_uint4(0u, 0u, 0u, 0u);
    }
    cnt[u] = 0;
  }
  int nvalid = 0;
  for (int w = 0; w < a.h; w += 32) {
    uint32_t mask =
        __ballot_sync(kFull, valid_slot(w + lane < a.h ? idx[w + lane] : a.ns, a.ns));
    nvalid += __popc(mask);
    while (mask) {
      uint4 v[NB][SU];
      int slot[NB];  // the slot of each load, -1 past the row's valid slots
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const bool ok = mask != 0;
        const int hh = ok ? w + __ffs(mask) - 1 : 0;
        mask &= mask - 1;
        slot[n] = ok ? hh : -1;
        const uint4* src = xb + (long long)idx[hh] * a.units + mine;
#pragma unroll
        for (int u = 0; u < SU; ++u)
          v[n][u] = ok && mine + 32 * u < a.units ? __ldg(src + 32 * u)
                                                  : make_uint4(kNaN, kNaN, kNaN, kNaN);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        // the slot's row of tie bits, in 16-byte units
        uint4* bits_row = a.mask + (row * a.h + slot[n]) * a.mask_units;
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const uint32_t t = ties(v[n][u], m[u]);
          cnt[u] += t;
          if constexpr (kMaskMode == 1) {
            if (slot[n] >= 0 && (slice * SU + u) * 32 < a.units) {  // uniform in the warp
              const uint4 bits = tie_bits(t);
              if (lane == 0) store_once(bits_row + slice * SU + u, bits);
            }
          } else if constexpr (kMaskMode == 2) {
            // a byte a unit, its channels' ties in bits 0-3: a warp stores 32
            // consecutive bytes
            if (slot[n] >= 0 && mine + 32 * u < a.units)
              store_once(reinterpret_cast<uint8_t*>(bits_row) + mine + 32 * u,
                         (uint8_t)((t | t >> 7 | t >> 14 | t >> 21) & 15u));
          }
        }
      }
    }
  }
  const int shadow = a.h - nvalid;
#pragma unroll
  for (int u = 0; u < SU; ++u) {
    if (mine + 32 * u >= a.units) continue;
    // dout read after the walk of the slots (MAX_BWD_DOUT_EARLY: before it)
    if constexpr (MAX_BWD_DOUT_EARLY == 0)
      d[u] = __ldg(reinterpret_cast<const uint4*>(a.dout) + rbase + mine + 32 * u);
    const float4 s = make_float4(
        share_of(__uint_as_float(d[u].x), __uint_as_float(m[u].x), cnt[u] & 255, shadow),
        share_of(__uint_as_float(d[u].y), __uint_as_float(m[u].y), cnt[u] >> 8 & 255, shadow),
        share_of(__uint_as_float(d[u].z), __uint_as_float(m[u].z), cnt[u] >> 16 & 255, shadow),
        share_of(__uint_as_float(d[u].w), __uint_as_float(m[u].w), cnt[u] >> 24, shadow));
    const long long at = rbase + mine + 32 * u;
#if MAX_BWD_SHARE_STORE
    if constexpr (kInterleave) {
      float4* p = reinterpret_cast<float4*>(a.share) + 2 * at;
      const float4 mf = make_float4(__uint_as_float(m[u].x), __uint_as_float(m[u].y),
                                    __uint_as_float(m[u].z), __uint_as_float(m[u].w));
      store_once(p, make_float4(mf.x, s.x, mf.y, s.y));
      store_once(p + 1, make_float4(mf.z, s.z, mf.w, s.w));
    } else {
      store_once(reinterpret_cast<float4*>(a.share) + at, s);
    }
#else
    // the cut without the store: written only where the four shares' bits
    // add to a pattern they never do, so the compiler keeps their arithmetic
    if (__float_as_uint(s.x) + __float_as_uint(s.y) + __float_as_uint(s.z) +
            __float_as_uint(s.w) == 0x5a5a5a5au)
      reinterpret_cast<float4*>(a.share)[at] = s;
#endif
  }
}

// the instances by SU (NB = kLoadWords / (4 SU)), as K2's rows form plans
// its slices: as few slices of a row as hold it at 3 units a lane, balanced
template <int SU>
int launch_share_with(const ShareArgs& a, cudaStream_t st) {
  const long long blocks = (a.items + kShareWarps - 1) / kShareWarps;
  max_bwd_share_rows_kernel<SU, kLoadWords / (4 * SU)>
      <<<(unsigned)blocks, 32 * kShareWarps, 0, st>>>(a);
  return (int)cudaGetLastError();
}

inline int launch_share(ShareArgs a, int batch, cudaStream_t st) {
  const int slices = (a.units + 32 * kMaxSU - 1) / (32 * kMaxSU);
  const int su = (a.units + 32 * slices - 1) / (32 * slices);
  a.slices = slices;
  a.items = (long long)batch * a.nq * slices;
  if (a.items < 1) return (int)cudaSuccess;
  if (su == 1) return launch_share_with<1>(a, st);
  if (su == 2) return launch_share_with<2>(a, st);
  return launch_share_with<3>(a, st);
}

// ---------------------------------------------------------------- pass 2

constexpr int kTile = MAX_BWD_TILES_T;
constexpr int kVec = MAX_BWD_TILES_VEC;
constexpr int kRing = MAX_BWD_TILES_RING;
constexpr int kWidth = 32 * kVec;  // channels of a slice
// a ring slot: a lane's kVec channels of share (with tie bits), or of out
// then of share (or the 2 kVec interleaved values)
constexpr int kLaneSlot = kMask ? kVec : 2 * kVec;
constexpr int kSlotFloats = 32 * kLaneSlot;
// entry packing of the tile plan (windowed_conv.tile_plan): q << 12 | h << 6 | local
constexpr int kQShift = 12;
constexpr int kHShift = 6;
constexpr int kHMask = 63;
constexpr int kLocalMask = 63;

struct TileArgs {
  const float* x;      // (B, Ns, AC)
  const float* out;    // (B, Nq, AC), unread where interleaved
  const float* share;  // (B, Nq, AC), or (B, Nq, 2 AC) interleaved
  const uint4* mask;   // (B, Nq * H, mask_units) the tie bits, where compiled with them
  const int* ent;      // (B, Nq * H) the tile plan's entries
  const int* off;      // (B, ntiles + 1) their per-tile offsets
  float* dx;           // (B, Ns, AC)
  int* work;           // the items' counter, zeroed before the launch
  int batch, ns, nq, h, ac, mask_units;
};

// cp.async of `bytes` (4, 8 or 16) from gmem, zero-filled where !ok
template <int kBytes>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem, bool ok) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(gmem), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(dst), "l"(gmem), "n"(kBytes), "r"(ok ? kBytes : 0));
  }
}
// kVec floats a lane; 2 kVec floats by 16-byte copies where there are 8 or more
template <int kFloats>
__device__ __forceinline__ void cp_async_floats(float* smem, const float* gmem, bool ok) {
  if constexpr (kFloats <= 4) {
    cp_async<4 * kFloats>(smem, gmem, ok);
  } else {
#pragma unroll
    for (int i = 0; i < kFloats; i += 4) cp_async<16>(smem + i, gmem + i, ok);
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// until the oldest of this thread's n + 1 newest groups has landed (n <=
// kRing - 1; below it, near a tile's end, all of them: only slower)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= kRing - 1) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

template <int N>
__device__ __forceinline__ void load_n(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}
template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// the query of the first entry of `cur`, else of `nxt`, whose query is
// larger than q (queries ascend within a tile; -1 marks entries past its
// end), or -1
__device__ __forceinline__ int next_query(int cur, int nxt, int q) {
  unsigned m = __ballot_sync(kFull, (cur >> kQShift) > q);
  int src = cur;
  if (!m) {
    m = __ballot_sync(kFull, (nxt >> kQShift) > q);
    src = nxt;
  }
  return m ? (__shfl_sync(kFull, src, __ffs(m) - 1) >> kQShift) : -1;
}

// shared memory of a warp, in floats: the sums [kTile][kWidth], the x tile
// [kTile][kWidth] (not with tie bits), the ring [kRing][kSlotFloats]
// the batch's tie bits staged in shared memory, a lane's entry's 16 bytes
// each (nibbles; MAX_BWD_BITS_SMEM 0: taken by four shuffles a slot)
constexpr bool kBitsSmem = kMaskMode == 2 && MAX_BWD_BITS_SMEM != 0;
constexpr size_t kTileSmemBytes =
    ((size_t)(kMask ? 1 : 2) * kTile * kWidth + (size_t)kRing * kSlotFloats +
     (kBitsSmem ? 32 * 4 : 0)) * sizeof(float);

__global__ void __launch_bounds__(32) max_bwd_tiles_kernel(TileArgs a) {
  static_assert(kTile <= kLocalMask + 1, "local source rows are packed in 6 bits");
  static_assert(kRing >= 2 && kRing <= 8 && (kVec == 1 || kVec == 2 || kVec == 4), "a cut");
  static_assert(!kMask || (kVec == 2 && !kInterleave), "tie bits come in 64-channel slices");
  extern __shared__ __align__(16) float smem[];
  float* s_acc = smem;                                // [kTile][kWidth]
  float* s_x = s_acc + kTile * kWidth;                // [kTile][kWidth], unused with tie bits
  float* s_ring = s_x + (kMask ? 0 : kTile * kWidth);  // [kRing][kSlotFloats]
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_ring + kRing * kSlotFloats);  // [32][4]
  const int lane = threadIdx.x;
  const int ntiles = (a.ns + kTile - 1) / kTile;
  const int nslices = (a.ac + kWidth - 1) / kWidth;
  const int nitems = a.batch * ntiles * nslices;
  const int row_floats = kInterleave ? 2 * a.ac : a.ac;  // of the share scratch
  float* xcol = s_x + lane * kVec;
  float* col = s_acc + lane * kVec;
  float* ring_lane = s_ring + lane * kLaneSlot;
  // with tie bits: the lane's channels 2 lane, 2 lane + 1 of a 64-channel
  // slice are channels 2 (lane & 1) and + 1 of its unit lane / 2: as ballot
  // words, bits k and 16 + k of the slice's word A (lane even) or B (odd);
  // as nibbles, bits bitpos and + 1 of word wsel of the slice's 16 bytes
  const int k = lane >> 1;
  const int wsel = lane >> 3;
  const int bitpos = 8 * ((lane >> 1) & 3) + 2 * (lane & 1);

  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(a.work, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= nitems) break;
    const int slice = item % nslices;
    const int bt = item / nslices;
    const int t = bt % ntiles;
    const int b = bt / ntiles;
    const int c0 = slice * kWidth + lane * kVec;
    const bool active = c0 < a.ac;
    const int rows = min(kTile, a.ns - t * kTile);
    const int* eb = a.ent + (long long)b * a.nq * a.h;
    const int e0 = a.off[(long long)b * (ntiles + 1) + t];
    const int e1 = a.off[(long long)b * (ntiles + 1) + t + 1];
    if constexpr (!kMask) {
      // the x tile, one cp.async group (rows past Ns and idle lanes zeroed)
      const float* xt =
          a.x + ((long long)b * a.ns + (long long)t * kTile) * a.ac + (active ? c0 : 0);
      for (int r = 0; r < kTile; ++r) {
        const bool ok = active && r < rows;
        cp_async_floats<kVec>(xcol + r * kWidth, ok ? xt + (long long)r * a.ac : a.x, ok);
      }
      cp_async_commit();
    }
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      const float z[kVec] = {};
      store_n(col + r * kWidth, z);
    }
    const float* out_lane = a.out + (long long)b * a.nq * a.ac + (active ? c0 : 0);
    const float* share_lane = a.share + (long long)b * a.nq * row_floats +
                              (active ? (kInterleave ? 2 * c0 : c0) : 0);
    // the batch being walked and the next
    int cur = e0 + lane < e1 ? eb[e0 + lane] : -1;
    int nxt = e0 + 32 + lane < e1 ? eb[e0 + 32 + lane] : -1;
    // the ring: runs issued (one cp.async group each, run r in slot
    // r % kRing), the query of the last one issued, the run being walked
    int issued = 0, last_q = -1, run = -1, cur_q = -1;
    float o[kVec], sh[kVec];
    auto fill = [&](int limit) {
      while (issued < limit) {
        const int q = next_query(cur, nxt, last_q);
        if (q < 0) break;
        float* slot = ring_lane + (issued % kRing) * kSlotFloats;
        if constexpr (kMask) {
          cp_async_floats<kVec>(slot, share_lane + (long long)q * row_floats, active);
        } else if constexpr (kInterleave) {
          cp_async_floats<2 * kVec>(slot, share_lane + (long long)q * row_floats, active);
        } else {
          cp_async_floats<kVec>(slot, out_lane + (long long)q * a.ac, active);
          cp_async_floats<kVec>(slot + kVec, share_lane + (long long)q * row_floats, active);
        }
        cp_async_commit();
        last_q = q;
        ++issued;
      }
    };
    // with tie bits: a lane's entry's bits of the slice (8 bytes of ballot
    // words or 16 of nibbles), loaded a batch ahead of the walk
    const long long bits_b = (long long)b * a.nq * a.h;
    auto load_bits = [&](int e) {
      if (!kMask || e < 0) return make_uint4(0u, 0u, 0u, 0u);
      const long long at = bits_b + (long long)(e >> kQShift) * a.h + ((e >> kHShift) & kHMask);
      if constexpr (kMaskMode == 1) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(a.mask) + at * 2 * a.mask_units +
                              slice);
        return make_uint4(w.x, w.y, 0u, 0u);
      } else {
        return __ldg(a.mask + at * a.mask_units + slice);
      }
    };
    uint4 bits = load_bits(cur);
    uint32_t fold = 0;  // the tie bits' use in the stream cut
    fill(kRing - 1);
    for (int base = e0; base < e1; base += 32) {
      const int after = base + 64 + lane < e1 ? eb[base + 64 + lane] : -1;
      if constexpr (kBitsSmem) {
        __syncwarp();  // the batch before is walked
        reinterpret_cast<uint4*>(s_bits)[lane] = bits;
        __syncwarp();
      }
      const uint4 bits_next = load_bits(nxt);
      const int n = min(32, e1 - base);
      for (int j = 0; j < n; ++j) {
        const int e = __shfl_sync(kFull, cur, j);
        const int q = e >> kQShift;
        if (q != cur_q) {
          ++run;
          cur_q = q;
          // the run is issued (its first entry is in `cur`); the slot of the
          // run before is free, its values in registers
          fill(run + kRing);
          cp_async_wait(issued - 1 - run);
          float v[kLaneSlot];
          load_n(v, ring_lane + (run % kRing) * kSlotFloats);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            o[i] = kMask ? 0.f : kInterleave ? v[2 * i] : v[i];
            sh[i] = kMask ? v[i] : kInterleave ? v[2 * i + 1] : v[kVec + i];
          }
#if MAX_BWD_TILES_STAGE == 0
          float acc[kVec];
          load_n(acc, col);
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] += o[i] + sh[i];
          store_n(col, acc);
#endif
        }
#if MAX_BWD_TILES_STAGE == 0
        if constexpr (kMask) fold ^= __shfl_sync(kFull, bits.x ^ bits.y ^ bits.z ^ bits.w, j);
#else
        float* sum = col + (e & kLocalMask) * kWidth;
        float acc[kVec];
        load_n(acc, sum);
        if constexpr (kMaskMode == 1) {
          const uint32_t wa = __shfl_sync(kFull, bits.x, j);
          const uint32_t wb = __shfl_sync(kFull, bits.y, j);
          const uint32_t word = lane & 1 ? wb : wa;
          acc[0] = word >> k & 1u ? acc[0] + sh[0] : acc[0];
          acc[1] = word >> (16 + k) & 1u ? acc[1] + sh[1] : acc[1];
        } else if constexpr (kBitsSmem) {
          const uint32_t word = s_bits[j * 4 + wsel];
          acc[0] = word >> bitpos & 1u ? acc[0] + sh[0] : acc[0];
          acc[1] = word >> (bitpos + 1) & 1u ? acc[1] + sh[1] : acc[1];
        } else if constexpr (kMaskMode == 2) {
          const uint32_t w0 = __shfl_sync(kFull, bits.x, j);
          const uint32_t w1 = __shfl_sync(kFull, bits.y, j);
          const uint32_t w2 = __shfl_sync(kFull, bits.z, j);
          const uint32_t w3 = __shfl_sync(kFull, bits.w, j);
          const uint32_t word = wsel == 0 ? w0 : wsel == 1 ? w1 : wsel == 2 ? w2 : w3;
          acc[0] = word >> bitpos & 1u ? acc[0] + sh[0] : acc[0];
          acc[1] = word >> (bitpos + 1) & 1u ? acc[1] + sh[1] : acc[1];
        } else {
          float xv[kVec];
          load_n(xv, xcol + (e & kLocalMask) * kWidth);
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] = xv[i] == o[i] ? acc[i] + sh[i] : acc[i];
        }
        store_n(sum, acc);
#endif
      }
      cur = nxt;
      nxt = after;
      bits = bits_next;
    }
    // the x tile has landed (a tile without slots never waited for it)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if (active) {
      float* dst = a.dx + ((long long)b * a.ns + (long long)t * kTile) * a.ac + c0;
      for (int r = 0; r < rows; ++r) {
        float v[kVec];
        load_n(v, col + r * kWidth);
#if MAX_BWD_TILES_STAGE == 0
        if constexpr (kMask) {
          v[0] += (float)(fold & 1u);
        } else {
          float xv[kVec];
          load_n(xv, xcol + r * kWidth);
#pragma unroll
          for (int i = 0; i < kVec; ++i) v[i] += xv[i];
        }
#endif
        if constexpr (kVec == 2) {
          store_once(reinterpret_cast<float2*>(dst + (long long)r * a.ac), make_float2(v[0], v[1]));
        } else {
          store_n(dst + (long long)r * a.ac, v);
        }
      }
    }
  }
}

inline int launch_tiles(const TileArgs& a, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(max_bwd_tiles_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kTileSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, max_bwd_tiles_kernel, 32,
                                                    kTileSmemBytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long items = (long long)a.batch * ((a.ns + kTile - 1) / kTile) *
                          ((a.ac + kWidth - 1) / kWidth);
  const int grid = (int)(items < (long long)sms * per_sm ? items : (long long)sms * per_sm);
  e = cudaMemsetAsync(a.work, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (grid < 1) return (int)cudaSuccess;
  max_bwd_tiles_kernel<<<grid, 32, kTileSmemBytes, st>>>(a);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace k9_tiles
