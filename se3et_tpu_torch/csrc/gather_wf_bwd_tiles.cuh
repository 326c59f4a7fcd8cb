// K8's "tiles" form: the backward of the conv gather with respect to the
// features with no intermediate tensor in device memory.
//
//   dx[b, s, c] = sum_{(q, h): nbr[b, q, h] = s} sum_k infl[b, q, h, k] * dwf[b, q, k, c]
//
// The first design (gather_wf_bwd.cu) writes one float32 row per neighbour
// slot and reads it back per source row: at H > K that slot tensor is
// 1.6-2.5 times dwf and ~80 % of the traffic.  Here each warp (a one-warp
// block) owns a work item, a tile of T consecutive source rows of one cloud
// times a slice of 32 * VEC channels (VEC a lane), and keeps the tile's
// float32 sums in its own columns of shared memory.  It walks the tile's
// valid neighbour slots in ascending (q, h) order from the tile plan
// (windowed_conv.tile_plan: slots sorted by (source tile, slot), per-tile
// offsets, each entry packed as q << 12 | h << 6 | local source row), so
//  * dwf[b, q, 0:K, slice] is read once per (tile, q): the points come in
//    Morton order, so a tile of sources is reached by a compact run of
//    queries.  A run's K rows go by cp.async (a lane its own channels) into
//    a ring of R slots of the warp's shared memory, issued up to R - 1 runs
//    ahead of the walk (the next runs found by ballots over the entries in
//    registers), and are copied to registers when the walk reaches the run;
//  * the influence rows of the next batch of 32 entries are loaded into
//    registers (a lane its entry's row) while the current batch is walked,
//    then stored to shared memory, where the walk reads them by broadcast;
//  * each slot's value is the first design's chain (0.f, then fmaf over
//    k = 0..K-1) and is added to its source's sum in the first design's
//    order (ascending slot, from 0.f), so dx is the first design's bits;
//    two consecutive slots of a run are taken together (their chains
//    interleaved, added in order where they share a source row);
//  * a lane's sums and ring data are its own columns, so the walk needs no
//    block barrier and no atomics (a __syncwarp around each batch's
//    influence rows); each tile writes all its rows (zeros where no slot
//    lands); sentinel slots are not in the plan.
// Warps are persistent and take items (tile-major, then slice) from a
// counter the launch zeroes: dense and sparse regions balance, and the
// order of each tile's sum stays fixed.  Arithmetic: float32 FMAs on the
// CUDA cores.  Bound by bytes: at T = 32 the stream of re-read rows (1.5-4.6
// reads a row on a real pair's sets) takes most of the time
// (scripts/probe_gather_wf_bwd.py).  Tried and slower (PERF.md): each warp
// waiting on a row load at every run and an influence load at every entry;
// bulk copies (TMA) of the ring's 256-byte rows; tiles of 64 or 128 rows
// walked by blocks of 2 or 4 warps that share one ring, meeting at each run
// or fed by a producer warp (fewer rows read twice, but every warp walks
// every entry and run of the tile); the ring's reads marked evict-last in
// L2.  AC a multiple of 4 (every width of the model).
//
// The cut: T = 32 source rows a tile, VEC = 2 channels a lane, R = 2 runs in
// flight; the fastest summed over a step's same-level launches.  Larger tiles
// read fewer dwf rows twice but keep fewer warps resident, as do wider
// slices and deeper rings.  scripts/probe_gather_wf_bwd.py builds copies of
// this source with other cuts (-DGATHER_WF_BWD_TILES_T=64, _VEC=4, _RING=3)
// and cut at one stage by GATHER_WF_BWD_TILES_STAGE (wrong gradients, timing
// only): 0 the dwf stream alone (each run's rows through the ring into
// registers), 1 + the walk of every entry (influence rows staged and read,
// sums updated) without the FMA chains, 2 the whole form (the default).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GATHER_WF_BWD_TILES_STAGE
#define GATHER_WF_BWD_TILES_STAGE 2
#endif
#ifndef GATHER_WF_BWD_TILES_T
#define GATHER_WF_BWD_TILES_T 32
#endif
#ifndef GATHER_WF_BWD_TILES_VEC
#define GATHER_WF_BWD_TILES_VEC 2
#endif
#ifndef GATHER_WF_BWD_TILES_RING
#define GATHER_WF_BWD_TILES_RING 2
#endif

namespace k8_tiles {

constexpr int kTile = GATHER_WF_BWD_TILES_T;
constexpr int kVec = GATHER_WF_BWD_TILES_VEC;
constexpr int kRing = GATHER_WF_BWD_TILES_RING;
constexpr int kWidth = 32 * kVec;  // channels of a slice
constexpr int kMaxK = 16;
constexpr unsigned kFull = 0xffffffffu;
// entry packing: q << kQShift | h << kHShift | local source row
constexpr int kQShift = 12;
constexpr int kHShift = 6;
constexpr int kHMask = 63;
constexpr int kLocalMask = 63;

// cp.async of one lane's 4 * kVec bytes, zero-filled where !ok
__device__ __forceinline__ void cp_async(float* smem, const float* gmem, bool ok) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(gmem), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(dst), "l"(gmem), "n"(4 * kVec), "r"(ok ? 4 * kVec : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// until the oldest of this thread's n + 1 newest cp.async groups has landed
// (n <= kRing - 1; below it, near a tile's end, all of them: only slower)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= kRing - 1) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

__device__ __forceinline__ void load_vec(float (&v)[kVec], const float* p) {
  if constexpr (kVec == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (kVec == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

struct Args {
  const float* dwf;   // (B, Nq, K * AC)
  const float* infl;  // (B, Nq, HS, K), its first H columns read
  const int* ent;     // (B, Nq * H) the tile plan's entries
  const int* off;     // (B, ntiles + 1) their per-tile offsets
  float* dx;          // (B, Ns, AC)
  int* work;          // the items' counter, zeroed before the launch
  int batch, ns, nq, h, hs, k, ac;
};

// shared memory of a warp, in floats: the tile's sums [kTile][kWidth], the
// ring [kRing][K][kWidth] and two batches of influence rows [2][32][kMaxK]
inline size_t smem_bytes(int k) {
  return ((size_t)kTile * kWidth + (size_t)kRing * k * kWidth + 2 * 32 * kMaxK) * sizeof(float);
}

// one slot's value over the lane's channels: the first design's chain
__device__ __forceinline__ void slot_value(float (&s)[kVec], const float (&w)[kMaxK],
                                           const float (&dk)[kMaxK][kVec], int k) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) {
    if (kk < k) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) s[i] = fmaf(w[kk], dk[kk][i], s[i]);
    }
  }
}

__device__ __forceinline__ void load_w(float (&w)[kMaxK], const float* p) {
#pragma unroll
  for (int kk = 0; kk < kMaxK; kk += 4) {
    const float4 t4 = *reinterpret_cast<const float4*>(p + kk);
    w[kk] = t4.x; w[kk + 1] = t4.y; w[kk + 2] = t4.z; w[kk + 3] = t4.w;
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

__global__ void __launch_bounds__(32) gather_wf_bwd_tiles_kernel(Args a) {
  static_assert(kTile <= kLocalMask + 1, "local source rows are packed in 6 bits");
  static_assert(kRing >= 2 && kRing <= 8 && (kVec == 1 || kVec == 2 || kVec == 4), "a cut");
  extern __shared__ __align__(16) float smem[];
  const int k = a.k;
  const int slot_floats = k * kWidth;
  float* s_acc = smem;                     // [kTile][kWidth]
  float* s_ring = s_acc + kTile * kWidth;  // [kRing][k][kWidth]
  float* s_w = s_ring + kRing * slot_floats;  // [2][32][kMaxK]
  const int lane = threadIdx.x;
  const int ntiles = (a.ns + kTile - 1) / kTile;
  const int nslices = (a.ac + kWidth - 1) / kWidth;
  const int nitems = a.batch * ntiles * nslices;
  float* col = s_acc + lane * kVec;
  float* ring_lane = s_ring + lane * kVec;

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
    const int* eb = a.ent + (long long)b * a.nq * a.h;
    const float* dwf_lane = a.dwf + (long long)b * a.nq * k * a.ac + (active ? c0 : 0);
    const float* infl_b = a.infl + (long long)b * a.nq * a.hs * k;
    const int e0 = a.off[(long long)b * (ntiles + 1) + t];
    const int e1 = a.off[(long long)b * (ntiles + 1) + t + 1];
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      const float z[kVec] = {};
      store_vec(col + r * kWidth, z);
    }
    // the batch being walked, the next (the influence rows of its entries
    // loading into wr) and the one after (loading)
    int cur = e0 + lane < e1 ? eb[e0 + lane] : -1;
    int nxt = e0 + 32 + lane < e1 ? eb[e0 + 32 + lane] : -1;
    float wr[kMaxK];
#if GATHER_WF_BWD_TILES_STAGE >= 1
    auto load_wr = [&](int e) {
      const float* row = infl_b + ((long long)(e >= 0 ? e >> kQShift : 0) * a.hs +
                                   ((e >> kHShift) & kHMask)) * k;
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) wr[kk] = e >= 0 && kk < k ? __ldg(row + kk) : 0.f;
    };
    load_wr(cur);
#endif
    // the ring: runs issued (one cp.async group each, run r in slot
    // r % kRing), the query of the last one issued, the run being walked
    int issued = 0, last_q = -1, run = -1, cur_q = -1;
    float dk[kMaxK][kVec];
    // issue runs while fewer than `limit` have been
    auto fill = [&](int limit) {
      while (issued < limit) {
        const int q = next_query(cur, nxt, last_q);
        if (q < 0) break;
        float* slot = ring_lane + (issued % kRing) * slot_floats;
        const float* src = dwf_lane + (long long)q * k * a.ac;
        for (int kk = 0; kk < k; ++kk) {
          cp_async(slot + kk * kWidth, src + (long long)kk * a.ac, active);
        }
        cp_async_commit();
        last_q = q;
        ++issued;
      }
    };
    fill(kRing - 1);
    for (int base = e0; base < e1; base += 32) {
      const int after = base + 64 + lane < e1 ? eb[base + 64 + lane] : -1;
      float* wb = s_w + ((base - e0) / 32 & 1) * 32 * kMaxK;
#if GATHER_WF_BWD_TILES_STAGE >= 1
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < kMaxK; kk += 4) {
        *reinterpret_cast<float4*>(wb + lane * kMaxK + kk) =
            make_float4(wr[kk], wr[kk + 1], wr[kk + 2], wr[kk + 3]);
      }
      __syncwarp();
      load_wr(nxt);
#endif
      const int n = min(32, e1 - base);
      for (int j = 0; j < n;) {
        const int e = __shfl_sync(kFull, cur, j);
        const int q = e >> kQShift;
        if (q != cur_q) {
          ++run;
          cur_q = q;
          // the run is issued (its first entry is in `cur`); the slot of the
          // run before is free, its rows in registers
          fill(run + kRing);
          cp_async_wait(issued - 1 - run);
          const float* slot = ring_lane + (run % kRing) * slot_floats;
#pragma unroll
          for (int kk = 0; kk < kMaxK; ++kk) {
            float v[kVec];
            if (kk < k) {
              load_vec(v, slot + kk * kWidth);
            } else {
#pragma unroll
              for (int i = 0; i < kVec; ++i) v[i] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < kVec; ++i) dk[kk][i] = v[i];
          }
#if GATHER_WF_BWD_TILES_STAGE == 0
          float acc[kVec];
          load_vec(acc, col);
#pragma unroll
          for (int kk = 0; kk < kMaxK; ++kk)
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[i] += dk[kk][i];
          store_vec(col, acc);
#endif
        }
#if GATHER_WF_BWD_TILES_STAGE == 0
        ++j;
#else
        // the next slot, taken with this one where it is of the same run
        const int e2 = __shfl_sync(kFull, cur, min(j + 1, 31));
        const bool pair = j + 1 < n && (e2 >> kQShift) == q;
        float w[kMaxK], s1[kVec];
        load_w(w, wb + j * kMaxK);
        float* sum = col + (e & kLocalMask) * kWidth;
        float acc[kVec];
#if GATHER_WF_BWD_TILES_STAGE == 1
        float ws = 0.f;
#pragma unroll
        for (int kk = 0; kk < kMaxK; ++kk) ws += w[kk];
#pragma unroll
        for (int i = 0; i < kVec; ++i) s1[i] = ws + dk[0][i];
        if (pair) {
          load_w(w, wb + (j + 1) * kMaxK);
          float ws2 = 0.f;
#pragma unroll
          for (int kk = 0; kk < kMaxK; ++kk) ws2 += w[kk];
#pragma unroll
          for (int i = 0; i < kVec; ++i) s1[i] += ws2;
        }
        load_vec(acc, sum);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] += s1[i];
        store_vec(sum, acc);
#else
        if (pair) {
          float w2[kMaxK], s2[kVec];
          load_w(w2, wb + (j + 1) * kMaxK);
#pragma unroll
          for (int i = 0; i < kVec; ++i) { s1[i] = 0.f; s2[i] = 0.f; }
#pragma unroll
          for (int kk = 0; kk < kMaxK; ++kk) {
            if (kk < k) {
#pragma unroll
              for (int i = 0; i < kVec; ++i) {
                s1[i] = fmaf(w[kk], dk[kk][i], s1[i]);
                s2[i] = fmaf(w2[kk], dk[kk][i], s2[i]);
              }
            }
          }
          float* sum2 = col + (e2 & kLocalMask) * kWidth;
          load_vec(acc, sum);
          if (sum2 == sum) {
            // one source row: its two values in slot order
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[i] = (acc[i] + s1[i]) + s2[i];
            store_vec(sum, acc);
          } else {
            float acc2[kVec];
            load_vec(acc2, sum2);
#pragma unroll
            for (int i = 0; i < kVec; ++i) { acc[i] += s1[i]; acc2[i] += s2[i]; }
            store_vec(sum, acc);
            store_vec(sum2, acc2);
          }
        } else {
          slot_value(s1, w, dk, k);
          load_vec(acc, sum);
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] += s1[i];
          store_vec(sum, acc);
        }
#endif
        j += pair ? 2 : 1;
#endif
      }
      cur = nxt;
      nxt = after;
    }
    if (active) {
      const int rows = min(kTile, a.ns - t * kTile);
      float* o = a.dx + ((long long)b * a.ns + (long long)t * kTile) * a.ac + c0;
      for (int r = 0; r < rows; ++r) {
        float v[kVec];
        load_vec(v, col + r * kWidth);
        store_vec(o + (long long)r * a.ac, v);
      }
    }
  }
}

// The tile plan, built from the reverse (CSR) index of the neighbour set
// (windowed_conv.reverse_index, which K9 and the first design read too), so
// a set takes one sort for both.  A tile's slots are its source rows' CSR
// lists, each ascending; the plan lists them merged in ascending order.  A
// warp takes one of kPlanSplit equal ranges of the values between the
// tile's smallest and largest slot: each lane walks the slots of its source
// rows (local rows lane, lane + 32, ...) from the first in the range (a
// binary search), the warp's first place in the plan is the tile's first
// place plus the lanes' slots below the range, and at each step the warp
// writes the smallest head among the lanes (__reduce_min_sync; a slot is
// one lane's), packed, the next two slots of each list loaded ahead.  The
// tile's entries take the places its sources hold in the CSR, so off[t] =
// offsets[t * kTile]; slots outside [0, Ns) are in no source's list and are
// left out, as in windowed_conv.tile_plan.
constexpr int kPlanSources = (kTile + 31) / 32;  // source rows a lane
// warps a tile: the tile's slots cluster where Morton order jumps, so equal
// value ranges hold unequal counts; 64 was the fastest of 8-64 over a real
// pair's seven sets (scripts/probe_gather_wf_bwd.py builds the others)
#ifndef GATHER_WF_BWD_PLAN_SPLIT
#define GATHER_WF_BWD_PLAN_SPLIT 64
#endif
constexpr int kPlanSplit = GATHER_WF_BWD_PLAN_SPLIT;
constexpr int kPlanWarps = 4;                     // warps a block

__global__ void __launch_bounds__(32 * kPlanWarps)
    tile_plan_kernel(const int* __restrict__ order, const int* __restrict__ offsets,
                     int* __restrict__ ent, int* __restrict__ off, int batch, int ns, int nqh,
                     int h) {
  constexpr int kNone = 0x7fffffff;
  const int ntiles = (ns + kTile - 1) / kTile;
  const int warp = blockIdx.x * kPlanWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= batch * ntiles * kPlanSplit) return;  // whole warps
  const int split = warp % kPlanSplit;
  const int b = warp / kPlanSplit / ntiles, t = warp / kPlanSplit % ntiles;
  const int* ob = offsets + (long long)b * (ns + 1);
  const int* rb = order + (long long)b * nqh;
  int* eb = ent + (long long)b * nqh;
  if (split == 0 && lane == 0) {
    off[(long long)b * (ntiles + 1) + t] = ob[t * kTile];
    if (t == ntiles - 1) off[(long long)b * (ntiles + 1) + ntiles] = ob[ns];
  }
  // each list: its start and end, the place of its head, its head and the
  // two after
  int start[kPlanSources], end[kPlanSources], pos[kPlanSources], head[kPlanSources],
      n1[kPlanSources], n2[kPlanSources];
  int lo = kNone, hi = -1;
#pragma unroll
  for (int i = 0; i < kPlanSources; ++i) {
    const int local = i * 32 + lane, s = t * kTile + local;
    const bool ok = local < kTile && s < ns;
    start[i] = ok ? ob[s] : 0;
    end[i] = ok ? ob[s + 1] : 0;
    if (start[i] < end[i]) {
      lo = min(lo, rb[start[i]]);
      hi = max(hi, rb[end[i] - 1]);
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (hi < 0) return;  // no slot in the tile
  // this warp's range of slot values, [lo, hi)
  const long long span = (long long)hi + 1 - lo;
  hi = lo + (int)(span * (split + 1) / kPlanSplit);
  lo = lo + (int)(span * split / kPlanSplit);
  int below = 0;
#pragma unroll
  for (int i = 0; i < kPlanSources; ++i) {
    int a = start[i], z = end[i];  // the first slot >= lo
    while (a < z) {
      const int mid = (a + z) >> 1;
      if (rb[mid] < lo) a = mid + 1; else z = mid;
    }
    pos[i] = a;
    below += a - start[i];
    head[i] = a < end[i] ? rb[a] : kNone;
    n1[i] = a + 1 < end[i] ? rb[a + 1] : kNone;
    n2[i] = a + 2 < end[i] ? rb[a + 2] : kNone;
  }
  int out = ob[t * kTile] + __reduce_add_sync(kFull, below);
  for (;; ++out) {
    int mine = head[0], which = 0;
#pragma unroll
    for (int i = 1; i < kPlanSources; ++i) {
      if (head[i] < mine) { mine = head[i]; which = i; }
    }
    const int m = __reduce_min_sync(kFull, mine);
    if (m >= hi) break;
    if (mine == m) {
      eb[out] = (m / h) << kQShift | (m % h) << kHShift | (which * 32 + lane);
#pragma unroll
      for (int i = 0; i < kPlanSources; ++i) {
        if (i == which) {
          ++pos[i];
          head[i] = n1[i];
          n1[i] = n2[i];
          n2[i] = pos[i] + 2 < end[i] ? rb[pos[i] + 2] : kNone;
        }
      }
    }
  }
}

inline int launch_tile_plan(const int* order, const int* offsets, int* ent, int* off, int batch,
                            int ns, int nq, int h, cudaStream_t st) {
  if (batch < 1 || ns < 1 || h < 1 || h > kHMask + 1 ||
      ((long long)nq << kQShift) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const long long warps = (long long)batch * ((ns + kTile - 1) / kTile) * kPlanSplit;
  const int grid = (int)((warps + kPlanWarps - 1) / kPlanWarps);
  tile_plan_kernel<<<grid, 32 * kPlanWarps, 0, st>>>(order, offsets, ent, off, batch, ns,
                                                     nq * h, h);
  return (int)cudaGetLastError();
}

inline bool valid(const Args& a) {
  return a.k >= 1 && a.k <= kMaxK && a.h >= 1 && a.h <= kHMask + 1 && a.hs >= a.h &&
         a.ac >= 4 && a.ac % 4 == 0 && ((long long)a.nq << kQShift) <= 0x7fffffffLL &&
         reinterpret_cast<uintptr_t>(a.dwf) % 16 == 0;
}

inline int launch(const Args& a, cudaStream_t st) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.k);
  cudaError_t e = cudaFuncSetAttribute(gather_wf_bwd_tiles_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_wf_bwd_tiles_kernel, 32,
                                                    smem);
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
  gather_wf_bwd_tiles_kernel<<<grid, 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace k8_tiles
