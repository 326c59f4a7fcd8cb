// Neighbour gather x influence contraction of the E2PN conv (K1).
//
//   wf[b, q, k, ac] = sum_h infl[b, q, h, k] * x[b, nbr[b, q, h], ac]
//
// with nbr == Ns a sentinel (the entry contributes nothing), sums in
// float32 rounded once to the feature type, and the influence read in place
// as (B, Nq, hs, K) with hs >= H (its first H columns).  Replaces the TPU
// kernel se3et_tpu/ops/pallas/windowed_conv.py windowed_gather_wf.
//
// Bound: device memory, and writing the output is most of it.  At the
// stage-2 serving conv (x (2, 2500, 768) bf16, H 36, K 15) wf is 115 MB
// against 14 MB of x, indices and influence; the gather also reads H * AC *
// 2 bytes per query from L2 (276 MB there: x is L2-resident), a second
// floor of about the same height at a few TB/s.
//
// The tensor-core form (tc::gather_wf_tc_kernel, bf16, H <= 64), the
// serving form; its body is gather_wf_tc.cuh gather_wf_tc_items, which
// K14's tc form takes too.  Every warp walks its own contiguous run of
// (query row, 32-channel chunk) items, so no warp waits for another and a
// warp's stores fill one contiguous stretch of wf:
//  * the row's influence is read once, in place, into registers as the A
//    fragments of an m16n8k16 mma.sync: A[kp][hh] = infl[row][hh][kp], K
//    padded to 16 and H to 16 * HS with zeros (HS 1-4, a template
//    parameter);
//  * the row's neighbour rows of the chunk are staged by 16-byte cp.async
//    into a 4-slot per-warp ring, three items ahead (across rows), with
//    sentinels zero-filled and the padding rows past H zeroed once; they
//    are read with ldmatrix.trans from 64-byte rows whose 16-byte units are
//    XOR-swizzled by row pair (conflict-free);
//  * per item the (16 x 16 HS) @ (16 HS x 32) product runs on the tensor
//    cores, and its float32 sums are rounded to bf16 into a per-warp
//    (16 x 32) shared tile, read back as 16-byte units and written with
//    streaming 16-byte stores (st.global.cs: wf does not fit in L2 and is
//    read back only by the next op): each of the K output rows of a chunk
//    is a 64-byte run, every 32-byte sector written whole by one warp
//    instruction.
// Blocks are 4 warps; as many are resident per SM as shared memory allows
// (13 KB a warp at HS 3), and the grid holds exactly that many.  At the
// stage 2-3 shapes (scripts/probe_gather_wf.py) 64-channel chunks (128-byte
// output runs: twice the ring per warp, half the warps per SM) ran 15-24 %
// slower, a 6-slot ring (fewer warps per SM) 40-50 % slower, and a 3-slot
// ring (two items ahead) the same: copies in flight are not the limit; the
// kernel moves 4.0-4.6 TB/s of gathered reads and output writes through L2.
//
// The rows form (rows::gather_wf_rows_kernel, float32 with K <= 16,
// H <= 64, AC a multiple of 4: every conv of the training step), bound by
// bytes like the tc form: at the stage-0 training conv (x (2, 20000, 192),
// H 24, K 15) wf is 461 MB against 46 MB of x, indices and influence.  The
// first design spent a shared-memory load on every FMA, walked every slot
// (74 % sentinels at stage 0) with one load in flight a thread, and staged
// 4 query rows a block behind a block barrier.  Here
//  * warps are persistent, no block barrier: warp w of n takes rows w,
//    w + n, .. and all the slices of each, so the warps in flight write
//    neighbouring rows of wf and gather from neighbouring sources (a
//    contiguous run of rows a warp ran 1.2 times longer over a step); a
//    slice is at most 32 16-byte units of the row, a lane one unit (4
//    channels) and its 4 x K float32 sums in registers (K = 15 compiled
//    apart, other K as 16), the slices of a row balanced (plan_for,
//    mirrored by ops/kernels/windowed_conv.py gather_wf_rows_plan);
//  * a row's H indices and its influence, K padded to 16 with zeros, are
//    staged by cp.async in the warp's shared memory, the next row's while
//    this one computes (two buffers a warp); a neighbour's influence is
//    read as 4 float4 broadcasts for 4 K FMAs;
//  * the valid slots are compacted by a ballot over the row's indices and
//    taken NB = 4 at a time: their rows' units loaded straight into
//    registers (16 bytes a lane), the next batch's loads issued before this
//    batch's FMAs; a sentinel costs no load;
//  * wf goes out by 16-byte streaming stores (st.global.cs: it does not fit
//    in L2 and is read back only by the weight product);
//  * 128 registers a thread (a few bytes spilled), so 16 warps an SM: 154
//    without the cap (12 warps) ran 6 % slower over a step.
// Each (q, k, channel) sum is the first design's chain: 0.f, then fmaf over
// the valid h in ascending order, so wf is the first design's bits.  Over
// a step's ten launches it takes 1.61 times the bytes bound; at stages 2-3
// the gathered loads and the FMAs add up rather than overlap
// (scripts/probe_gather_wf_f32.py, PERF.md).  The probe builds copies with
// other cuts (-DGATHER_WF_ROWS_NB, _PIPE, _WARPS, _MINB, _ORDER) and cut at
// one stage by GATHER_WF_ROWS_STAGE (wrong outputs, timing only): 0 the wf
// stream alone (no gather), 1 the gather alone (no stores), 2 the whole
// form (the default), 3 the loads and stores without the FMAs.
//
// The first design (gather_wf_kernel, float32 outside the rows form's
// limits, and bf16 for H > 64): a block takes kQB query
// rows; their neighbour indices and influence rows are staged in shared
// memory, and each thread owns one (query, channel) column, keeps the K
// sums in registers (fp32) and streams the H neighbour values of its
// channel, so that a warp reads AC-contiguous runs of one row.
#include "attention_common.cuh"
#include "gather_wf_tc.cuh"

namespace {

constexpr int kMaxK = 16;
constexpr int kQB = 4;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void gather_wf_kernel(const T* __restrict__ x, const int* __restrict__ nbr,
                                 const T* __restrict__ infl, T* __restrict__ out,
                                 int ns, int nq, int h, int hs, int k, int ac) {
  extern __shared__ float smem[];
  float* s_w = smem;                                  // [kQB][h][k]
  int* s_nbr = reinterpret_cast<int*>(s_w + kQB * h * k);  // [kQB][h]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQB;
  const int nrows = min(kQB, nq - q0);
  const long long row0 = (long long)b * nq + q0;

  for (int i = threadIdx.x; i < nrows * h; i += blockDim.x) {
    s_nbr[i] = nbr[row0 * h + i];
  }
  for (int i = threadIdx.x; i < nrows * h * k; i += blockDim.x) {
    const int ql = i / (h * k);
    s_w[i] = to_f(infl[(row0 + ql) * hs * k + (i - ql * h * k)]);
  }
  __syncthreads();

  const T* xb = x + (long long)b * ns * ac;
  for (int item = threadIdx.x; item < nrows * ac; item += blockDim.x) {
    const int ql = item / ac;
    const int c = item - ql * ac;
    float acc[kMaxK];
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) acc[kk] = 0.f;
    const int* rn = s_nbr + ql * h;
    const float* rw = s_w + ql * h * k;
    for (int hh = 0; hh < h; ++hh) {
      const int j = rn[hh];
      if (j >= ns || j < 0) continue;
      const float xv = to_f(xb[(long long)j * ac + c]);
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < k) acc[kk] = fmaf(rw[hh * k + kk], xv, acc[kk]);
      }
    }
    T* o = out + (row0 + ql) * (long long)k * ac + c;
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) {
      if (kk < k) store(o + (long long)kk * ac, acc[kk]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* nbr, const void* infl, void* out, int batch,
           int ns, int nq, int h, int hs, int k, int ac, void* stream) {
  if (k > kMaxK || k < 1 || h < 1 || hs < h) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kQB * h * (k * sizeof(float) + sizeof(int));
  dim3 grid((nq + kQB - 1) / kQB, batch);
  gather_wf_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const int*)nbr, (const T*)infl, (T*)out, ns, nq, h, hs, k, ac);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core form (bf16, H <= 64).  Rows are the flattened (b, q) rows
// of nbr / infl / out; items the (row, chunk) pairs in row-major order.
namespace tc {

using bf16 = __nv_bfloat16;

// the tiling (scripts/probe_gather_wf.py builds copies of this source with
// these constants and swz changed)
constexpr int kWarps = 4;               // warps per block (each independent)
constexpr int kThreads = kWarps * 32;
constexpr int kCW = 32;                 // channels per chunk: one 64-byte shared row
constexpr int kStages = 4;              // ring slots per warp
constexpr int kMaxHS = 4;               // H <= 16 * kMaxHS

// element offset of channel c (0..31) in row r of a tile of 64-byte rows,
// 16-byte units XOR-swizzled by row pair: the 8 rows an ldmatrix phase
// reads, and the rows a fragment store writes, hit 32 distinct banks
__device__ __forceinline__ int swz(int r, int c) {
  return se3et::wf_swz32(r, c);
}

// the tiling as gather_wf_tc.cuh takes it (at these constants
// se3et::WfTile)
struct Tile {
  static constexpr int cw = kCW, stages = kStages;
  static __device__ __forceinline__ int at(int r, int c) { return swz(r, c); }
};

template <int HS>
__host__ __device__ constexpr size_t warp_smem() {
  return se3et::wf_warp_smem<Tile, HS>();
}

// every warp takes its own contiguous run of the items
template <int HS>
__global__ void __launch_bounds__(kThreads)
gather_wf_tc_kernel(const bf16* __restrict__ x, const int* __restrict__ nbr,
                    const bf16* __restrict__ infl, bf16* __restrict__ out, int ns, int nq,
                    int h, int hs, int k, int ac, int nchunks, int items, int nwarps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  se3et::gather_wf_tc_items<Tile, HS>(x, nbr, infl, out, ns, nq, h, hs, k, ac, nchunks,
                                      (int)(items * gw / nwarps),
                                      (int)(items * (gw + 1) / nwarps),
                                      smem + warp * warp_smem<HS>(), threadIdx.x & 31);
}

template <int HS>
int launch_hs(const void* x, const void* nbr, const void* infl, void* out, int ns, int nq,
              int rows, int h, int hs, int k, int ac, cudaStream_t stream) {
  auto fn = gather_wf_tc_kernel<HS>;
  const size_t smem = kWarps * warp_smem<HS>();
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // blocks resident per SM, found once per form (the grid holds that many)
  static int per_sm = 0;
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int nchunks = (ac + kCW - 1) / kCW;
  const long long items = (long long)rows * nchunks;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // every warp takes at least 4 items where there are that few
  const long long want = (items + 4 * kWarps - 1) / (4 * kWarps);
  const int nblocks = (int)(want < (long long)per_sm * sms ? want : (long long)per_sm * sms);
  fn<<<nblocks, kThreads, smem, stream>>>((const bf16*)x, (const int*)nbr, (const bf16*)infl,
                                          (bf16*)out, ns, nq, h, hs, k, ac, nchunks,
                                          (int)items, nblocks * kWarps);
  return (int)cudaGetLastError();
}

int launch(const void* x, const void* nbr, const void* infl, void* out, int batch, int ns,
           int nq, int h, int hs, int k, int ac, void* stream) {
  if (k < 1 || k > kMaxK || h < 1 || h > 16 * kMaxHS || hs < h || ac < 8 || ac % 8 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  const int rows = batch * nq;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((h + 15) / 16) {
    case 1: return launch_hs<1>(x, nbr, infl, out, ns, nq, rows, h, hs, k, ac, st);
    case 2: return launch_hs<2>(x, nbr, infl, out, ns, nq, rows, h, hs, k, ac, st);
    case 3: return launch_hs<3>(x, nbr, infl, out, ns, nq, rows, h, hs, k, ac, st);
    default: return launch_hs<4>(x, nbr, infl, out, ns, nq, rows, h, hs, k, ac, st);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The rows form (float32).  Rows are the flattened (b, q) rows of nbr /
// infl / out; items the (row, slice) pairs.
#ifndef GATHER_WF_ROWS_STAGE
#define GATHER_WF_ROWS_STAGE 2
#endif
#ifndef GATHER_WF_ROWS_NB
#define GATHER_WF_ROWS_NB 4
#endif
#ifndef GATHER_WF_ROWS_WARPS
#define GATHER_WF_ROWS_WARPS 4
#endif
#ifndef GATHER_WF_ROWS_ORDER
#define GATHER_WF_ROWS_ORDER 1
#endif
#ifndef GATHER_WF_ROWS_PIPE
#define GATHER_WF_ROWS_PIPE 1
#endif
#ifndef GATHER_WF_ROWS_MINB
#define GATHER_WF_ROWS_MINB 4
#endif
#ifndef GATHER_WF_ROWS_K15
#define GATHER_WF_ROWS_K15 1
#endif

namespace rows {

constexpr int kWarps = GATHER_WF_ROWS_WARPS;  // warps per block (each independent)
constexpr int kThreads = kWarps * 32;
constexpr int kNB = GATHER_WF_ROWS_NB;        // valid neighbour rows in flight a lane
constexpr int kMaxH = 64;                     // two 32-slot ballot words
constexpr int kKP = 16;                       // K padded

struct Plan {
  int form, slices, width;  // form 1 where the rows form takes the shape, else 0
};

// slices of a row and 16-byte units a slice (at most 32, balanced)
Plan plan_for(int h, int k, int ac) {
  if (k < 1 || k > kKP || h < 1 || h > kMaxH || ac < 4 || ac % 4) return {0, 0, 0};
  const int units = ac / 4;
  const int slices = (units + 31) / 32;
  return {1, slices, (units + slices - 1) / slices};
}

// 4-byte words of one staged row: its (H, 16) influence, then its H
// indices, rounded up to 16 bytes
__host__ __device__ constexpr int row_words(int h) { return h * kKP + ((h + 3) & ~3); }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(gmem), "r"(ok ? 4 : 0));
}

// row `row`'s influence (zero past k) and indices into `buf` by cp.async,
// uncommitted
__device__ __forceinline__ void stage_row(float* buf, const int* nbr, const float* infl,
                                          long long row, int h, int hs, int k, int lane) {
  const float* w = infl + row * hs * k;
  for (int i = lane; i < h * kKP; i += 32) {
    const int kk = i & (kKP - 1);
    const bool ok = kk < k;
    cp_async4(buf + i, ok ? w + (i >> 4) * k + kk : w, ok);
  }
  const int* idx = nbr + row * h;
  for (int i = lane; i < h; i += 32) cp_async4(buf + h * kKP + i, idx + i, true);
}

// pop up to kNB valid slots off `m` (ascending) and load this lane's unit of
// their source rows (none for an empty entry, hn -1, or an idle lane)
__device__ __forceinline__ void load_batch(float4 (&v)[kNB], int (&hn)[kNB],
                                           unsigned long long& m, const int* idx,
                                           const float4* xb, int units, int u, bool active) {
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    hn[j] = m ? __ffsll((long long)m) - 1 : -1;
    m &= m - 1;
    v[j] = hn[j] >= 0 && active ? __ldg(xb + (long long)idx[hn[j]] * units + u)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the batch's FMAs, slot by slot in ascending order: acc[kk][c] =
// fmaf(w[h][kk], x[h][c], acc[kk][c]), the first design's chain
template <int KC>
__device__ __forceinline__ void take_batch(float (&acc)[KC][4], const float4 (&v)[kNB],
                                           const int (&hn)[kNB], const float* w) {
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    if (hn[j] < 0) break;  // the same for every lane
#if GATHER_WF_ROWS_STAGE == 3
    // diagnostic: the loads without the FMAs
    acc[0][0] += v[j].x; acc[0][1] += v[j].y; acc[0][2] += v[j].z; acc[0][3] += v[j].w;
#else
    const float4* wr = reinterpret_cast<const float4*>(w + hn[j] * kKP);
#pragma unroll
    for (int q = 0; q < (KC + 3) / 4; ++q) {
      const float4 t = wr[q];
      const float wq[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * q + e < KC) {
          acc[4 * q + e][0] = fmaf(wq[e], v[j].x, acc[4 * q + e][0]);
          acc[4 * q + e][1] = fmaf(wq[e], v[j].y, acc[4 * q + e][1]);
          acc[4 * q + e][2] = fmaf(wq[e], v[j].z, acc[4 * q + e][2]);
          acc[4 * q + e][3] = fmaf(wq[e], v[j].w, acc[4 * q + e][3]);
        }
      }
    }
#endif
  }
}

// every warp takes its own run of the items: its rows gw, gw + nwarps, ..
// with all their slices (ORDER 1), or a contiguous run (ORDER 0).  KC sums
// a lane's channel: 15 (the model's K) or 16 (any K <= 16, the rest zero)
template <int KC>
__global__ void __launch_bounds__(kThreads, GATHER_WF_ROWS_MINB)
gather_wf_rows_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                      const float* __restrict__ infl, float* __restrict__ out, int ns, int nq,
                      int h, int hs, int k, int ac, int slices, int width, int items,
                      int nwarps) {
  extern __shared__ __align__(16) float smem_rows[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
#if GATHER_WF_ROWS_ORDER == 0
  const int i0 = (int)(items * gw / nwarps), i1 = (int)(items * (gw + 1) / nwarps);
  if (i0 >= i1) return;
  const int rstep = 1, r_last = (i1 - 1) / slices;
  int r = i0 / slices, s = i0 - r * slices, n = i1 - i0;
#else
  const int rows = items / slices;
  if (gw >= rows) return;
  const int rstep = nwarps, r_last = (int)gw + (rows - 1 - (int)gw) / nwarps * nwarps;
  int r = (int)gw, s = 0, n = (r_last - r) / nwarps * slices + slices;
#endif
  const int words = row_words(h), units = ac >> 2;
  float* bufs = smem_rows + 2 * words * warp;  // this row's buffer and the next's
  stage_row(bufs, nbr, infl, r, h, hs, k, lane);
  se3et::cp_async_commit();
  const float* w = bufs;  // the current row's influence, then its indices
  const int* idx = nullptr;
  const float4* xb = nullptr;
  unsigned long long valid = 0ull;
  int buf = 0;
  bool fresh = true;  // the item starts a row
  for (; n > 0; --n) {
    if (fresh) {
      __syncwarp();  // every lane is done with the buffer the next row takes
      if (r + rstep <= r_last)
        stage_row(bufs + (buf ^ 1) * words, nbr, infl, r + rstep, h, hs, k, lane);
      se3et::cp_async_commit();
      se3et::cp_async_wait<1>();
      __syncwarp();
      w = bufs + buf * words;
      idx = reinterpret_cast<const int*>(w + h * kKP);
      const int ja = lane < h ? idx[lane] : ns, jb = lane + 32 < h ? idx[lane + 32] : ns;
      valid = (unsigned long long)__ballot_sync(0xffffffffu, ja >= 0 && ja < ns) |
              (unsigned long long)__ballot_sync(0xffffffffu, jb >= 0 && jb < ns) << 32;
      xb = reinterpret_cast<const float4*>(x) + (long long)(r / nq) * ns * units;
    }
    const int u = s * width + lane;  // this lane's unit
    const bool active = lane < width && u < units;
    float acc[KC][4];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) acc[kk][0] = acc[kk][1] = acc[kk][2] = acc[kk][3] = 0.f;
#if GATHER_WF_ROWS_STAGE >= 1
    unsigned long long m = valid;
#if GATHER_WF_ROWS_PIPE
    // two batches: the next one's loads in flight while this one's FMAs run
    float4 va[kNB], vb[kNB];
    int ha[kNB], hb[kNB];
    load_batch(va, ha, m, idx, xb, units, u, active);
    while (ha[0] >= 0) {
      load_batch(vb, hb, m, idx, xb, units, u, active);
      take_batch<KC>(acc, va, ha, w);
      if (hb[0] < 0) break;
      load_batch(va, ha, m, idx, xb, units, u, active);
      take_batch<KC>(acc, vb, hb, w);
    }
#else
    while (m) {
      float4 v[kNB];
      int hn[kNB];
      load_batch(v, hn, m, idx, xb, units, u, active);
      take_batch<KC>(acc, v, hn, w);
    }
#endif
#endif
#if GATHER_WF_ROWS_STAGE == 1
    if (active && ns < 0) {  // never: the gather without the stores
#else
    if (active) {
#endif
      float* o = out + (long long)r * k * ac + 4 * u;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        if (kk < k)
          __stcs(reinterpret_cast<float4*>(o + (long long)kk * ac),
                 make_float4(acc[kk][0], acc[kk][1], acc[kk][2], acc[kk][3]));
    }
    fresh = ++s == slices;
    if (fresh) {
      s = 0;
      r += rstep;
      buf ^= 1;
    }
  }
  se3et::cp_async_wait<0>();
}

template <int KC>
int launch_kc(const void* x, const void* nbr, const void* infl, void* out, int ns, int nq,
              int h, int hs, int k, int ac, const Plan& p, long long items,
              cudaStream_t stream) {
  auto fn = gather_wf_rows_kernel<KC>;
  const size_t smem = (size_t)kWarps * 2 * row_words(h) * sizeof(float);
  // blocks resident per SM, found once for each H (the grid holds that many)
  static int per_sm[kMaxH + 1] = {};
  cudaError_t e;
  if (per_sm[h] == 0) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(kWarps * 2 * row_words(kMaxH) * sizeof(float)));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[h], fn, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm[h] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // every warp takes at least 4 items where there are that few
  const long long want = (items + 4 * kWarps - 1) / (4 * kWarps);
  const int nblocks = (int)(want < (long long)per_sm[h] * sms ? want : (long long)per_sm[h] * sms);
  fn<<<nblocks, kThreads, smem, stream>>>((const float*)x, (const int*)nbr, (const float*)infl,
                                          (float*)out, ns, nq, h, hs, k, ac, p.slices, p.width,
                                          (int)items, nblocks * kWarps);
  return (int)cudaGetLastError();
}

int launch(const void* x, const void* nbr, const void* infl, void* out, int batch, int ns,
           int nq, int h, int hs, int k, int ac, void* stream) {
  const Plan p = plan_for(h, k, ac);
  if (!p.form || hs < h || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  const long long items = (long long)batch * nq * p.slices;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#if GATHER_WF_ROWS_K15
  if (k == 15) return launch_kc<15>(x, nbr, infl, out, ns, nq, h, hs, k, ac, p, items, st);
#endif
  return launch_kc<16>(x, nbr, infl, out, ns, nq, h, hs, k, ac, p, items, st);
}

}  // namespace rows

}  // namespace

// K1 in bf16 on the tensor cores, H <= 64, AC a multiple of 8, x and out
// 16-byte aligned; influence (B, Nq, hs, K) read in place (its first h
// columns)
extern "C" int se3et_gather_wf_tc_bf16(const void* x, const void* nbr, const void* infl,
                                       void* out, int batch, int ns, int nq, int h, int hs,
                                       int k, int ac, void* stream) {
  return tc::launch(x, nbr, infl, out, batch, ns, nq, h, hs, k, ac, stream);
}

// K1 in float32, the rows form: K <= 16, H <= 64, AC a multiple of 4, x and
// out 16-byte aligned (else cudaErrorInvalidValue without launching);
// influence (B, Nq, hs, K) read in place (its first h columns)
extern "C" int se3et_gather_wf_rows_f32(const void* x, const void* nbr, const void* infl,
                                        void* out, int batch, int ns, int nq, int h, int hs,
                                        int k, int ac, void* stream) {
  return rows::launch(x, nbr, infl, out, batch, ns, nq, h, hs, k, ac, stream);
}

// The rows form's plan for H neighbours, K kernel points and AC channels:
// fills plan[0..1] with the slices of a row and the 16-byte units of a
// slice; returns 1 where the rows form takes the shape, else 0 (and zeros)
extern "C" int se3et_gather_wf_rows_plan(int h, int k, int ac, int* plan) {
  const rows::Plan p = rows::plan_for(h, k, ac);
  plan[0] = p.slices;
  plan[1] = p.width;
  return p.form;
}

// the first design in bf16 (H > 64) and float32
extern "C" int se3et_gather_wf_bf16(const void* x, const void* nbr, const void* infl,
                                    void* out, int batch, int ns, int nq, int h, int hs, int k,
                                    int ac, void* stream) {
  return launch<__nv_bfloat16>(x, nbr, infl, out, batch, ns, nq, h, hs, k, ac, stream);
}

extern "C" int se3et_gather_wf_f32(const void* x, const void* nbr, const void* infl,
                                   void* out, int batch, int ns, int nq, int h, int hs, int k,
                                   int ac, void* stream) {
  return launch<float>(x, nbr, infl, out, batch, ns, nq, h, hs, k, ac, stream);
}
