// E2PN conv gather x influence contraction and the strided skip's
// neighbour max over the same neighbour indices, in one launch (K14).
//
//   wf[b, q, k, ac]     = sum_h infl[b, q, h, k] * x[b, nbr[b, q, h], ac]
//   pooled[b, q, ac2]   = max_h (nbr valid ? x2[b, nbr[b, q, h], ac2] : 0)
//
// with nbr == Ns a sentinel (no contribution to wf, a zero row in the max).
// Replaces the TPU kernel se3et_tpu/ops/pallas/windowed_conv.py
// windowed_gather_wf_max; the weight product follows as a torch.matmul, as
// the JAX package leaves it to XLA.
//
// Bound: device memory.  At the serving shape (the s1 -> s2 strided block:
// x (2, 10000, 384), nbr (2, 2500, 32), K 15, skip (2, 10000, 1536), bf16)
// the unique bytes are ~155 MB (wf 57.6 MB written, the skip 61.4 MB read,
// x and pooled 15.4 MB each), at about one operation per byte; the gathers
// re-read up to 123 MB (conv) and 491 MB (skip, were every slot valid)
// from L2.  The two outputs share only the index rows, so the fusion is
// horizontal: one launch instead of K1's and K2's, whose work overlaps.
// Two forms, chosen by shape alone (se3et_gather_wf_max_plan, mirrored by
// ops/kernels/windowed_conv.py gather_wf_max_plan):
//
// "tc" (tc::gather_wf_max_tc_kernel: bf16, H <= 64, AC and AC2 multiples of
// 8, every pointer 16-byte aligned).  Two kinds of work item: conv items
// (flattened query row, 32-channel chunk), taken by K1's tensor-core
// routine (gather_wf_tc.cuh gather_wf_tc_items: the influence as mma.sync A
// fragments, a per-warp cp.async ring of neighbour rows, ldmatrix.trans,
// streaming 16-byte stores), so that wf equals K1's tc form bit for bit;
// and skip items (flattened query row, slice of 32 x SU 16-byte units of
// the payload row), taken by K2's routine (skip_max.cuh skip_row_max: the
// index row read from global memory, NB valid neighbour rows' units loaded
// straight into registers, no load for a sentinel), so that pooled equals
// K2's bit for bit.  The skip plan is K2's rows plan (SU <= 3 units a lane,
// a row's slices balanced, NB = 12 / SU rows in flight; SU 3, two slices a
// row at 1536 channels).  Layout: a persistent grid of 4-warp blocks, as
// many as registers and shared memory let reside (a 3-slot ring, 7 KB a
// warp at H <= 32; 102 registers at the serving shape, 4 blocks an SM).
// Every warp walks its own contiguous run of conv items (their cost hardly
// depends on the data), then takes skip items, whose cost does (a row's
// valid neighbours): item w of the n warps first, then one at a time from
// a counter in global memory (an atomicAdd an item, the next taken before
// the current one is pooled; the launch zeroes it by a memset first), so
// that a warp whose items held few valid neighbours takes more.  Chosen by
// measurement (scripts/probe_gather_wf_max.py, PERF.md): each warp's own
// run of skip items after its conv run left the warps with the densest
// rows last (1.3x the queue's time on pair 0's neighbours), as did odd
// warps taking theirs first; a grid split into conv blocks and skip blocks
// and blocks of 4 conv warps beside 2 or 4 skip warps ran 1.4-1.6x; items
// w, w + n, .. without a counter ran within a few per cent of the queue
// (ahead on uniform neighbours, behind on pair 0's), a 4-slot ring and
// capping the registers at 80 (6 blocks an SM) the same or slower.
//
// "first", the first design (float32 for the card-vs-CPU checks, bf16 for H
// > 64 or AC not a multiple of 8): a block takes kQB query rows and
// stages their neighbour indices and influence rows in shared memory once;
// then each thread owns one (query, channel) column of the conv, keeps its
// K sums in registers and streams its H neighbour values (the arithmetic of
// K1's first design, so wf equals that form's output bit for bit).  For the
// skip, each thread owns up to kGroups groups of 8 payload channels and
// keeps their maxima in registers through one pass over the neighbour
// slots (the max in K2's order, bit-identical to it).  That register budget
// bounds the payload: kQB * A*C2 <= kGroups * 8 * kThreads, A*C2 <= 1536;
// a wider skip (the s2 -> s3 block, 3072 channels) pools in K2, as the JAX
// package pools it in windowed_max_pool there.
#include "attention_common.cuh"
#include "gather_wf_tc.cuh"
#include "skip_max.cuh"

namespace {

using se3et::Elem;

constexpr int kTc = 1, kFirst = 2;  // form codes, as windowed_conv.GATHER_WF_MAX_FORMS

// the first design
constexpr int kMaxK = 16;
constexpr int kQB = 4;
constexpr int kThreads = 128;
constexpr int kGroups = 6;  // 8-channel skip groups per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void gather_wf_max_kernel(const T* __restrict__ x, const int* __restrict__ nbr,
                                     const T* __restrict__ infl, T* __restrict__ wf,
                                     const T* __restrict__ x2, T* __restrict__ pooled, int ns,
                                     int nq, int h, int k, int ac, int ac2) {
  extern __shared__ float smem[];
  float* s_w = smem;                                       // [kQB][h][k]
  int* s_nbr = reinterpret_cast<int*>(s_w + kQB * h * k);  // [kQB][h]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQB;
  const int nrows = min(kQB, nq - q0);
  const long long row0 = (long long)b * nq + q0;

  for (int i = threadIdx.x; i < nrows * h; i += blockDim.x) {
    s_nbr[i] = nbr[row0 * h + i];
  }
  for (int i = threadIdx.x; i < nrows * h * k; i += blockDim.x) {
    s_w[i] = to_f(infl[row0 * h * k + i]);
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
    T* o = wf + (row0 + ql) * (long long)k * ac + c;
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) {
      if (kk < k) store(o + (long long)kk * ac, acc[kk]);
    }
  }

  const T* x2b = x2 + (long long)b * ns * ac2;
  const int ng = ac2 / 8;
  float m[kGroups][8];
#pragma unroll
  for (int i = 0; i < kGroups; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) m[i][e] = __int_as_float(0xff800000);  // -inf
  for (int hh = 0; hh < h; ++hh) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int item = threadIdx.x + i * kThreads;
      if (item >= nrows * ng) continue;
      const int ql = item / ng;
      const int j = s_nbr[ql * h + hh];
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < ns && j >= 0) Elem<T>::load8(x2b + (long long)j * ac2 + (item - ql * ng) * 8, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) m[i][e] = fmaxf(m[i][e], v[e]);
    }
  }
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int item = threadIdx.x + i * kThreads;
    if (item >= nrows * ng) continue;
    const int ql = item / ng;
    T* o = pooled + (row0 + ql) * (long long)ac2 + (item - ql * ng) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) store(o + e, m[i][e]);
  }
}

template <typename T>
int launch_first(const void* x, const void* nbr, const void* infl, void* wf, const void* x2,
                 void* pooled, int batch, int ns, int nq, int h, int k, int ac, int ac2,
                 void* stream) {
  if (k > kMaxK || k < 1 || h < 1 || ac < 1 || ac2 < 8 || ac2 % 8 ||
      kQB * ac2 > kGroups * 8 * kThreads)
    return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  const size_t smem = (size_t)kQB * h * (k * sizeof(float) + sizeof(int));
  dim3 grid((nq + kQB - 1) / kQB, batch);
  gather_wf_max_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const int*)nbr, (const T*)infl, (T*)wf, (const T*)x2, (T*)pooled, ns, nq,
      h, k, ac, ac2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tc form.  Rows are the flattened (b, q) rows of nbr / infl / wf /
// pooled; conv items (row, chunk) and skip items (row, slice), each in
// row-major order.
namespace tc {

using bf16 = __nv_bfloat16;
using Ring4 = se3et::WfTile;  // K1's tiling: 32-channel chunks, a 4-slot ring

// the serving tiling: K1's chunks and swizzle on a 3-slot ring (7 KB a warp
// at HS 2)
struct Ring3 {
  static constexpr int cw = 32, stages = 3;
  static __device__ __forceinline__ int at(int r, int c) { return se3et::wf_swz32(r, c); }
};

constexpr int kConvWarps = 4;    // warps of a block with a ring
constexpr int kMaxHS = 4;        // H <= 16 * kMaxHS
constexpr int kMaxSU = 3;        // 16-byte payload units a lane of a slice (K2's plan)
constexpr int kLoadWords = 48;   // registers of loads in flight a lane: NB = 48 / (4 SU)

// layouts of the two kinds of work (scripts/probe_gather_wf_max.py): every
// warp its conv run then its skip run (serial), or odd warps the skip run
// first (alternate), or after its conv run the skip items w, w + n, ..
// (strided), or skip items taken one at a time from a counter (queue), or
// item w first and then the counter's (queue1); conv blocks and skip
// blocks in one grid (split); blocks of kConvWarps conv warps and SW skip
// warps (roles)
constexpr int kSerial = 0, kAlternate = 1, kSplit = 2, kRoles = 3, kStrided = 4, kQueue = 5,
              kQueue1 = 6;
// variants of the probe (bits): the 3-slot ring (else 4 slots), at most 80
// registers (6 blocks an SM)
constexpr int kRing3 = 1, kMinBlocks6 = 2;

struct Plan {
  int form, hs, chunks, su, slices, nb;
};

Plan plan_for(int h, int ac, int ac2, int elem_bytes) {
  if (elem_bytes != 2 || h < 1 || h > 16 * kMaxHS || ac < 8 || ac % 8 || ac2 < 8 || ac2 % 8)
    return {kFirst, 0, 0, 0, 0, 0};
  const int units = ac2 / 8;
  const int slices = (units + 32 * kMaxSU - 1) / (32 * kMaxSU);
  const int su = (units + 32 * slices - 1) / (32 * slices);  // the slices balanced
  return {kTc, (h + 15) / 16, (ac + Ring3::cw - 1) / Ring3::cw, su, slices,
          kLoadWords / (4 * su)};
}

struct Args {
  const bf16* x;
  const int* nbr;
  const bf16* infl;
  bf16* wf;
  const bf16* x2;
  bf16* pooled;
  int* work;  // the queue's counter, zeroed by the launch (queue layouts only)
  int ns, nq, h, hs, k, ac, units2, nchunks, slices, conv_items, skip_items, conv_blocks;
};

template <int HS, int SU, int NB, int L, int SW = 0, class T = Ring4, int MINB = 1>
__global__ void __launch_bounds__((kConvWarps + SW) * 32, MINB)
gather_wf_max_tc_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // conv items of run w of n (warps with a ring only)
  auto conv = [&](long long w, long long n) {
    se3et::gather_wf_tc_items<T, HS>(a.x, a.nbr, a.infl, a.wf, a.ns, a.nq, a.h, a.hs, a.k, a.ac,
                                     a.nchunks, (int)(a.conv_items * w / n),
                                     (int)(a.conv_items * (w + 1) / n),
                                     smem + warp * se3et::wf_warp_smem<T, HS>(), lane);
  };
  auto skip_item = [&](long long s) {
    const long long row = s / a.slices;
    const int slice = (int)(s - row * a.slices);
    se3et::skip_row_max<bf16, SU, NB>(
        reinterpret_cast<const uint4*>(a.x2) + row / a.nq * a.ns * a.units2, a.nbr + row * a.h,
        a.h, a.ns, a.units2, slice * 32 * SU, reinterpret_cast<uint4*>(a.pooled) + row * a.units2,
        true, lane);
  };
  // skip items of run w of n
  auto skip = [&](long long w, long long n) {
    const long long s1 = a.skip_items * (w + 1) / n;
#pragma unroll 1
    for (long long s = a.skip_items * w / n; s < s1; ++s) skip_item(s);
  };
  if constexpr (L == kSplit) {
    const int cb = a.conv_blocks;
    if ((int)blockIdx.x < cb)
      conv((long long)blockIdx.x * kConvWarps + warp, (long long)cb * kConvWarps);
    else
      skip((long long)(blockIdx.x - cb) * kConvWarps + warp,
           (long long)(gridDim.x - cb) * kConvWarps);
  } else if constexpr (L == kRoles) {
    if (warp < kConvWarps)
      conv((long long)blockIdx.x * kConvWarps + warp, (long long)gridDim.x * kConvWarps);
    else
      skip((long long)blockIdx.x * SW + warp - kConvWarps, (long long)gridDim.x * SW);
  } else {
    const long long w = (long long)blockIdx.x * kConvWarps + warp;
    const long long n = (long long)gridDim.x * kConvWarps;
    if (L == kAlternate && (w & 1)) {
      skip(w, n);
      conv(w, n);
      return;
    }
    conv(w, n);
    if constexpr (L == kStrided) {
#pragma unroll 1
      for (long long s = w; s < a.skip_items; s += n) skip_item(s);
    } else if constexpr (L == kQueue || L == kQueue1) {
      // the next item is taken before the current one is pooled
      int s = (int)w;
      if constexpr (L == kQueue) {
        if (lane == 0) s = atomicAdd(a.work, 1);
        s = __shfl_sync(0xffffffffu, s, 0);
      }
      const int base = L == kQueue1 ? (int)n : 0;
#pragma unroll 1
      while (s < a.skip_items) {
        int next = 0;
        if (lane == 0) next = atomicAdd(a.work, 1);
        skip_item(s);
        s = base + __shfl_sync(0xffffffffu, next, 0);
      }
    } else {
      skip(w, n);
    }
  }
}

// One launch of an instance.  The grid: as many blocks as are resident at
// once (found once per instance), fewer where the items are fewer than 4
// a warp; the split layout gives conv_permille of them to the conv.
template <int HS, int SU, int NB, int L, int SW = 0, class T = Ring4, int MINB = 1>
int launch_with(Args a, int rows, int conv_permille, cudaStream_t stream) {
  auto fn = gather_wf_max_tc_kernel<HS, SU, NB, L, SW, T, MINB>;
  constexpr int threads = (kConvWarps + SW) * 32;
  const size_t smem = kConvWarps * se3et::wf_warp_smem<T, HS>();
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  static int per_sm = 0;
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long conv_items = (long long)rows * a.nchunks;
  const long long skip_items = (long long)rows * a.slices;
  if (conv_items > 0x7fffffffLL || skip_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.conv_items = (int)conv_items;
  a.skip_items = (int)skip_items;
  const long long most = conv_items > skip_items ? conv_items : skip_items;
  const long long want = (most + 4 * kConvWarps - 1) / (4 * kConvWarps);
  long long nblocks = want < (long long)per_sm * sms ? want : (long long)per_sm * sms;
  if (L == kQueue || L == kQueue1) {
    e = cudaMemsetAsync(a.work, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (L == kSplit) {
    if (nblocks < 2) nblocks = 2;
    long long cb = (nblocks * conv_permille + 500) / 1000;
    a.conv_blocks = (int)(cb < 1 ? 1 : cb > nblocks - 1 ? nblocks - 1 : cb);
  }
  fn<<<(unsigned)nblocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the serving instances: the plan's HS 1-4 and SU 1-3 (NB 12 / SU), the
// queue after item w on a 3-slot ring
template <int HS>
int launch_su(const Args& a, const Plan& p, int rows, cudaStream_t stream) {
  switch (p.su) {
    case 1: return launch_with<HS, 1, 12, kQueue1, 0, Ring3>(a, rows, 0, stream);
    case 2: return launch_with<HS, 2, 6, kQueue1, 0, Ring3>(a, rows, 0, stream);
    default: return launch_with<HS, 3, 4, kQueue1, 0, Ring3>(a, rows, 0, stream);
  }
}

// the inputs of either entry point, checked against the plan (tc form only)
int args_for(const void* x, const void* nbr, const void* infl, void* wf, const void* x2,
             void* pooled, int* work, int ns, int nq, int h, int hs, int k, int ac, int ac2,
             Plan* p, Args* a) {
  *p = plan_for(h, ac, ac2, 2);
  if (p->form != kTc || k < 1 || k > kMaxK || hs < h ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wf) |
        reinterpret_cast<uintptr_t>(x2) | reinterpret_cast<uintptr_t>(pooled)) & 15))
    return (int)cudaErrorInvalidValue;
  *a = Args{(const bf16*)x, (const int*)nbr, (const bf16*)infl, (bf16*)wf, (const bf16*)x2,
            (bf16*)pooled, work, ns, nq, h, hs, k, ac, ac2 / 8, p->chunks, p->slices, 0, 0, 0};
  return 0;
}

int launch(const void* x, const void* nbr, const void* infl, void* wf, const void* x2,
           void* pooled, int* work, int batch, int ns, int nq, int h, int hs, int k, int ac,
           int ac2, void* stream) {
  Plan p;
  Args a;
  const int e = args_for(x, nbr, infl, wf, x2, pooled, work, ns, nq, h, hs, k, ac, ac2, &p, &a);
  if (e) return e;
  if (!work) return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  const int rows = batch * nq;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.hs) {
    case 1: return launch_su<1>(a, p, rows, st);
    case 2: return launch_su<2>(a, p, rows, st);
    case 3: return launch_su<3>(a, p, rows, st);
    default: return launch_su<4>(a, p, rows, st);
  }
}

// the layouts and variants scripts/probe_gather_wf_max.py times, at the
// serving plan (HS 2, SU 3, NB 4) only
int launch_variant(const void* x, const void* nbr, const void* infl, void* wf, const void* x2,
                   void* pooled, int* work, int batch, int ns, int nq, int h, int hs, int k,
                   int ac, int ac2, int layout, int skip_warps, int conv_permille, int option,
                   void* stream) {
  Plan p;
  Args a;
  const int e = args_for(x, nbr, infl, wf, x2, pooled, work, ns, nq, h, hs, k, ac, ac2, &p, &a);
  if (e) return e;
  if (p.hs != 2 || p.su != 3 || ((layout == kQueue || layout == kQueue1) && !work))
    return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  const int rows = batch * nq;
  cudaStream_t st = (cudaStream_t)stream;
#define SE3ET_VARIANT(LAYOUT, SW, OPTION, ...)                                   \
  if (layout == (LAYOUT) && ((SW) == 0 || skip_warps == (SW)) && option == (OPTION)) \
    return launch_with<2, 3, __VA_ARGS__>(a, rows, conv_permille, st);
  SE3ET_VARIANT(kSerial, 0, 0, 4, kSerial)
  SE3ET_VARIANT(kAlternate, 0, 0, 4, kAlternate)
  SE3ET_VARIANT(kStrided, 0, 0, 4, kStrided)
  SE3ET_VARIANT(kQueue, 0, 0, 4, kQueue)
  SE3ET_VARIANT(kQueue1, 0, 0, 4, kQueue1)
  SE3ET_VARIANT(kQueue, 0, kRing3, 4, kQueue, 0, Ring3)
  SE3ET_VARIANT(kQueue1, 0, kRing3, 4, kQueue1, 0, Ring3)
  SE3ET_VARIANT(kQueue1, 0, kRing3 | kMinBlocks6, 4, kQueue1, 0, Ring3, 6)
  SE3ET_VARIANT(kStrided, 0, kRing3, 4, kStrided, 0, Ring3)
  SE3ET_VARIANT(kRoles, 2, 0, 4, kRoles, 2)
  SE3ET_VARIANT(kRoles, 4, 0, 4, kRoles, 4)
#undef SE3ET_VARIANT
  if (layout == kSplit && option == 0 && conv_permille > 0 && conv_permille < 1000)
    return launch_with<2, 3, 4, kSplit>(a, rows, conv_permille, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// The plan for a K14 over h neighbours, x of ac and a payload of ac2
// elements of elem_bytes bytes: fills plan[0..5] with the form (1 tc, 2
// first), 16-neighbour fragments HS, 32-channel conv chunks, payload units
// a lane of a slice SU, slices a row and payload rows in flight a lane NB
// (all 0 in the first form); returns the form.
extern "C" int se3et_gather_wf_max_plan(int h, int ac, int ac2, int elem_bytes, int* plan) {
  const tc::Plan p = tc::plan_for(h, ac, ac2, elem_bytes);
  const int v[6] = {p.form, p.hs, p.chunks, p.su, p.slices, p.nb};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return p.form;
}

// K14's tc form (where the plan names it, else cudaErrorInvalidValue
// without launching): influence (B, Nq, hs, K) read in place (its first h
// columns); x, wf, x2 and pooled 16-byte aligned; `work` one int of scratch
// (the skip items' counter, zeroed on the stream before the launch)
extern "C" int se3et_gather_wf_max_tc_bf16(const void* x, const void* nbr, const void* infl,
                                           void* wf, const void* x2, void* pooled, void* work,
                                           int batch, int ns, int nq, int h, int hs, int k,
                                           int ac, int ac2, void* stream) {
  return tc::launch(x, nbr, infl, wf, x2, pooled, (int*)work, batch, ns, nq, h, hs, k, ac, ac2,
                    stream);
}

// The tc form in a given layout (0 serial, 1 alternating, 2 split with
// conv_permille of the blocks on the conv, 3 roles with skip_warps 2 or 4
// skip warps a block, 4 strided, 5 queue, 6 queue after item w; the queues'
// counter `work` an int, zeroed on the stream before the launch) and option
// (bits: 1 a 3-slot ring, 2 at most 80 registers), for
// scripts/probe_gather_wf_max.py; only where the plan gives HS 2 and SU 3
// (the serving shape's H 32 and 1536 channels).
extern "C" int se3et_gather_wf_max_tc_variant(const void* x, const void* nbr, const void* infl,
                                              void* wf, const void* x2, void* pooled, void* work,
                                              int batch, int ns, int nq, int h, int hs, int k,
                                              int ac, int ac2, int layout, int skip_warps,
                                              int conv_permille, int option, void* stream) {
  return tc::launch_variant(x, nbr, infl, wf, x2, pooled, (int*)work, batch, ns, nq, h, hs, k,
                            ac, ac2, layout, skip_warps, conv_permille, option, stream);
}

// the first design; influence (B, Nq, h, K) contiguous
extern "C" int se3et_gather_wf_max_bf16(const void* x, const void* nbr, const void* infl,
                                        void* wf, const void* x2, void* pooled, int batch,
                                        int ns, int nq, int h, int k, int ac, int ac2,
                                        void* stream) {
  return launch_first<__nv_bfloat16>(x, nbr, infl, wf, x2, pooled, batch, ns, nq, h, k, ac,
                                     ac2, stream);
}

extern "C" int se3et_gather_wf_max_f32(const void* x, const void* nbr, const void* infl,
                                       void* wf, const void* x2, void* pooled, int batch,
                                       int ns, int nq, int h, int k, int ac, int ac2,
                                       void* stream) {
  return launch_first<float>(x, nbr, infl, wf, x2, pooled, batch, ns, nq, h, k, ac, ac2,
                             stream);
}
