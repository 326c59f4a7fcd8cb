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
// The first design (gather_wf_kernel, float32 for the training step and
// the card-vs-CPU checks, and bf16 for H > 64): a block takes kQB query
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

}  // namespace

// K1 in bf16 on the tensor cores, H <= 64, AC a multiple of 8, x and out
// 16-byte aligned; influence (B, Nq, hs, K) read in place (its first h
// columns)
extern "C" int se3et_gather_wf_tc_bf16(const void* x, const void* nbr, const void* infl,
                                       void* out, int batch, int ns, int nq, int h, int hs,
                                       int k, int ac, void* stream) {
  return tc::launch(x, nbr, infl, out, batch, ns, nq, h, hs, k, ac, stream);
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
