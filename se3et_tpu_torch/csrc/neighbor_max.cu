// Neighbour max-pool of a strided E2PN skip (K2).
//
//   out[b, q, ac] = max_h (nbr[b, q, h] < Ns ? x[b, nbr[b, q, h], ac] : 0)
//
// A sentinel neighbour is a zero row that takes part in the max (the
// reference's zero pad row, se3et_tpu/nn/epn.py max_pool_neighbors).
// Replaces the TPU kernel se3et_tpu/ops/pallas/windowed_conv.py
// windowed_max_pool.  K2 takes the strided skips the fused convs leave:
// on the fused serving route the s2 -> s3 skip (3072 channels, wider than
// K14's registers hold; K13 and K14 pool their own skips), on the unfused
// route and in training all three.
//
// Bound: bytes.  The valid neighbour rows are read whole (at the serving
// shape 32,653 of 73,728 slots are valid: 200.6 MB of 6 KB rows from a
// 30.7 MB source that L2 holds), against one compare per element.  What
// held the first design back: one 2- or 4-byte load in flight per thread,
// a visit per slot (sentinels too) per element, ~15 warps an SM.  Two
// forms, chosen by the row's width alone (se3et_neighbor_max_plan,
// mirrored by ops/kernels/windowed_conv.py neighbor_max_plan):
//
// "rows", where a row is a whole number of 16-byte units (AC a multiple of
// 8 in bf16, of 4 in float32): a warp per (query row, slice of 32 x SU
// units, SU <= 3, the slices of a row balanced), a row's slices in
// consecutive warps of a block, through skip_max.cuh skip_row_max: each
// lane's SU units of NB valid neighbour rows at a time loaded straight into
// registers by 16-byte loads before their max, no load for a sentinel, the
// slot mask a ballot per 32 slots (any H).  56-64 registers a thread, no
// spills, so 32 warps an SM stream rows from L2; NB 4 at SU 3 (the model's
// widths) was chosen by measurement over NB 4-12, SU 1-4 and 4-16 warps a
// block (scripts/probe_neighbor_max.py, PERF.md).
//
// "first", the first design, for any other width: a block takes kQB query
// rows with their indices staged in shared memory; each thread owns one
// (query, channel) column and streams its H neighbour values, so a warp
// reads AC-contiguous runs of one row.
//
// The max is exact in both (fmaxf, max.bf16x2), so both equal the plain
// version bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "skip_max.cuh"

namespace {

constexpr int kRows = 1, kFirst = 2;  // form codes, as windowed_conv.NEIGHBOR_MAX_FORMS

// the first design
constexpr int kQB = 4;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void neighbor_max_kernel(const T* __restrict__ x, const int* __restrict__ nbr,
                                    T* __restrict__ out, int ns, int nq, int h, int ac) {
  extern __shared__ int s_nbr[];  // [kQB][h]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQB;
  const int nrows = min(kQB, nq - q0);
  const long long row0 = (long long)b * nq + q0;
  for (int i = threadIdx.x; i < nrows * h; i += blockDim.x) {
    s_nbr[i] = nbr[row0 * h + i];
  }
  __syncthreads();

  const T* xb = x + (long long)b * ns * ac;
  for (int item = threadIdx.x; item < nrows * ac; item += blockDim.x) {
    const int ql = item / ac;
    const int c = item - ql * ac;
    const int* rn = s_nbr + ql * h;
    float m = __int_as_float(0xff800000);  // -inf
    for (int hh = 0; hh < h; ++hh) {
      const int j = rn[hh];
      const float v = (j < ns && j >= 0) ? to_f(xb[(long long)j * ac + c]) : 0.f;
      m = fmaxf(m, v);
    }
    store(out + (row0 + ql) * (long long)ac + c, m);
  }
}

template <typename T>
int launch_first(const void* x, const void* nbr, void* out, int batch, int ns, int nq, int h,
                 int ac, cudaStream_t stream) {
  const size_t smem = (size_t)kQB * h * sizeof(int);
  dim3 grid((nq + kQB - 1) / kQB, batch);
  neighbor_max_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const int*)nbr, (T*)out, ns, nq, h, ac);
  return (int)cudaGetLastError();
}

// the rows form
constexpr int kMaxSU = 3;          // 16-byte units a lane of a slice
constexpr int kLoadWords = 48;     // registers of loads in flight a lane: NB = 48 / (4 SU)
constexpr int kRowsWarps = 8;      // warps a block
constexpr int kMaxRowsThreads = 1024;

struct Plan {
  int form, su, slices, nb, warps;
};

Plan plan_for(int ac, int elem_bytes) {
  const int per_unit = 16 / elem_bytes;
  if (ac < 1 || ac % per_unit) return {kFirst, 0, 0, 0, kThreads / 32};
  const int units = ac / per_unit;
  const int slices = (units + 32 * kMaxSU - 1) / (32 * kMaxSU);
  const int su = (units + 32 * slices - 1) / (32 * slices);  // the slices balanced
  return {kRows, su, slices, kLoadWords / (4 * su), kRowsWarps};
}

// item = (flattened query row, slice), slices of a row in consecutive warps
template <typename T, int SU, int NB>
__global__ void neighbor_max_rows_kernel(const T* __restrict__ x, const int* __restrict__ nbr,
                                         T* __restrict__ out, int ns, int nq, int h,
                                         int units, int slices, long long items) {
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= items) return;  // whole warps
  const long long row = item / slices;
  const int slice = (int)(item - row * slices);
  const uint4* src = reinterpret_cast<const uint4*>(x) + row / nq * ns * units;
  se3et::skip_row_max<T, SU, NB>(src, nbr + row * h, h, ns, units, slice * 32 * SU,
                                 reinterpret_cast<uint4*>(out) + row * units, true,
                                 threadIdx.x & 31);
}

template <typename T, int SU, int NB>
int launch_rows_with(const void* x, const void* nbr, void* out, int batch, int ns, int nq,
                     int h, int units, int warps, cudaStream_t stream) {
  const int slices = (units + 32 * SU - 1) / (32 * SU);
  const long long items = (long long)batch * nq * slices;
  const long long blocks = (items + warps - 1) / warps;
  neighbor_max_rows_kernel<T, SU, NB><<<(unsigned)blocks, warps * 32, 0, stream>>>(
      (const T*)x, (const int*)nbr, (T*)out, ns, nq, h, units, slices, items);
  return (int)cudaGetLastError();
}

// the instances: the plan's (SU 1-3, NB 48 / (4 SU)) and the variants
// scripts/probe_neighbor_max.py times beside them
template <typename T>
int launch_rows(const void* x, const void* nbr, void* out, int batch, int ns, int nq, int h,
                int ac, int su, int nb, int warps, cudaStream_t stream) {
  const int units = ac / (16 / (int)sizeof(T));
  if (warps < 1 || warps * 32 > kMaxRowsThreads) return (int)cudaErrorInvalidValue;
#define SE3ET_ROWS(S, N) \
  if (su == S && nb == N)  \
    return launch_rows_with<T, S, N>(x, nbr, out, batch, ns, nq, h, units, warps, stream);
  SE3ET_ROWS(1, 12)
  SE3ET_ROWS(2, 6)
  SE3ET_ROWS(3, 4)
  SE3ET_ROWS(2, 12)
  SE3ET_ROWS(3, 6)
  SE3ET_ROWS(3, 8)
  SE3ET_ROWS(3, 12)
  SE3ET_ROWS(4, 4)
#undef SE3ET_ROWS
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* x, const void* nbr, void* out, int batch, int ns, int nq, int h,
           int ac, int form, void* stream) {
  if (h < 1) return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  const Plan p = plan_for(ac, sizeof(T));
  cudaStream_t st = (cudaStream_t)stream;
  if (form == kRows) {
    if (p.form != kRows) return (int)cudaErrorInvalidValue;
    return launch_rows<T>(x, nbr, out, batch, ns, nq, h, ac, p.su, p.nb, p.warps, st);
  }
  if (form == kFirst) return launch_first<T>(x, nbr, out, batch, ns, nq, h, ac, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The plan for rows of `ac` elements of `elem_bytes` bytes: fills plan[0..4]
// with the form (1 rows, 2 first), units a lane of a slice, slices a row,
// neighbour rows in flight a lane and warps a block; returns the form.
extern "C" int se3et_neighbor_max_plan(int ac, int elem_bytes, int* plan) {
  const Plan p = plan_for(ac, elem_bytes);
  const int v[5] = {p.form, p.su, p.slices, p.nb, p.warps};
  for (int i = 0; i < 5; ++i) plan[i] = v[i];
  return p.form;
}

// form: 1 rows (where the plan names it, else cudaErrorInvalidValue without
// launching), 2 first (any width)
extern "C" int se3et_neighbor_max_bf16(const void* x, const void* nbr, void* out,
                                       int batch, int ns, int nq, int h, int ac, int form,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, nbr, out, batch, ns, nq, h, ac, form, stream);
}

extern "C" int se3et_neighbor_max_f32(const void* x, const void* nbr, void* out,
                                      int batch, int ns, int nq, int h, int ac, int form,
                                      void* stream) {
  return launch<float>(x, nbr, out, batch, ns, nq, h, ac, form, stream);
}

// The rows form with a given (SU, NB, warps a block), for
// scripts/probe_neighbor_max.py; rows of whole 16-byte units only.
extern "C" int se3et_neighbor_max_rows_variant(const void* x, const void* nbr, void* out,
                                               int batch, int ns, int nq, int h, int ac,
                                               int elem_bytes, int su, int nb, int warps,
                                               void* stream) {
  if (plan_for(ac, elem_bytes).form != kRows || h < 1) return (int)cudaErrorInvalidValue;
  if (batch < 1 || nq < 1) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 2)
    return launch_rows<__nv_bfloat16>(x, nbr, out, batch, ns, nq, h, ac, su, nb, warps, st);
  if (elem_bytes == 4)
    return launch_rows<float>(x, nbr, out, batch, ns, nq, h, ac, su, nb, warps, st);
  return (int)cudaErrorInvalidValue;
}
