// Backward of the E2PN conv gather with respect to the features (K8).
//
//   dx[b, s, ac] = sum_{(q, h): nbr[b, q, h] = s} sum_k infl[b, q, h, k] * dwf[b, q, k*AC + ac]
//
// the transpose of K1 (gather_wf.cu).  Replaces the TPU kernel
// se3et_tpu/ops/pallas/windowed_conv.py _wf_bwd_win (the backward of
// windowed_gather_wf_trainable); its function counterpart is the gradient
// of the exact gather route (se3et_tpu/nn/epn.py, take_along_axis with the
// sentinel rows zeroed), so a sentinel neighbour receives nothing.
//
// Bound: device memory.  The TPU kernel scatters through one-hot matmuls
// over a window; here each source row is summed in a fixed order, so the
// gradient is the same bits from run to run (no atomics).  Two forms,
// windowed_conv.gather_wf_bwd_form names the one a shape takes:
//  * "tiles" (gather_wf_bwd_tiles.cuh, the redesign): a warp owns a tile of
//    consecutive source rows and a slice of channels, walks the tile's
//    slots in (q, h) order from a tile plan (merged by tile_plan_kernel
//    from the set's reverse index, below) and keeps the sums in shared
//    memory; dwf is read once per (tile, query), nothing is written but dx;
//  * "first" (the first design, below), two kernels:
//  1. per (query, neighbour slot): g[b, q*H + h, ac] = sum_k infl * dwf,
//     one thread per (query, channel) with the K dwf values of its column
//     in registers, the block's influence rows in shared memory;
//  2. per source row: dx[b, s, ac] = sum of the g rows whose neighbour is s,
//     walked in the order of a reverse (CSR) index of the neighbour set --
//     entries sorted stably by source, so by (q, h) within a source --
//     built once per neighbour set by the wrapper and shared by its convs.
//  Each dwf element is read once and each g row is written and read once.
//  Both forms compute each slot's value by the same FMA chain and add a
//  source's values in ascending slot order from 0.f: the same bits.
#include <cuda_runtime.h>

#include "gather_wf_bwd_tiles.cuh"

namespace {

constexpr int kMaxK = 16;
constexpr int kQB = 4;
constexpr int kThreads = 128;

__global__ void slot_grad_kernel(const float* __restrict__ dwf, const float* __restrict__ infl,
                                 float* __restrict__ g, int nq, int h, int k, int ac) {
  extern __shared__ float s_w[];  // [kQB][h][k]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQB;
  const int nrows = min(kQB, nq - q0);
  const long long row0 = (long long)b * nq + q0;
  for (int i = threadIdx.x; i < nrows * h * k; i += blockDim.x) {
    s_w[i] = infl[row0 * h * k + i];
  }
  __syncthreads();
  for (int item = threadIdx.x; item < nrows * ac; item += blockDim.x) {
    const int ql = item / ac;
    const int c = item - ql * ac;
    const float* d = dwf + (row0 + ql) * (long long)k * ac + c;
    float dk[kMaxK];
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) dk[kk] = kk < k ? d[(long long)kk * ac] : 0.f;
    const float* w = s_w + ql * h * k;
    float* gq = g + (row0 + ql) * (long long)h * ac + c;
    for (int hh = 0; hh < h; ++hh) {
      float acc = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < k) acc = fmaf(w[hh * k + kk], dk[kk], acc);
      }
      gq[(long long)hh * ac] = acc;
    }
  }
}

__global__ void source_sum_kernel(const float* __restrict__ g, const int* __restrict__ order,
                                  const int* __restrict__ offsets, float* __restrict__ dx,
                                  int ns, int nslots, int ac) {
  const int b = blockIdx.y;
  const int s = blockIdx.x;
  const int* ob = order + (long long)b * nslots;
  const int e0 = offsets[(long long)b * (ns + 1) + s];
  const int e1 = offsets[(long long)b * (ns + 1) + s + 1];
  const float* gb = g + (long long)b * nslots * ac;
  float* o = dx + ((long long)b * ns + s) * ac;
  for (int c = threadIdx.x; c < ac; c += blockDim.x) {
    float acc = 0.f;
    for (int e = e0; e < e1; ++e) acc += gb[(long long)ob[e] * ac + c];
    o[c] = acc;
  }
}

}  // namespace

// The first design: dwf (B, Nq, K*AC) f32; infl (B, Nq, H, K) f32; order (B, Nq*H) int32 and
// offsets (B, Ns+1) int32 the reverse index; g (B, Nq*H, AC) f32 scratch;
// dx (B, Ns, AC) f32.
extern "C" int se3et_gather_wf_bwd_f32(const void* dwf, const void* infl, const void* order,
                                       const void* offsets, void* g, void* dx, int batch,
                                       int ns, int nq, int h, int k, int ac, void* stream) {
  if (k > kMaxK || k < 1 || h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)kQB * h * k * sizeof(float);
  slot_grad_kernel<<<dim3((nq + kQB - 1) / kQB, batch), kThreads, smem, st>>>(
      (const float*)dwf, (const float*)infl, (float*)g, nq, h, k, ac);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = ac >= 256 ? 256 : ((ac + 31) / 32) * 32;
  source_sum_kernel<<<dim3(ns, batch), threads, 0, st>>>(
      (const float*)g, (const int*)order, (const int*)offsets, (float*)dx, ns, nq * h, ac);
  return (int)cudaGetLastError();
}

// The tiles form: dwf (B, Nq, K*AC) f32, AC a multiple of 4 and dwf 16-byte
// aligned; infl (B, Nq, hs >= H, K) f32 read in place; ent (B, Nq*H) and off
// (B, ceil(Ns / tile) + 1) int32 the tile plan, built for tiles of `tile`
// rows, which must be the kernel's (32 as shipped); dx (B, Ns, AC) f32; work one int of
// scratch (the items' counter, zeroed on the stream before the launch).
// Another tile, K > 16, H > 64, Nq >= 2^19, AC not a multiple of 4 or dwf
// not 16-byte aligned give cudaErrorInvalidValue without launching.
extern "C" int se3et_gather_wf_bwd_tiles_f32(const void* dwf, const void* infl, const void* ent,
                                             const void* off, void* dx, void* work, int batch,
                                             int ns, int nq, int h, int hs, int k, int ac,
                                             int tile, void* stream) {
  if (tile != k8_tiles::kTile) return (int)cudaErrorInvalidValue;
  k8_tiles::Args a{(const float*)dwf, (const float*)infl, (const int*)ent, (const int*)off,
                   (float*)dx, (int*)work, batch, ns, nq, h, hs, k, ac};
  return k8_tiles::launch(a, (cudaStream_t)stream);
}

// The tile plan of a neighbour set (B, Nq, H) over Ns source rows from its
// reverse index: order (B, Nq*H) and offsets (B, Ns+1) int32; ent (B, Nq*H)
// and off (B, ceil(Ns / tile) + 1) int32, out.  tile must be the kernel's;
// H > 64 or Nq >= 2^19 give cudaErrorInvalidValue without launching.
extern "C" int se3et_gather_wf_bwd_tile_plan(const void* order, const void* offsets, void* ent,
                                             void* off, int batch, int ns, int nq, int h,
                                             int tile, void* stream) {
  if (tile != k8_tiles::kTile) return (int)cudaErrorInvalidValue;
  return k8_tiles::launch_tile_plan((const int*)order, (const int*)offsets, (int*)ent,
                                    (int*)off, batch, ns, nq, h, (cudaStream_t)stream);
}
