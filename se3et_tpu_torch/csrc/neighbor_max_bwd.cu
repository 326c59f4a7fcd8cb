// Backward of the neighbour max-pool of the strided E2PN skip (K9).
//
//   out[b, q, c] = max_h v(b, q, h, c),  v = nbr valid ? x[b, nbr, c] : 0
//   dx[b, s, c]  = sum_{(q, h): nbr[b, q, h] = s, x[b, s, c] == out[b, q, c]}
//                  dout[b, q, c] / count[b, q, c]
//
// with count the number of h (sentinel shadow zeros included) whose value
// equals the max: the cotangent is split evenly over the ties and the
// shadow-zero share is dropped, which is the gradient of jnp.max after the
// sentinel where() of se3et_tpu/nn/epn.py max_pool_neighbors.  Replaces the
// TPU kernel se3et_tpu/ops/pallas/windowed_conv.py _max_bwd_win (the
// backward of windowed_max_pool_trainable).  The tie test compares with the
// saved forward max in float32, where it is exact.
//
// Bound: device memory.  No atomics.  Two forms, each two kernels: first
// per (query, channel) share[b, q, c] = dout / count, then per source row
// the sum of the shares of its tied slots, in ascending slot order from
// +0.f, so both give the same bits; windowed_conv.neighbor_max_bwd_form
// names the one a shape takes:
//  * "tiles" (neighbor_max_bwd_tiles.cuh, the redesign): the shares and a
//    tie bit per valid slot and channel by K2's rows form (16-byte loads
//    of the valid neighbour rows into registers), the sums by K8's tile
//    walk over K8's tile plan of the same neighbour set (a query's share
//    row read once per source tile, not once per reference, and x and out
//    not again);
//  * "first" (the first design, below):
//  1. per (query, channel): count the ties over the H neighbours, one
//     4-byte load each, and write the share;
//  2. per source row: walk the reverse (CSR) index of the neighbour set
//     (entries sorted stably by source) and add share[q, c] where x[s, c]
//     ties out[q, c], reading out and share again for every reference.
#include <cuda_runtime.h>

#include "neighbor_max_bwd_tiles.cuh"

namespace {

constexpr int kQB = 4;
constexpr int kThreads = 128;

__global__ void share_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                             const float* __restrict__ out, const float* __restrict__ dout,
                             float* __restrict__ share, int ns, int nq, int h, int ac) {
  extern __shared__ int s_nbr[];  // [kQB][h]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQB;
  const int nrows = min(kQB, nq - q0);
  const long long row0 = (long long)b * nq + q0;
  for (int i = threadIdx.x; i < nrows * h; i += blockDim.x) s_nbr[i] = nbr[row0 * h + i];
  __syncthreads();
  const float* xb = x + (long long)b * ns * ac;
  for (int item = threadIdx.x; item < nrows * ac; item += blockDim.x) {
    const int ql = item / ac;
    const int c = item - ql * ac;
    const long long o = (row0 + ql) * ac + c;
    const float m = out[o];
    const int* rn = s_nbr + ql * h;
    int count = 0;
    for (int hh = 0; hh < h; ++hh) {
      const int j = rn[hh];
      const float v = (j < ns && j >= 0) ? xb[(long long)j * ac + c] : 0.f;
      count += v == m;
    }
    share[o] = count > 0 ? dout[o] / (float)count : 0.f;
  }
}

__global__ void tie_sum_kernel(const float* __restrict__ x, const float* __restrict__ out,
                               const float* __restrict__ share, const int* __restrict__ order,
                               const int* __restrict__ offsets, float* __restrict__ dx,
                               int ns, int nq, int h, int ac) {
  const int b = blockIdx.y;
  const int s = blockIdx.x;
  const int* ob = order + (long long)b * nq * h;
  const int e0 = offsets[(long long)b * (ns + 1) + s];
  const int e1 = offsets[(long long)b * (ns + 1) + s + 1];
  const long long qbase = (long long)b * nq;
  const float* xs = x + ((long long)b * ns + s) * ac;
  float* o = dx + ((long long)b * ns + s) * ac;
  for (int c = threadIdx.x; c < ac; c += blockDim.x) {
    const float xv = xs[c];
    float acc = 0.f;
    for (int e = e0; e < e1; ++e) {
      const long long q = qbase + ob[e] / h;
      if (out[q * ac + c] == xv) acc += share[q * ac + c];
    }
    o[c] = acc;
  }
}

}  // namespace

// x (B, Ns, AC) f32; nbr (B, Nq, H) int32; out, dout (B, Nq, AC) f32;
// order (B, Nq*H), offsets (B, Ns+1) int32 the reverse index; share
// (B, Nq, AC) f32 scratch; dx (B, Ns, AC) f32.
extern "C" int se3et_neighbor_max_bwd_f32(const void* x, const void* nbr, const void* out,
                                          const void* dout, const void* order,
                                          const void* offsets, void* share, void* dx,
                                          int batch, int ns, int nq, int h, int ac,
                                          void* stream) {
  if (h < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  share_kernel<<<dim3((nq + kQB - 1) / kQB, batch), kThreads, (size_t)kQB * h * sizeof(int),
                 st>>>((const float*)x, (const int*)nbr, (const float*)out,
                       (const float*)dout, (float*)share, ns, nq, h, ac);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = ac >= 256 ? 256 : ((ac + 31) / 32) * 32;
  tie_sum_kernel<<<dim3(ns, batch), threads, 0, st>>>(
      (const float*)x, (const float*)out, (const float*)share, (const int*)order,
      (const int*)offsets, (float*)dx, ns, nq, h, ac);
  return (int)cudaGetLastError();
}

// The tiles form: x (B, Ns, AC), out and dout (B, Nq, AC) f32, 16-byte
// aligned, AC a multiple of 4; nbr (B, Nq, H <= 64) int32; ent (B, Nq*H) and
// off (B, ceil(Ns / tile) + 1) int32 the tile plan of nbr (K8's, built for
// tiles of `tile` rows, which must be the kernel's: 32 as shipped); share
// (B, Nq, AC) f32 scratch (2 AC a row where compiled with
// MAX_BWD_INTERLEAVE); mask (B, Nq*H, ceil(AC / 64)) 16-byte units of
// scratch, the tie bits (written and read where compiled with
// MAX_BWD_TIE_MASK, else unused); dx (B, Ns, AC) f32; work one int of scratch (the items' counter,
// zeroed on the stream before the launch).  passes: 3 both kernels, 1 the
// shares alone, 2 the sums alone from `share` (and `mask`) as they lie
// (scripts/probe_neighbor_max_bwd.py times them apart).  Other shapes give
// cudaErrorInvalidValue without launching.
extern "C" int se3et_neighbor_max_bwd_tiles_f32(const void* x, const void* nbr, const void* out,
                                                const void* dout, const void* ent,
                                                const void* off, void* share, void* mask,
                                                void* dx, void* work, int batch, int ns,
                                                int nq, int h, int ac, int tile, int passes,
                                                void* stream) {
  using namespace k9_tiles;
  if (tile != kTile || batch < 1 || ns < 1 || nq < 1 || h < 1 || h > kMaxH || ac < 4 ||
      ac % 4 || ((long long)nq << kQShift) > 0x7fffffffLL || passes < 1 || passes > 3 ||
      !aligned16(x) || !aligned16(out) || !aligned16(dout) || !aligned16(share) ||
      (kMask && (!mask || !aligned16(mask)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int sets = tie_units(ac / 4);  // 16-byte units of tie bits a slot
  if (passes & 1) {
    ShareArgs a{(const float*)x, (const int*)nbr, (const float*)out, (const float*)dout,
                (float*)share, (uint4*)mask, ns, nq, h, ac / 4, 0, sets, 0};
    const int err = launch_share(a, batch, st);
    if (err) return err;
  }
  if (passes & 2) {
    TileArgs a{(const float*)x, (const float*)out, (const float*)share, (const uint4*)mask,
               (const int*)ent, (const int*)off, (float*)dx, (int*)work, batch, ns, nq, h, ac,
               sets};
    return launch_tiles(a, st);
  }
  return (int)cudaSuccess;
}

// The tiles form as compiled: cfg[0..5] = rows a tile, channels a lane, ring
// slots, out and share interleaved (0 / 1), tie bits (MAX_BWD_TIE_MASK), shared memory
// bytes a warp of the sums kernel; returns rows a tile.
extern "C" int se3et_neighbor_max_bwd_tiles_config(int* cfg) {
  using namespace k9_tiles;
  const int v[6] = {kTile, kVec, kRing, kInterleave ? 1 : 0, kMaskMode,
                    (int)kTileSmemBytes};
  for (int i = 0; i < 6; ++i) cfg[i] = v[i];
  return kTile;
}
