// Fused log-domain Sinkhorn iterations with fixed max-shifts (K4).
//
// Same function as the TPU kernel se3et_tpu/ops/pallas/sinkhorn.py
// sinkhorn_pallas:
//   m_row = max(max_j s[i, j], -1e30)      e_row = exp(s - m_row)
//   m_col = max(max_i s[i, j], -1e30)      e_col = exp(s - m_col)
//   repeat: u = clip(log_mu - m_row - log(sum_j e_row * exp(v) + 1e-30), +-80)
//           v = clip(log_nu - m_col - log(sum_i e_col * exp(u) + 1e-30), +-80)
//   out = s + u + v
//
// Bound: the chain.  Each patch runs 2 x iters dependent half-steps (a dot
// product of length n or m, a log, an exp and a barrier); at the serving
// shape (256 patches of 65 x 65, 100 iterations) the operations' bound is
// ~6.5 us and the bytes' ~3 us, while a half-step takes ~0.3 us on the
// chain: with the dot products cut to one load, 100 iterations still take
// ~43 us (scripts/probe_sinkhorn.py, NVIDIA H100 80GB HBM3).  So the design
// shortens one half-step and keeps every patch resident at once.
//
// Two forms, chosen by se3et_sinkhorn_plan (mirrored by
// ops/kernels/sinkhorn.py sinkhorn_plan):
//
// * "rows" (sinkhorn_rows_kernel): each patch's scores are staged once,
//   coalesced, into a shared tile (odd row stride); L lanes own each row
//   (and, for the column pass, each column) and hold their slice of that
//   row of e_row and of that column of e_col in registers, so the transpose
//   is free and nothing is read from device memory inside the loop.  A
//   half-step reads the other side's exp(v) (or exp(u)) from shared memory
//   by broadcast 16-byte loads, runs the dot product in kChains independent
//   FMA chains, combines the L lanes by shuffles, and one lane writes
//   exp(u) back.  c = log_mu - m_row is formed once (the plain version's
//   left-to-right order).  A patch takes ceil(max(m, n) * L / 32) warps and
//   synchronises only its own warps with a named barrier, one per
//   half-step.  u and v stay in the owners' registers until the epilogue
//   writes out = (s + u) + v from the tile, coalesced.  The prologue keeps
//   expf(s - m) with the subtraction first: a fully masked row (-1e12
//   everywhere) has s - m_row == 0 exactly, e = 1, as the plain version
//   has it.
// * "smem" (sinkhorn_smem_kernel, the first design): one 256-thread block
//   per patch with e_row and its transpose in shared memory and one warp
//   per row reducing with shuffles.  It takes the shapes the rows form
//   cannot hold in registers: max(m, n) > 144 (KITTI's 129 x 129 patches
//   stay in the rows form).
#include <cuda_runtime.h>

namespace {

// The rows form's plan (scripts/probe_sinkhorn.py times the alternatives):
// the most entries of one row (and of one column) a lane holds in registers
// (36: two lanes per row at 65), patches sharing a block, independent FMA
// chains per dot product.
constexpr int kMaxChunk = 36;
constexpr int kPatchesPerBlock = 1;
constexpr int kChains = 2;
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block on Hopper
constexpr int kSmemThreads = 256;   // the smem form's block
constexpr int kSmemWarps = kSmemThreads / 32;

enum Form { kNone = 0, kRows = 1, kSmem = 2 };

struct Plan {
  int form, lanes, chunk, warps, patches, smem_bytes;
};

// Register slices are built for these widths (a lane's chunk is the
// smallest that holds ceil(max(m, n) / lanes) entries).
constexpr int kChunks[] = {4, 8, 12, 16, 20, 24, 28, 32, 36};

int chunk_for(int per) {
  for (int c : kChunks)
    if (c >= per) return c;
  return 0;
}

// Threads a block of the rows form may have at a slice width: each width is
// built for blocks of up to 256 threads (up to 255 registers a thread: two
// 36-entry slices take 120, no spills), and widths 20-36 also for blocks of
// up to 576 (the register file then caps a thread at 96 registers, with a
// few spills), which 4 lanes per row need at 73-144 rows.
constexpr int kNarrowThreads = 256;
constexpr int kWideThreads = 576;
constexpr int kWideMinChunk = 20;

constexpr int max_block_threads(int chunk) {
  return chunk >= kWideMinChunk && chunk <= 36 ? kWideThreads : kNarrowThreads;
}

// Floats of one patch's shared region in the rows form: exp(u) and exp(v)
// (lanes x chunk each, zero past m and n), the score tile (m rows of odd
// stride), u and v; rounded up to keep each region 16-byte aligned.
int rows_patch_floats(int m, int n, int lanes, int chunk) {
  const int f = 2 * lanes * chunk + m * (n | 1) + m + n;
  return (f + 3) / 4 * 4;
}

Plan plan_for(int m, int n) {
  Plan p{kNone, 0, 0, 0, 0, 0};
  if (m < 1 || n < 1) return p;
  const int maxdim = m > n ? m : n;
  for (int lanes = 1; lanes <= 32; lanes *= 2) {
    const int per = (maxdim + lanes - 1) / lanes;
    if (per > kMaxChunk) continue;
    const int warps = (maxdim * lanes + 31) / 32;
    const int chunk = chunk_for(per);
    if (chunk == 0 || warps * 32 > max_block_threads(chunk)) continue;
    const long long bytes = 4LL * rows_patch_floats(m, n, lanes, chunk);
    if (bytes > kSmemLimit) continue;
    int patches = kPatchesPerBlock;
    while (patches > 1 && (patches * warps * 32 > max_block_threads(chunk) ||
                           patches * bytes > kSmemLimit))
      --patches;
    return Plan{kRows, lanes, chunk, warps, patches, (int)(patches * bytes)};
  }
  const long long bytes = (2LL * m * n + 3LL * (m + n)) * 4;
  if (bytes <= kSmemLimit) return Plan{kSmem, 0, 0, kSmemWarps, 1, (int)bytes};
  return p;
}

__device__ __forceinline__ void patch_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// Sum / max over the `lanes` lanes (a power of two, <= 32) that own one row;
// every lane of the warp takes part.
__device__ __forceinline__ float group_sum(float x, int lanes) {
  for (int o = 1; o < lanes; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float group_max(float x, int lanes) {
  for (int o = 1; o < lanes; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The loop's log and exp round as the plain version's torch.log / torch.exp
// do (logf / expf).  lg2.approx / ex2.approx shorten an iteration by ~0.19
// us but move the output by 3.8e-4 at 100 iterations where valid scores
// reach ~176: the float32 iteration there is ill-conditioned, so any other
// rounding grows past K4's 1e-4 tolerance (scripts/probe_sinkhorn.py).
__device__ __forceinline__ float log_step(float x) { return logf(x); }
__device__ __forceinline__ float exp_step(float x) { return expf(x); }

// sum_k e[k] * x[k] over a lane's chunk, x 16-byte aligned in shared memory
// (one broadcast LDS.128 per four entries), in kChains independent chains.
template <int CH>
__device__ __forceinline__ float chunk_dot(const float (&e)[CH], const float* x) {
  float acc[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k = 0; k < CH; k += 4) {
    const float4 w = *reinterpret_cast<const float4*>(x + k);
    acc[(k + 0) % kChains] = fmaf(e[k + 0], w.x, acc[(k + 0) % kChains]);
    acc[(k + 1) % kChains] = fmaf(e[k + 1], w.y, acc[(k + 1) % kChains]);
    acc[(k + 2) % kChains] = fmaf(e[k + 2], w.z, acc[(k + 2) % kChains]);
    acc[(k + 3) % kChains] = fmaf(e[k + 3], w.w, acc[(k + 3) % kChains]);
  }
  float s = acc[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) s += acc[c];
  return s;
}

template <int CH, int MAXT>
__global__ void __launch_bounds__(MAXT)
    sinkhorn_rows_kernel(const float* __restrict__ scores, const float* __restrict__ log_mu,
                         const float* __restrict__ log_nu, float* __restrict__ out,
                         int batch, int m, int n, int iters, int lanes, int warps,
                         int patch_floats) {
  extern __shared__ __align__(16) float smem[];
  const int nthreads = warps * 32;
  const int p = threadIdx.x / nthreads;
  const int t = threadIdx.x - p * nthreads;
  const int b = blockIdx.x * (blockDim.x / nthreads) + p;
  if (b >= batch) return;  // an empty patch slot: no other patch waits on it
  const int bar = 1 + p;   // barrier 0 is __syncthreads'
  const int stride = n | 1;
  float* eu = smem + p * patch_floats;  // [lanes * CH] exp(u), zero past m
  float* ev = eu + lanes * CH;          // [lanes * CH] exp(v), zero past n
  float* tile = ev + lanes * CH;        // [m][stride] scores
  float* us = tile + m * stride;        // [m]
  float* vs = us + m;                   // [n]

  const float* s = scores + (long long)b * m * n;
  const int mn = m * n;
  for (int idx = t; idx < mn; idx += nthreads) {
    const int i = idx / n;
    tile[i * stride + idx - i * n] = s[idx];
  }
  for (int k = t; k < lanes * CH; k += nthreads) {
    eu[k] = 0.f;
    ev[k] = k < n ? 1.f : 0.f;  // exp(v) at v = 0
  }
  patch_sync(bar, nthreads);

  // lane l of owner r: entries l*CH .. l*CH + CH - 1 of row r and of column r
  const int r = t / lanes;
  const int l = t - r * lanes;
  const int k0 = l * CH;
  const bool row = r < m, col = r < n;
  float mr = __int_as_float(0xff800000), mc = mr;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    if (row && k0 + k < n) mr = fmaxf(mr, tile[r * stride + k0 + k]);
    if (col && k0 + k < m) mc = fmaxf(mc, tile[(k0 + k) * stride + r]);
  }
  const float m_row = fmaxf(group_max(mr, lanes), -1e30f);
  const float m_col = fmaxf(group_max(mc, lanes), -1e30f);
  float er[CH], ec[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    er[k] = row && k0 + k < n ? expf(tile[r * stride + k0 + k] - m_row) : 0.f;
    ec[k] = col && k0 + k < m ? expf(tile[(k0 + k) * stride + r] - m_col) : 0.f;
  }
  const float c_row = row ? log_mu[(long long)b * m + r] - m_row : 0.f;
  const float c_col = col ? log_nu[(long long)b * n + r] - m_col : 0.f;

  float u = 0.f, v = 0.f;
  for (int it = 0; it < iters; ++it) {
    const float su = group_sum(chunk_dot<CH>(er, ev + k0), lanes);
    if (row) {
      u = fminf(fmaxf(c_row - log_step(su + 1e-30f), -80.f), 80.f);
      if (l == 0) eu[r] = exp_step(u);
    }
    patch_sync(bar, nthreads);
    const float sv = group_sum(chunk_dot<CH>(ec, eu + k0), lanes);
    if (col) {
      v = fminf(fmaxf(c_col - log_step(sv + 1e-30f), -80.f), 80.f);
      if (l == 0) ev[r] = exp_step(v);
    }
    patch_sync(bar, nthreads);
  }

  if (l == 0) {
    if (row) us[r] = u;
    if (col) vs[r] = v;
  }
  patch_sync(bar, nthreads);
  float* o = out + (long long)b * m * n;
  for (int idx = t; idx < mn; idx += nthreads) {
    const int i = idx / n;
    const int j = idx - i * n;
    o[idx] = tile[i * stride + j] + us[i] + vs[j];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void sinkhorn_smem_kernel(const float* __restrict__ scores,
                                     const float* __restrict__ log_mu,
                                     const float* __restrict__ log_nu,
                                     float* __restrict__ out, int m, int n, int iters) {
  extern __shared__ float smem[];
  float* e_row = smem;          // [m][n]
  float* e_col = e_row + m * n;  // [n][m]
  float* m_row = e_col + n * m;  // [m]
  float* m_col = m_row + m;      // [n]
  float* u = m_col + n;          // [m]
  float* v = u + m;              // [n]
  float* eu = v + n;             // [m]  exp(u)
  float* ev = eu + m;            // [n]  exp(v)

  const int b = blockIdx.x;
  const float* s = scores + (long long)b * m * n;
  const float* lmu = log_mu + (long long)b * m;
  const float* lnu = log_nu + (long long)b * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = warp; i < m; i += kSmemWarps) {
    float mx = __int_as_float(0xff800000);
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s[i * n + j]);
    mx = warp_max(mx);
    if (lane == 0) m_row[i] = fmaxf(mx, -1e30f);
  }
  for (int j = warp; j < n; j += kSmemWarps) {
    float mx = __int_as_float(0xff800000);
    for (int i = lane; i < m; i += 32) mx = fmaxf(mx, s[i * n + j]);
    mx = warp_max(mx);
    if (lane == 0) m_col[j] = fmaxf(mx, -1e30f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < m * n; idx += kSmemThreads) {
    const int i = idx / n;
    const int j = idx - i * n;
    const float sv = s[idx];
    e_row[idx] = expf(sv - m_row[i]);
    e_col[j * m + i] = expf(sv - m_col[j]);
  }
  for (int j = threadIdx.x; j < n; j += kSmemThreads) {
    v[j] = 0.f;
    ev[j] = 1.f;
  }
  for (int i = threadIdx.x; i < m; i += kSmemThreads) u[i] = 0.f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int i = warp; i < m; i += kSmemWarps) {
      float acc = 0.f;
      for (int j = lane; j < n; j += 32) acc = fmaf(e_row[i * n + j], ev[j], acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float ui = fminf(fmaxf(lmu[i] - m_row[i] - logf(acc + 1e-30f), -80.f), 80.f);
        u[i] = ui;
        eu[i] = expf(ui);
      }
    }
    __syncthreads();
    for (int j = warp; j < n; j += kSmemWarps) {
      float acc = 0.f;
      for (int i = lane; i < m; i += 32) acc = fmaf(e_col[j * m + i], eu[i], acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float vj = fminf(fmaxf(lnu[j] - m_col[j] - logf(acc + 1e-30f), -80.f), 80.f);
        v[j] = vj;
        ev[j] = expf(vj);
      }
    }
    __syncthreads();
  }

  float* o = out + (long long)b * m * n;
  for (int idx = threadIdx.x; idx < m * n; idx += kSmemThreads) {
    const int i = idx / n;
    const int j = idx - i * n;
    o[idx] = s[idx] + u[i] + v[j];
  }
}

template <int CH, int MAXT>
int launch_rows(const Plan& p, const float* scores, const float* log_mu, const float* log_nu,
                float* out, int batch, int m, int n, int iters, cudaStream_t stream) {
  if (p.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(sinkhorn_rows_kernel<CH, MAXT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 p.smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (batch + p.patches - 1) / p.patches;
  sinkhorn_rows_kernel<CH, MAXT><<<blocks, p.patches * p.warps * 32, p.smem_bytes, stream>>>(
      scores, log_mu, log_nu, out, batch, m, n, iters, p.lanes, p.warps,
      rows_patch_floats(m, n, p.lanes, CH));
  return (int)cudaGetLastError();
}

// The instance of the plan's slice width built for its block size.
template <int CH>
int launch_rows_for(const Plan& p, const float* scores, const float* log_mu,
                    const float* log_nu, float* out, int batch, int m, int n, int iters,
                    cudaStream_t stream) {
  if (p.patches * p.warps * 32 <= kNarrowThreads)
    return launch_rows<CH, kNarrowThreads>(p, scores, log_mu, log_nu, out, batch, m, n,
                                           iters, stream);
  if constexpr (max_block_threads(CH) == kWideThreads)
    return launch_rows<CH, kWideThreads>(p, scores, log_mu, log_nu, out, batch, m, n, iters,
                                         stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The plan for (m, n) patches: fills plan[0..5] with the form (0 none, 1
// rows, 2 smem), lanes per row, register chunk, warps per patch, patches per
// block and shared bytes per block; returns the form.
extern "C" int se3et_sinkhorn_plan(int m, int n, int* plan) {
  const Plan p = plan_for(m, n);
  const int v[6] = {p.form, p.lanes, p.chunk, p.warps, p.patches, p.smem_bytes};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return p.form;
}

// form: 1 rows, 2 smem (the first design).  A form that cannot take the
// shape returns cudaErrorInvalidValue without launching.
extern "C" int se3et_sinkhorn_f32(const void* scores, const void* log_mu,
                                  const void* log_nu, void* out, int batch, int m,
                                  int n, int iters, int form, void* stream) {
  if (batch < 1) return 0;
  const Plan p = plan_for(m, n);
  const float* s = (const float*)scores;
  const float* mu = (const float*)log_mu;
  const float* nu = (const float*)log_nu;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (form == kRows) {
    if (p.form != kRows) return (int)cudaErrorInvalidValue;
    switch (p.chunk) {
      case 4: return launch_rows_for<4>(p, s, mu, nu, o, batch, m, n, iters, st);
      case 8: return launch_rows_for<8>(p, s, mu, nu, o, batch, m, n, iters, st);
      case 12: return launch_rows_for<12>(p, s, mu, nu, o, batch, m, n, iters, st);
      case 16: return launch_rows_for<16>(p, s, mu, nu, o, batch, m, n, iters, st);
      case 20: return launch_rows_for<20>(p, s, mu, nu, o, batch, m, n, iters, st);
      case 24: return launch_rows_for<24>(p, s, mu, nu, o, batch, m, n, iters, st);
      case 28: return launch_rows_for<28>(p, s, mu, nu, o, batch, m, n, iters, st);
      case 32: return launch_rows_for<32>(p, s, mu, nu, o, batch, m, n, iters, st);
      case 36: return launch_rows_for<36>(p, s, mu, nu, o, batch, m, n, iters, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (form != kSmem) return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)m * n + 3 * (size_t)(m + n)) * sizeof(float);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_smem_kernel<<<batch, kSmemThreads, smem, st>>>(s, mu, nu, o, m, n, iters);
  return (int)cudaGetLastError();
}
