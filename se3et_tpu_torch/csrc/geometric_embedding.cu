// Geometric-structure embedding of the coarse transformer (K3).
//
//   emb[b, n, m, :] = T_d(dist(n, m)) @ Gd + bd
//                     + max_k (T_a(angle_k(n, m)) @ Ga + ba)
//
// T_d / T_a are Chebyshev bases (three-term recurrence) of the clipped
// index variables t = clip(x * inv_half_range - 1, -1, 1); G = A @ W folds
// the static Chebyshev fit of the sinusoid features into the learned
// projection (done by the wrapper).  Same function as the TPU kernel
// se3et_tpu/ops/pallas/embedding.py geometric_embedding_pallas, except that
// the angle is the exact atan2f and the distance is the expanded
// |q|^2 - 2 q.p + |p|^2 form of the reference's pairwise_distance.
//
// bf16 output (serving, and training's bf16 embedding): the TPU kernel's
// roundings (bases and G in bf16, float32 sums, biases and angle max in
// float32, the row rounded to bf16).  Bound: the (B, N, N, C) bf16 write,
// 1.07 GB at the serving shape (0.32 ms); the 88 basis MACs per element
// are 0.10 ms on the tensor cores but 1.41 ms on the float32 CUDA cores,
// where the first design ran them.  Design (embedding_tc_kernel): one block
// per query row, one per SM, of as many warps as shared memory holds beside
// G (16 at C = 256: the projections are chains of dependent mma and the
// stores wait on them, so the card needs many warps to hide them); G (C x
// 64, transposed, bf16) in shared memory for the block; a warp takes 32
// keys at a time, a lane building one key's bases into the warp's basis
// rows (two bf16 per store), then the tile projection shared with K16
// (embedding_tc.cuh: distance and angle products on mma.sync, four channel
// blocks in flight) fills a 16-key x 128-channel staging tile, which leaves
// as coalesced 16-byte streaming stores while the other warps compute.
//
// float32 output (the tiny card-vs-CPU checks): the first design, on the
// CUDA cores (DD + KA*DA = 88 FMAs per output element): one block per
// query row, one thread per channel c.  Each thread keeps its columns of
// Gd and Ga in registers; per tile of TM support points the block first
// builds the bases into shared memory (read back as float4 broadcasts),
// then every thread runs the two projections for its channel and writes
// one coalesced C-wide output row per support point.
//
// The backward (K10) replaces the TPU kernel
// se3et_tpu/ops/pallas/embedding.py _emb_bwd_call.  The forward is linear
// in G, so the gradient of the projections is accumulated in basis space:
//   dGd = sum_{b,n,m} T_d(dist)^T d_emb,  dGa = sum_{b,n,m} T_a(angle_k*)^T d_emb,
//   db  = sum_{b,n,m} d_emb,
// with k* the FIRST k attaining the angle max of each (b, n, m, c).  The
// wrapper forms d_W = A^T dG and d_bd = d_ba = db.  Bound: one read of
// d_emb.  A bf16 d_emb at C = 64, 128 or 256 (training's embedding) takes
// the tensor-core form "tc" (embedding_bwd_tc.cuh, the design noted there).
// float32 (the tiny card-vs-CPU checks) and bf16 at other widths take the
// first design (embedding_bwd_kernel below): the bases and, in float32, the
// angle projections recomputed by the forward's device functions (tile_bases,
// project), in bf16 the argmax from K3's tensor-core projection on the same
// bf16 bases; then 40 + 16 + 1 float32 FMAs per d_emb element on the CUDA
// cores, one block per query row (b, n), one thread per channel, each block
// writing its partial sums, which the wrapper adds in a fixed order (no
// atomics).
#include <algorithm>

#include "embedding_bwd_tc.cuh"
#include "embedding_tc.cuh"

namespace {

using namespace se3et;

constexpr int kTM = 32;

// Bases of one tile of tm support points m0.. of query (qx, qy, qz): the
// distance basis into s_bd[mm] and the KA angle bases into s_ba[k][mm].
template <int DD, int DA, int KA>
__device__ __forceinline__ void tile_bases(const float* pb, int m0, int tm, float qx, float qy,
                                           float qz, float q2, const float* rx, const float* ry,
                                           const float* rz, float inv_d, float inv_a,
                                           float (*s_bd)[DD], float (*s_ba)[kTM][DA]) {
  for (int task = threadIdx.x; task < tm * (1 + KA); task += blockDim.x) {
    const int kind = task / tm;
    const int mm = task - kind * tm;
    const int m = m0 + mm;
    const float px = pb[m * 3 + 0], py = pb[m * 3 + 1], pz = pb[m * 3 + 2];
    if (kind == 0) {
      cheb_basis<DD>(pair_distance(qx, qy, qz, q2, px, py, pz), inv_d, s_bd[mm]);
    } else {
      const int k = kind - 1;
      cheb_basis<DA>(pair_angle(rx[k], ry[k], rz[k], px - qx, py - qy, pz - qz), inv_a,
                     s_ba[k][mm]);
    }
  }
}

// T(x) @ g_col + bias for one basis row (float4 reads of shared memory)
template <int DEG>
__device__ __forceinline__ float project(const float* basis, const float* gcol, float bias) {
  float acc = bias;
  const float4* bv = reinterpret_cast<const float4*>(basis);
#pragma unroll
  for (int j = 0; j < DEG / 4; ++j) {
    const float4 t = bv[j];
    acc = fmaf(t.x, gcol[4 * j + 0], acc);
    acc = fmaf(t.y, gcol[4 * j + 1], acc);
    acc = fmaf(t.z, gcol[4 * j + 2], acc);
    acc = fmaf(t.w, gcol[4 * j + 3], acc);
  }
  return acc;
}

template <int DD, int DA, int KA, typename TOut>
__global__ void embedding_kernel(const float* __restrict__ points,
                                 const float* __restrict__ knn,
                                 const float* __restrict__ gd, const float* __restrict__ bd,
                                 const float* __restrict__ ga, const float* __restrict__ ba,
                                 TOut* __restrict__ out, int n_pts, int c_dim,
                                 float inv_d, float inv_a) {
  __shared__ __align__(16) float s_bd[kTM][DD];
  __shared__ __align__(16) float s_ba[KA][kTM][DA];

  const int b = blockIdx.y;
  const int n = blockIdx.x;
  const int c = threadIdx.x;
  const float* pb = points + (long long)b * n_pts * 3;
  float qx, qy, qz, q2, rx[KA], ry[KA], rz[KA];
  query_geometry<KA>(pb, knn, n_pts, b, n, qx, qy, qz, q2, rx, ry, rz);

  float gdc[DD], gac[DA];
  float bdc = 0.f, bac = 0.f;
  if (c < c_dim) {
#pragma unroll
    for (int j = 0; j < DD; ++j) gdc[j] = gd[j * c_dim + c];
#pragma unroll
    for (int j = 0; j < DA; ++j) gac[j] = ga[j * c_dim + c];
    bdc = bd[c];
    bac = ba[c];
  }
  TOut* ob = out + ((long long)b * n_pts + n) * (long long)n_pts * c_dim;

  for (int m0 = 0; m0 < n_pts; m0 += kTM) {
    const int tm = min(kTM, n_pts - m0);
    __syncthreads();
    tile_bases<DD, DA, KA>(pb, m0, tm, qx, qy, qz, q2, rx, ry, rz, inv_d, inv_a, s_bd, s_ba);
    __syncthreads();
    if (c >= c_dim) continue;
    for (int mm = 0; mm < tm; ++mm) {
      const float acc = project<DD>(s_bd[mm], gdc, bdc);
      float amax = __int_as_float(0xff800000);
#pragma unroll
      for (int k = 0; k < KA; ++k) amax = fmaxf(amax, project<DA>(s_ba[k][mm], gac, bac));
      store(ob + (long long)(m0 + mm) * c_dim + c, acc + amax);
    }
  }
}

// K3 in bf16 on the tensor cores: one block per query row (b, n), up to
// kTcMaxWarps warps (as many as shared memory holds beside G), each taking
// 32-key tiles: a lane builds one key's bases (bf16) into the warp's basis
// rows, then per 16 keys the tile projection of embedding_tc.cuh (shared
// with K16) runs channel block by channel block, the biases are added in
// float32 in the TPU kernel's order, the row is rounded to bf16 into a
// 16-key staging tile, and the tile leaves as coalesced 16-byte streaming
// stores (16 rows of the output, kStageC channels each).
constexpr int kTcMaxWarps = 16;
constexpr int kStageC = 128;              // channels staged at a time
constexpr int kStageStride = kStageC + 8; // bf16 per staging row (rows 4 banks apart)
constexpr size_t kTcWarpBytes = (32 * emb::kBStride + 16 * kStageStride) * 2;

size_t tc_fixed_bytes(int c_dim) {
  return (size_t)c_dim * emb::kGStride * 2 + (size_t)c_dim * 2 * 4;
}

__global__ void __launch_bounds__(32 * kTcMaxWarps, 1)
embedding_tc_kernel(const float* __restrict__ points, const float* __restrict__ knn,
                    const __nv_bfloat16* __restrict__ gt, const float* __restrict__ bd,
                    const float* __restrict__ ba, __nv_bfloat16* __restrict__ out, int n_pts,
                    int c_dim, float inv_d, float inv_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem);            // [C][kGStride]
  float* s_bd = reinterpret_cast<float*>(sg + c_dim * emb::kGStride);     // [C]
  float* s_ba = s_bd + c_dim;                                             // [C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5;
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(s_ba + c_dim) +
                      warp * (32 * emb::kBStride + 16 * kStageStride);  // [32][kBStride]
  __nv_bfloat16* stage = sb + 32 * emb::kBStride;                          // [16][kStageStride]

  emb::load_g(sg, gt, c_dim);
  for (int i = threadIdx.x; i < c_dim; i += blockDim.x) {
    s_bd[i] = bd[i];
    s_ba[i] = ba[i];
  }
  const int b = blockIdx.y, n = blockIdx.x;
  const float* pb = points + (long long)b * n_pts * 3;
  float qx, qy, qz, q2, rx[emb::kKA], ry[emb::kKA], rz[emb::kKA];
  query_geometry<emb::kKA>(pb, knn, n_pts, b, n, qx, qy, qz, q2, rx, ry, rz);
  __nv_bfloat16* orow = out + ((long long)b * n_pts + n) * (long long)n_pts * c_dim;
  __syncthreads();

  for (int m0 = 32 * warp; m0 < n_pts; m0 += 32 * nwarps) {
    __syncwarp();  // the previous tile's fragments are read
    {
      const int m = m0 + lane;
      __nv_bfloat16* mine = sb + lane * emb::kBStride;
      if (m < n_pts) {
        const float px = pb[m * 3 + 0], py = pb[m * 3 + 1], pz = pb[m * 3 + 2];
        float ang[emb::kKA];
#pragma unroll
        for (int k = 0; k < emb::kKA; ++k)
          ang[k] = pair_angle(rx[k], ry[k], rz[k], px - qx, py - qy, pz - qz);
        emb::key_basis(pair_distance(qx, qy, qz, q2, px, py, pz), ang, inv_d, inv_a, mine);
      } else {
        emb::zero_basis(mine);
      }
    }
    __syncwarp();
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      const int key0 = m0 + 16 * mt;
      if (key0 >= n_pts) break;
      emb::BasisFrag f;
      emb::load_basis(sb, 16 * mt, lane, f);
#pragma unroll 1
      for (int cb = 0; cb < c_dim; cb += kStageC) {
        const int cw = min(kStageC, c_dim - cb);
        // four channel blocks per iteration: their products are in flight
        // together before the first result is stored
#pragma unroll 4
        for (int c0 = 0; c0 < cw; c0 += 16) {
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            const int cs = c0 + 8 * jn + 2 * t;  // this lane's channel pair in the stage
            float d[4], amax[4];
            emb::project(f, sg + (cb + c0 + 8 * jn + g) * emb::kGStride + 2 * t, d, amax);
            // T_d @ Gd + bd + max_k (T_a @ Ga + ba), as the TPU kernel sums it
            const float bd0 = s_bd[cb + cs], bd1 = s_bd[cb + cs + 1];
            const float ba0 = s_ba[cb + cs], ba1 = s_ba[cb + cs + 1];
            *reinterpret_cast<__nv_bfloat162*>(stage + g * kStageStride + cs) =
                __floats2bfloat162_rn((d[0] + bd0) + (amax[0] + ba0),
                                      (d[1] + bd1) + (amax[1] + ba1));
            *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * kStageStride + cs) =
                __floats2bfloat162_rn((d[2] + bd0) + (amax[2] + ba0),
                                      (d[3] + bd1) + (amax[3] + ba1));
          }
        }
        __syncwarp();
        const int units = cw / 8;
        for (int u = lane; u < 16 * units; u += 32) {
          const int kk = u / units, cu = u - kk * units;
          if (key0 + kk < n_pts)
            __stcs(reinterpret_cast<uint4*>(orow + (long long)(key0 + kk) * c_dim + cb + 8 * cu),
                   *reinterpret_cast<const uint4*>(stage + kk * kStageStride + 8 * cu));
        }
        __syncwarp();
      }
    }
  }
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// K10: per query row (b, n), partial basis-space gradients
// part[(b*N + n)][0:DD] = dGd rows, [DD:DD+DA] = dGa rows, [DD+DA] = db.
// With a bf16 cotangent (the forward wrote bf16) the first argmax is taken
// over the forward's own angle projections: K3's tensor-core tile projection
// (embedding_tc.cuh) on the same bf16 bases and G, the values bitwise those
// of the forward, each k's index stored per (key, channel) in shared memory.
template <int DD, int DA, int KA, typename TGrad>
__global__ void embedding_bwd_kernel(const float* __restrict__ points,
                                     const float* __restrict__ knn,
                                     const float* __restrict__ ga, const float* __restrict__ ba,
                                     const __nv_bfloat16* __restrict__ gt,
                                     const TGrad* __restrict__ dout, float* __restrict__ part,
                                     int n_pts, int c_dim, float inv_d, float inv_a) {
  constexpr bool kTC = std::is_same<TGrad, __nv_bfloat16>::value;
  __shared__ __align__(16) float s_bd[kTM][DD];
  __shared__ __align__(16) float s_ba[KA][kTM][DA];
  extern __shared__ __align__(16) unsigned char dyn[];
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(dyn);           // [C][kGStride]
  __nv_bfloat16* sbb = sg + c_dim * emb::kGStride;                     // [kTM][kBStride]
  unsigned char* s_k = reinterpret_cast<unsigned char*>(sbb + kTM * emb::kBStride);  // [kTM][C]
  if (kTC) emb::load_g(sg, gt, c_dim);

  const int b = blockIdx.y;
  const int n = blockIdx.x;
  const int c = threadIdx.x;
  const float* pb = points + (long long)b * n_pts * 3;
  float qx, qy, qz, q2, rx[KA], ry[KA], rz[KA];
  query_geometry<KA>(pb, knn, n_pts, b, n, qx, qy, qz, q2, rx, ry, rz);

  float gac[DA];
  float bac = 0.f;
  float dgd[DD], dga[DA], db = 0.f;
#pragma unroll
  for (int j = 0; j < DD; ++j) dgd[j] = 0.f;
#pragma unroll
  for (int j = 0; j < DA; ++j) {
    dga[j] = 0.f;
    gac[j] = c < c_dim ? ga[j * c_dim + c] : 0.f;
  }
  if (c < c_dim) bac = ba[c];
  const TGrad* gb = dout + ((long long)b * n_pts + n) * (long long)n_pts * c_dim;

  for (int m0 = 0; m0 < n_pts; m0 += kTM) {
    const int tm = min(kTM, n_pts - m0);
    __syncthreads();
    tile_bases<DD, DA, KA>(pb, m0, tm, qx, qy, qz, q2, rx, ry, rz, inv_d, inv_a, s_bd, s_ba);
    __syncthreads();
    if constexpr (kTC) {
      // the angle bases in bf16, as the forward rounds them
      for (int i = threadIdx.x; i < kTM * KA * DA; i += blockDim.x) {
        const int mm = i / (KA * DA), j = i - mm * (KA * DA);
        sbb[mm * emb::kBStride + emb::kDDPad + j] = __float2bfloat16(s_ba[j / DA][mm][j % DA]);
      }
      __syncthreads();
      // per 16 keys x 8 channels: the KA projections + ba, first argmax
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
      const int items = 2 * (c_dim / 8);
      for (int it = warp; it < items; it += blockDim.x >> 5) {
        const int mt = it & 1, c8 = (it >> 1) * 8;
        emb::BasisFrag f;
        emb::load_basis(sbb, 16 * mt, lane, f);
        float a[KA][4];
        emb::angle_project(f, sg + (c8 + g) * emb::kGStride + 2 * t, a);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ch = c8 + 2 * t + (i & 1);
          const float bias = ba[ch];
          float v[KA], amax = __int_as_float(0xff800000);
#pragma unroll
          for (int k = 0; k < KA; ++k) {
            v[k] = a[k][i] + bias;
            amax = fmaxf(amax, v[k]);
          }
          int kstar = 0;
#pragma unroll
          for (int k = KA - 1; k >= 0; --k) kstar = v[k] == amax ? k : kstar;
          s_k[(16 * mt + g + (i >> 1) * 8) * c_dim + ch] = (unsigned char)kstar;
        }
      }
      __syncthreads();
    }
    if (c >= c_dim) continue;
    for (int mm = 0; mm < tm; ++mm) {
      const float d = load_f(gb + (long long)(m0 + mm) * c_dim + c);
      int kstar = 0;
      if constexpr (kTC) {
        kstar = s_k[mm * c_dim + c];
      } else {
        // the forward's angle values and their max, then the first argmax
        float a[KA];
        float amax = __int_as_float(0xff800000);
#pragma unroll
        for (int k = 0; k < KA; ++k) {
          a[k] = project<DA>(s_ba[k][mm], gac, bac);
          amax = fmaxf(amax, a[k]);
        }
#pragma unroll
        for (int k = KA - 1; k >= 0; --k) kstar = a[k] == amax ? k : kstar;
      }
      const float* td = s_bd[mm];
#pragma unroll
      for (int j = 0; j < DD; ++j) dgd[j] = fmaf(td[j], d, dgd[j]);
      const float* ta = s_ba[kstar][mm];
#pragma unroll
      for (int j = 0; j < DA; ++j) dga[j] = fmaf(ta[j], d, dga[j]);
      db += d;
    }
  }
  if (c >= c_dim) return;
  float* pr = part + ((long long)b * n_pts + n) * (DD + DA + 1) * c_dim + c;
#pragma unroll
  for (int j = 0; j < DD; ++j) pr[(long long)j * c_dim] = dgd[j];
#pragma unroll
  for (int j = 0; j < DA; ++j) pr[(long long)(DD + j) * c_dim] = dga[j];
  pr[(long long)(DD + DA) * c_dim] = db;
}

// float32: the CUDA-core kernel (the float32 chain rounds nothing)
int launch_f32(const void* points, const void* knn, const void* gd, const void* bd,
               const void* ga, const void* ba, void* out, int batch, int n_pts, int c_dim,
               int deg_d, int deg_a, int ka, float inv_d, float inv_a, void* stream) {
  if (deg_d != 40 || deg_a != 16 || ka != 3 || c_dim > 1024 || c_dim < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = ((c_dim + 31) / 32) * 32;
  dim3 grid(n_pts, batch);
  embedding_kernel<40, 16, 3, float><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)knn, (const float*)gd, (const float*)bd,
      (const float*)ga, (const float*)ba, (float*)out, n_pts, c_dim, inv_d, inv_a);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core kernel; gt the folded G (C x 64) transposed, bf16
int launch_bf16(const void* points, const void* knn, const void* gt, const void* bd,
                const void* ba, void* out, int batch, int n_pts, int c_dim, int deg_d,
                int deg_a, int ka, float inv_d, float inv_a, void* stream) {
  if (deg_d != emb::kDD || deg_a != emb::kDA || ka != emb::kKA || c_dim > 1024 || c_dim < 16 ||
      c_dim % 16)
    return (int)cudaErrorInvalidValue;
  // as many warps as the SM's shared memory holds beside G (16 at C = 256)
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t fixed = tc_fixed_bytes(c_dim);
  const int warps = (int)std::min<size_t>(kTcMaxWarps, ((size_t)max_smem - fixed) / kTcWarpBytes);
  if ((size_t)max_smem < fixed || warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + warps * kTcWarpBytes;
  e = cudaFuncSetAttribute(embedding_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_pts, batch);
  embedding_tc_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)knn, (const __nv_bfloat16*)gt, (const float*)bd,
      (const float*)ba, (__nv_bfloat16*)out, n_pts, c_dim, inv_d, inv_a);
  return (int)cudaGetLastError();
}

template <typename TGrad>
int launch_bwd(const void* points, const void* knn, const void* ga, const void* ba,
               const void* gt, const void* dout, void* part, int batch, int n_pts, int c_dim,
               int deg_d, int deg_a, int ka, float inv_d, float inv_a, void* stream) {
  constexpr bool kTC = std::is_same<TGrad, __nv_bfloat16>::value;
  if (deg_d != 40 || deg_a != 16 || ka != 3 || c_dim > 1024 || c_dim < 1 ||
      (kTC && (c_dim % 16 || gt == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  auto fn = embedding_bwd_kernel<40, 16, 3, TGrad>;
  const size_t smem = kTC ? (size_t)c_dim * emb::kGStride * 2 + (size_t)kTM * emb::kBStride * 2 +
                                (size_t)kTM * c_dim
                          : 0;
  if (kTC) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((c_dim + 31) / 32) * 32;
  dim3 grid(n_pts, batch);
  fn<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)knn, (const float*)ga, (const float*)ba,
      (const __nv_bfloat16*)gt, (const TGrad*)dout, (float*)part, n_pts, c_dim, inv_d, inv_a);
  return (int)cudaGetLastError();
}

// bf16 at C = 64, 128, 256: the tc form, `blocks` persistent blocks (one an
// SM), each writing (kParts, C) float32 partials
template <int C>
int launch_bwd_tc(const void* points, const void* knn, const void* gt, const void* dout,
                  void* part, long long tiles, int n_pts, int blocks, float inv_d, float inv_a,
                  void* stream) {
  auto fn = emb_bwd_tc::embedding_bwd_tc_kernel<C>;
  constexpr size_t smem = emb_bwd_tc::smem_bytes<C>();
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<blocks, C, smem, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)knn, (const __nv_bfloat16*)gt,
      (const __nv_bfloat16*)dout, (float*)part, n_pts, tiles, inv_d, inv_a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int se3et_geometric_embedding_bwd_tc(
    const void* points, const void* knn, const void* gt, const void* dout, void* part,
    int batch, int n_pts, int c_dim, int blocks, int deg_d, int deg_a, int ka, float inv_d,
    float inv_a, void* stream) {
  const long long tiles = (long long)batch * n_pts * ((n_pts + emb_bwd_tc::kKeys - 1) /
                                                      emb_bwd_tc::kKeys);
  if (deg_d != emb::kDD || deg_a != emb::kDA || ka != emb::kKA || batch < 1 || n_pts < 1 ||
      blocks < 1 || blocks > tiles)
    return (int)cudaErrorInvalidValue;
  switch (c_dim) {
    case 64:
      return launch_bwd_tc<64>(points, knn, gt, dout, part, tiles, n_pts, blocks, inv_d, inv_a,
                               stream);
    case 128:
      return launch_bwd_tc<128>(points, knn, gt, dout, part, tiles, n_pts, blocks, inv_d,
                                inv_a, stream);
    case 256:
      return launch_bwd_tc<256>(points, knn, gt, dout, part, tiles, n_pts, blocks, inv_d,
                                inv_a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int se3et_geometric_embedding_bwd_bf16(
    const void* points, const void* knn, const void* ga, const void* ba, const void* gt,
    const void* dout, void* part, int batch, int n_pts, int c_dim, int deg_d, int deg_a, int ka,
    float inv_d, float inv_a, void* stream) {
  return launch_bwd<__nv_bfloat16>(points, knn, ga, ba, gt, dout, part, batch, n_pts, c_dim,
                                   deg_d, deg_a, ka, inv_d, inv_a, stream);
}

extern "C" int se3et_geometric_embedding_bwd_f32(
    const void* points, const void* knn, const void* ga, const void* ba, const void* dout,
    void* part, int batch, int n_pts, int c_dim, int deg_d, int deg_a, int ka, float inv_d,
    float inv_a, void* stream) {
  return launch_bwd<float>(points, knn, ga, ba, nullptr, dout, part, batch, n_pts, c_dim,
                           deg_d, deg_a, ka, inv_d, inv_a, stream);
}

extern "C" int se3et_geometric_embedding_bf16(
    const void* points, const void* knn, const void* gt, const void* bd, const void* ba,
    void* out, int batch, int n_pts, int c_dim, int deg_d, int deg_a, int ka, float inv_d,
    float inv_a, void* stream) {
  return launch_bf16(points, knn, gt, bd, ba, out, batch, n_pts, c_dim, deg_d, deg_a, ka,
                     inv_d, inv_a, stream);
}

extern "C" int se3et_geometric_embedding_f32(
    const void* points, const void* knn, const void* gd, const void* bd, const void* ga,
    const void* ba, void* out, int batch, int n_pts, int c_dim, int deg_d, int deg_a,
    int ka, float inv_d, float inv_a, void* stream) {
  return launch_f32(points, knn, gd, bd, ga, ba, out, batch, n_pts, c_dim, deg_d, deg_a, ka,
                    inv_d, inv_a, stream);
}
