// K10's bf16 form ("tc"; C = 64, 128 or 256), included only by
// geometric_embedding.cu.  For the cotangent D = d_emb (B, N, N, C) of K3's
// bf16 embedding it sums, over every (b, n, m),
//   dGd += T_d(dist)^T D,   dGa += sum_k T_a(angle_k)^T (D * [k == k*]),
// with k* the FIRST k attaining the maximum of the three angle projections
// T_a(angle_k) @ Ga, as the forward took it (before its bias); db is dGd's
// row 0 (T_0 = 1).  The rounding is the TPU kernel's
// (se3et_tpu/ops/pallas/embedding.py _embedding_bwd_kernel): the bases in
// bf16, D as it is, products summed in float32.
//
// Bound: bytes.  D is read once: 1.07 GB at B = 2, N = 1024, C = 256, 0.32
// ms on the card.  The work beside it is 144 multiply-adds per element of
// D (48 for dGd, 3 x 16 for dGa, 3 x 16 to recompute the projections),
// 0.16 ms at the tensor cores' peak; on the float32 CUDA cores, where the
// first design ran it, it alone took ~1 ms.
//
// Design: one persistent block per SM, C / 32 warps, each block a fixed
// contiguous run of (row, 64-key) tiles over all B * N query rows; warp w
// owns channels 32w .. 32w + 31, and its share of dGd (48 x 32, the
// distance basis padded to three k-steps) and dGa (16 x 32) lives in 64
// float32 mma accumulators a lane for the whole run.  Per tile:
// 1. the block builds the 64 keys' bf16 basis rows (K3's layout and
//    functions, emb::cheb_basis_bf16 on pair_distance / pair_angle): a
//    quarter of the lanes the distance basis, the rest one angle each, into
//    one of two buffers, while the other warps may still finish the
//    previous tile;
// 2. one block barrier; the tile of D three tiles ahead is put on its way
//    by cp.async (16 bytes a thread, evict-first in L2, chunks XOR-swizzled
//    by key so ldmatrix.trans reads them without bank conflicts) into a ring
//    of four 64-key slots;
// 3. per 16 keys, every warp: D as the B fragments of its four n-tiles
//    (ldmatrix.trans); the three angle projections on mma.sync from the
//    same A fragments of the same bf16 bases and B fragments of the same G
//    as K3's emb::angle_project (so the values, and their max, are K3's bit
//    for bit), in K3's layout (keys g / g + 8, channels 2t / 2t + 1); per
//    element the signs of a0 - max(a1, a2) (k* != 0) and a1 - a2 (then k* ==
//    2), two bytes per element, moved by one movmatrix per 8 x 8 onto
//    the lanes that hold the same (key, channel) of D (keys 2t, 2t + 1 of
//    channel g) and expanded by prmt into 16-bit masks: D split into
//    D * [k* == k] with three logic operations; then dGd += T_d^T D (three
//    k-steps) and dGa += T_a(k)^T D_k for k = 0, 1, 2, the bases' A
//    fragments by ldmatrix.trans.
// Each block writes its (57, C) float32 partials (dGd's 40 rows, dGa's 16,
// db) once; the wrapper adds them in a fixed order, so the form is
// deterministic.  The projections are not computed transposed (channels as
// rows, which would leave the masks on D's lanes without movmatrix): K3's
// operand order keeps the argmax K3's own by construction.
// What bounds it (scripts/probe_geometric_embedding_bwd.py, H100): the
// stream alone runs at 93 % of the bound and the bases hide behind it, but
// the three phases do not overlap on 8 warps an SM: per warp and 16 keys
// 36 mma.sync, 11 ldmatrix.x4 (9 of them the same bases in every warp) and
// ~130 logic and float operations, and the bases' build, during which every
// warp leaves the tensor cores idle, costs a quarter of the kernel.
// EMB_BWD_TC_STAGE cuts the kernel for the probe's ablations: 0 the stream
// of D only, 1 + the bases, 2 + the projections, argmax and masks, 3 (the
// form) + the accumulation; EMB_BWD_TC_NO_BASES leaves the bases unbuilt
// (timing only).
#pragma once

#include "async_copy.cuh"
#include "embedding_tc.cuh"

#ifndef EMB_BWD_TC_STAGE
#define EMB_BWD_TC_STAGE 3
#endif

namespace se3et {
namespace emb_bwd_tc {

using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;                        // keys a tile
constexpr int kSlots = 4;                        // tiles of D in the ring
constexpr int kParts = emb::kDD + emb::kDA + 1;  // partial rows: dGd, dGa, db
constexpr int kStage = EMB_BWD_TC_STAGE;

// the ring of D's tiles [kSlots][kKeys][C] and the two basis buffers
// [2][kKeys][kBStride], bf16
template <int C>
constexpr size_t smem_bytes() {
  return (size_t)kSlots * kKeys * C * 2 + 2 * (size_t)kKeys * emb::kBStride * 2;
}

// prmt with the selector's sign-replicating nibbles
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// an 8 x 8 matrix of 16-bit elements in mma fragment layout, transposed
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// d = a . b on zeros (C = +0, as emb::angle_project starts its sums)
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// D of one n-tile (d[0]: keys 2t, 2t + 1 of channel g, d[1]: keys 2t + 8,
// 2t + 9) split by the first argmax k* of the three angle projections a[k]
// of the same 16 keys x 8 channels in K3's layout (keys g / g + 8, channels
// 2t / 2t + 1): dk[k][h] holds D where k* == k, else 0
__device__ __forceinline__ void split_by_argmax(const float (&a)[emb::kKA][4],
                                                const uint32_t (&d)[2],
                                                uint32_t (&dk)[emb::kKA][2]) {
  // sign of x: a0 below max(a1, a2), so k* != 0; sign of y: a1 below a2,
  // so k* == 2 where k* != 0 (a tie leaves the sign clear: the first k wins)
  uint32_t x[4], y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = __float_as_uint(a[0][i] - fmaxf(a[1][i], a[2][i]));
    y[i] = __float_as_uint(a[1][i] - a[2][i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // keys g (h = 0) or g + 8: per 16-bit element the sign of y in its low
    // byte and of x in its high byte, then transposed onto D's lanes
    const uint32_t ys = prmt(y[2 * h], y[2 * h + 1], 0x7733);
    const uint32_t xs = prmt(x[2 * h], x[2 * h + 1], 0x7733);
    const uint32_t v = movmatrix_trans((ys & 0x00ff00ffu) | (xs & 0xff00ff00u));
    const uint32_t not0 = prmt(v, 0, 0xbb99), lt = prmt(v, 0, 0xaa88);
    dk[0][h] = d[h] & ~not0;
    dk[1][h] = d[h] & not0 & ~lt;
    dk[2][h] = d[h] & not0 & lt;
  }
}

// points (B, N, 3) f32; knn (B, N, 3, 3) f32; gt the folded G (C, 64) bf16
// as K3 reads it (embedding_tc.cuh); dout (B, N, N, C) bf16; part
// (gridDim.x, kParts, C) f32; tiles = B * N * ceil(N / kKeys)
template <int C>
__global__ void __launch_bounds__(C, 1)
embedding_bwd_tc_kernel(const float* __restrict__ points, const float* __restrict__ knn,
                        const bf16* __restrict__ gt, const bf16* __restrict__ dout,
                        float* __restrict__ part, int n_pts, long long tiles, float inv_d,
                        float inv_a) {
  constexpr int kThreads = C, kChunks = C / 8;
  static_assert(C % 64 == 0 && C <= 256, "chunks XOR-swizzled in groups of 8, 8 warps at most");
  extern __shared__ __align__(128) unsigned char emb_bwd_smem[];
  bf16* ring = reinterpret_cast<bf16*>(emb_bwd_smem);  // [kSlots][kKeys][C], swizzled
  bf16* bases = ring + (size_t)kSlots * kKeys * C;     // [2][kKeys][kBStride]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row a lane addresses
  const int row_tiles = (n_pts + kKeys - 1) / kKeys;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  const uint64_t policy = evict_first_policy();

  // D's tile `tile` into ring slot `slot`, zero past n; a group either way
  auto issue = [&](long long tile, int slot) {
    if (tile < t1) {
      const long long row = tile / row_tiles;
      const int key0 = (int)(tile - row * row_tiles) * kKeys;
      const bf16* src = dout + (row * n_pts + key0) * C;
      bf16* dst = ring + (size_t)slot * kKeys * C;
#pragma unroll
      for (int i = tid; i < kKeys * kChunks; i += kThreads) {
        const int key = i / kChunks, ch = i % kChunks;
        const bool ok = key0 + key < n_pts;
        cp_async16_hint(dst + key * C + 8 * (ch ^ (key & 7)),
                        ok ? src + key * C + 8 * ch : dout, ok, policy);
      }
    }
    cp_async_commit();
  };

  // the basis rows of tile `tile`'s keys: a task per (key, basis), kind 0
  // the distance, 1 + k angle k (warp-uniform: kKeys is a multiple of 32);
  // zeros past n
  auto build = [&](long long tile, bf16* sb) {
    const long long row = tile / row_tiles;
    const int key0 = (int)(tile - row * row_tiles) * kKeys;
    const float* pb = points + (row / n_pts) * n_pts * 3;
    const float qx = points[row * 3 + 0], qy = points[row * 3 + 1], qz = points[row * 3 + 2];
    for (int task = tid; task < (1 + emb::kKA) * kKeys; task += kThreads) {
      const int kind = task / kKeys, kk = task % kKeys, m = key0 + kk;
      bf16* dst = sb + kk * emb::kBStride + (kind ? emb::kDDPad + emb::kDA * (kind - 1) : 0);
      const int len = kind ? emb::kDA : emb::kDDPad;
      if (m >= n_pts) {
        for (int j = 0; j < len; j += 2)
          *reinterpret_cast<__nv_bfloat162*>(dst + j) = __floats2bfloat162_rn(0.f, 0.f);
        continue;
      }
      const float px = pb[m * 3 + 0], py = pb[m * 3 + 1], pz = pb[m * 3 + 2];
      if (kind == 0) {
        // as query_geometry and emb::key_basis compute it for K3
        const float q2 = qx * qx + qy * qy + qz * qz;
        emb::cheb_basis_bf16<emb::kDD>(pair_distance(qx, qy, qz, q2, px, py, pz), inv_d, dst);
#pragma unroll
        for (int j = emb::kDD; j < emb::kDDPad; j += 2)
          *reinterpret_cast<__nv_bfloat162*>(dst + j) = __floats2bfloat162_rn(0.f, 0.f);
      } else {
        const float* kp = knn + (row * emb::kKA + kind - 1) * 3;
        emb::cheb_basis_bf16<emb::kDA>(
            pair_angle(kp[0] - qx, kp[1] - qy, kp[2] - qz, px - qx, py - qy, pz - qz), inv_a,
            dst);
      }
    }
  };

  // G's angle rows for this warp's channels: K3's B fragments of
  // emb::angle_project, held for the whole run
  const int cw = 32 * warp;
  uint32_t gb[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const bf16* gcol = gt + (size_t)(cw + 8 * nt + g) * emb::kDeg + emb::kDDPad + 2 * t;
    gb[nt][0] = __ldg(reinterpret_cast<const unsigned int*>(gcol));
    gb[nt][1] = __ldg(reinterpret_cast<const unsigned int*>(gcol + 8));
  }
  float acc_d[emb::kDDPad / 16][4][4], acc_a[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc_a[nt][i] = 0.f;
#pragma unroll
      for (int s = 0; s < emb::kDDPad / 16; ++s) acc_d[s][nt][i] = 0.f;
    }
  }
  uint32_t sink = 0;  // keeps the cut kernels' masks (EMB_BWD_TC_STAGE 2)

#pragma unroll
  for (int s = 0; s < kSlots - 1; ++s) issue(t0 + s, s);
  for (long long tile = t0; tile < t1; ++tile) {
    const int i = (int)(tile - t0);
    bf16* sb = bases + (i & 1) * kKeys * emb::kBStride;
#ifndef EMB_BWD_TC_NO_BASES
    if (kStage >= 1) build(tile, sb);
#endif
    cp_async_wait<kSlots - 2>();
    __syncthreads();  // tile's D and bases are in; tile - 1's slot and bases are free
    issue(tile + kSlots - 1, (i + kSlots - 1) % kSlots);
    if (kStage < 2) continue;
    const bf16* ds = ring + (size_t)(i % kSlots) * kKeys * C;
    const int valid = n_pts - (int)(tile % row_tiles) * kKeys;  // keys below n, from key0
    const int steps = min(kKeys, valid + 15) / 16;
#pragma unroll 1
    for (int st = 0; st < steps; ++st) {
      const int k0 = 16 * st;
      uint32_t d[4][2];  // B fragments of D, n-tiles nt of the warp's channels
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int key = k0 + mr + 8 * (mi & 1), ch = 4 * warp + 2 * p + (mi >> 1);
        uint32_t r[4];
        ldmatrix_x4_trans(r, ds + key * C + 8 * (ch ^ (key & 7)));
        d[2 * p][0] = r[0];
        d[2 * p][1] = r[1];
        d[2 * p + 1][0] = r[2];
        d[2 * p + 1][1] = r[3];
      }
      // the angle bases as emb::load_basis loads them (keys x basis terms)
      uint32_t fa[emb::kKA][4];
#pragma unroll
      for (int k = 0; k < emb::kKA; ++k)
        ldmatrix_x4(fa[k], sb + (k0 + mr + 8 * (mi & 1)) * emb::kBStride + emb::kDDPad +
                               emb::kDA * k + 8 * (mi >> 1));
      uint32_t dk[4][emb::kKA][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float a[emb::kKA][4];
#pragma unroll
        for (int k = 0; k < emb::kKA; ++k) mma_bf16_zero(a[k], fa[k], gb[nt][0], gb[nt][1]);
        split_by_argmax(a, d[nt], dk[nt]);
      }
      if (kStage < 3) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) sink ^= dk[nt][0][0] ^ dk[nt][1][1] ^ dk[nt][2][0];
        continue;
      }
      // the bases transposed (basis terms x keys): A fragments of T^T, the
      // distance basis' three k-steps, then the three angles
      const bf16* tb = sb + (k0 + mr + 8 * (mi >> 1)) * emb::kBStride + 8 * (mi & 1);
#pragma unroll
      for (int s = 0; s < emb::kDDPad / 16; ++s) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, tb + 16 * s);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc_d[s][nt], f[0], f[1], f[2], f[3], d[nt][0], d[nt][1]);
      }
#pragma unroll
      for (int k = 0; k < emb::kKA; ++k) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, tb + emb::kDDPad + emb::kDA * k);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc_a[nt], f[0], f[1], f[2], f[3], dk[nt][k][0], dk[nt][k][1]);
      }
    }
  }
  cp_async_wait<0>();

  // the block's partials: rows j = 16 s + g (+ 8) of dGd below kDD, dGa's
  // 16, and db = dGd's row 0
  float* pp = part + (size_t)blockIdx.x * kParts * C;
  if (kStage < 3 && sink == 0x9e3779b9u) pp[0] = 1.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int ch = cw + 8 * nt + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int s = 0; s < emb::kDDPad / 16; ++s) {
        const int j = 16 * s + g + 8 * h;
        if (j < emb::kDD)
          *reinterpret_cast<float2*>(pp + j * C + ch) =
              make_float2(acc_d[s][nt][2 * h], acc_d[s][nt][2 * h + 1]);
      }
      *reinterpret_cast<float2*>(pp + (emb::kDD + g + 8 * h) * C + ch) =
          make_float2(acc_a[nt][2 * h], acc_a[nt][2 * h + 1]);
    }
    if (g == 0)
      *reinterpret_cast<float2*>(pp + (emb::kDD + emb::kDA) * C + ch) =
          make_float2(acc_d[0][nt][0], acc_d[0][nt][1]);
  }
}

}  // namespace emb_bwd_tc
}  // namespace se3et
