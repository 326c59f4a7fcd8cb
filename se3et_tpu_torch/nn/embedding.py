r"""Geometric-structure embedding of the coarse transformer
(port of :mod:`se3et_tpu.nn.embedding`).

Pairwise distance + triplet-angle sinusoid embedding, projected to the
model width, plus the per-anchor Wigner-rotated spherical harmonics of pair
directions for the equivariant self-attention layers.  ``fused=True``
runs kernel K3
(:func:`se3et_tpu_torch.ops.kernels.embedding.geometric_embedding`, with
the backward K10 in training); the unfused route is the reference
formulation with [sin | cos] sinusoids.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from se3et_tpu_torch.core import anchors as anchor_lib
from se3et_tpu_torch.core import harmonics
from se3et_tpu_torch import precision as prec
from se3et_tpu_torch.nn.layers import uniform_
from se3et_tpu_torch.ops import geometry
from se3et_tpu_torch.ops.kernels.embedding import geometric_embedding


def real_sh(degrees, vectors: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of unit(vectors) (e3nn order and
    normalisation, as :func:`se3et_tpu.core.harmonics.real_sh`)."""
    n = torch.sqrt(torch.sum(vectors**2, dim=-1, keepdim=True))
    v = vectors / (n + 1e-12)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    out = []
    for l in degrees:
        if l == 0:
            out.append(torch.full(x.shape + (1,), 0.5 / math.sqrt(math.pi),
                                  dtype=vectors.dtype, device=vectors.device))
        elif l == 1:
            c = math.sqrt(3.0 / (4.0 * math.pi))
            out.append(torch.stack([c * y, c * z, c * x], dim=-1))
        elif l == 2:
            c = math.sqrt(15.0 / (4.0 * math.pi))
            c20 = math.sqrt(5.0 / (16.0 * math.pi))
            out.append(torch.stack(
                [c * x * y, c * y * z, c20 * (3.0 * z**2 - 1.0), c * x * z,
                 0.5 * c * (x**2 - y**2)], dim=-1))
        else:
            raise NotImplementedError(f"degree {l}")
    return torch.cat(out, dim=-1)


class GeometricStructureEmbedding(nn.Module):
    """points (B, N, 3), masks (B, N) -> emb (B, N, N, C) [, eq (B, A, N, N, D)]."""

    def __init__(self, hidden_dim, sigma_d, sigma_a, angle_k, reduction_a="max",
                 kanchor=1, n_level_equiv=0):
        super().__init__()
        c = hidden_dim
        self.hidden_dim = c
        self.sigma_d = sigma_d
        self.sigma_a = sigma_a
        self.angle_k = angle_k
        self.reduction_a = reduction_a
        self.kanchor = kanchor
        self.n_level_equiv = n_level_equiv
        # projection kernels are stored (in, out), as in flax
        self.proj_d_kernel = nn.Parameter(torch.empty(c, c))
        self.proj_d_bias = nn.Parameter(torch.empty(c))
        self.proj_a_kernel = nn.Parameter(torch.empty(c, c))
        self.proj_a_bias = nn.Parameter(torch.empty(c))
        if n_level_equiv > 0 and kanchor > 1:
            degrees = list(range(n_level_equiv))
            space = anchor_lib.get_anchor_space(
                kanchor, {4: 3, 6: 4, 12: 5}.get(kanchor, 1))
            wd = harmonics.anchor_wigner_d(degrees, space.anchors)
            # block-diagonal (A, D, D) per-anchor Wigner-D over the degrees
            dim = sum(w.shape[1] for w in wd)
            blk = np.zeros((space.anchors.shape[0], dim, dim), np.float32)
            off = 0
            for w in wd:
                d = w.shape[1]
                blk[:, off:off + d, off:off + d] = w
                off += d
            self.register_buffer("wigner", torch.as_tensor(blk), persistent=False)

    def reset_parameters_with(self, generator):
        bound = 1.0 / math.sqrt(self.hidden_dim)
        for p in (self.proj_d_kernel, self.proj_d_bias, self.proj_a_kernel,
                  self.proj_a_bias):
            uniform_(p, bound, generator)

    def _sinusoid(self, idx):
        c = self.hidden_dim
        div = torch.exp(torch.arange(0, c, 2, device=idx.device, dtype=torch.float32)
                        * (-math.log(10000.0) / c))
        ang = idx[..., None] * div
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    def forward(self, points, masks=None, fused=False, compute_equiv=True, out_dtype=None):
        """``out_dtype``: the fused route's output type (default the compute
        dtype; training passes bf16, the JAX kernel's default)."""
        b, n, _ = points.shape
        k = self.angle_k
        sq = geometry.pairwise_distance(points, points)
        knn_sq = sq if masks is None else sq.masked_fill(~masks[:, None, :], geometry.INF)
        # k+1 nearest, drop self (column 0)
        knn_idx = torch.topk(-knn_sq, k + 1, dim=-1).indices[:, :, 1:]  # (B, N, k)
        knn_points = torch.gather(
            points, 1, knn_idx.reshape(b, n * k, 1).expand(-1, -1, 3)
        ).reshape(b, n, k, 3)

        if fused and self.reduction_a == "max":
            emb = geometric_embedding(
                points, knn_points, self.proj_d_kernel, self.proj_d_bias,
                self.proj_a_kernel, self.proj_a_bias, self.sigma_d, self.sigma_a,
                out_dtype=out_dtype or prec.compute_dtype() or torch.float32,
            )
        else:
            emb = self._unfused(points, torch.sqrt(sq), knn_points)

        if self.n_level_equiv > 0 and self.kanchor > 1 and compute_equiv:
            return emb, self._equiv_embedding(points)
        return emb, None

    def _unfused(self, points, dist, knn_points, row_block=64):
        """Reference formulation, query rows ``row_block`` at a time (the
        (B, rows, M, k, C) angle sinusoid is the largest temporary)."""
        b, n, _ = points.shape
        ref_vectors = knn_points - points[:, :, None, :]  # (B, N, k, 3)
        factor_a = 180.0 / (self.sigma_a * math.pi)
        wd = prec.cast_feature(self.proj_d_kernel)
        wa = prec.cast_feature(self.proj_a_kernel)
        rows = []
        for r0 in range(0, n, row_block):
            r1 = min(n, r0 + row_block)
            anc = points[:, None, :, :] - points[:, r0:r1, None, :]  # (B, R, M, 3)
            ref_b, anc_b = torch.broadcast_tensors(
                ref_vectors[:, r0:r1, None, :, :], anc[:, :, :, None, :])
            sin_values = torch.linalg.norm(torch.cross(ref_b, anc_b, dim=-1), dim=-1)
            # + 0.0 folds a -0 dot product of a self-pair to +0 (XLA's
            # reduction starts from +0): atan2(0, 0) = 0
            cos_values = torch.sum(ref_b * anc_b, dim=-1) + 0.0
            a_idx = torch.atan2(sin_values, cos_values) * factor_a
            d_emb = prec.cast_feature(self._sinusoid(dist[:, r0:r1] / self.sigma_d)) @ wd
            d_emb = d_emb + self.proj_d_bias
            a_emb = prec.cast_feature(self._sinusoid(a_idx)) @ wa + self.proj_a_bias
            a_emb = a_emb.amax(dim=3) if self.reduction_a == "max" else a_emb.mean(dim=3)
            rows.append(d_emb + a_emb)
        return torch.cat(rows, dim=1)

    def _equiv_embedding(self, points):
        """Per-anchor Wigner-rotated SH of pair directions (B, A, N, M, D)."""
        diff = points[:, :, None, :] - points[:, None, :, :]
        sh = real_sh(list(range(self.n_level_equiv)), diff)  # (B, N, M, D)
        return torch.einsum("acd,bnmd->banmc", self.wigner, sh)
