r"""SE(3) transform utilities on tensors (port of :mod:`se3et_tpu.core.se3`).

The weighted Procrustes rotation is Horn's quaternion method: the top
eigenvector of the symmetric 4x4 matrix by a fixed shifted power
iteration, which batches as a chain of tiny matmuls and always yields a
proper rotation.  All geometry runs in float32.
"""

from __future__ import annotations

import torch


def apply_transform(points: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """points (..., N, 3), transform (..., 4, 4) broadcastable -> (..., N, 3)."""
    rotation = transform[..., :3, :3]
    translation = transform[..., :3, 3]
    return points @ rotation.transpose(-1, -2) + translation[..., None, :]


def compose_transform(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transforms from (..., 3, 3) rotations and (..., 3) translations."""
    out = torch.zeros(rotation.shape[:-2] + (4, 4), dtype=rotation.dtype,
                      device=rotation.device)
    out[..., :3, :3] = rotation
    out[..., :3, 3] = translation
    # fill_ takes the scalar as an argument; assigning it copies a host tensor
    # into a 0-d view, which waits for the card
    out[..., 3, 3].fill_(1.0)
    return out


def inverse_transform(transform: torch.Tensor) -> torch.Tensor:
    inv_r = transform[..., :3, :3].transpose(-1, -2)
    inv_t = -(inv_r @ transform[..., :3, 3, None])[..., 0]
    return compose_transform(inv_r, inv_t)


def quaternion_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix, batched."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def _horn_rotation(h: torch.Tensor, num_iters: int = 30) -> torch.Tensor:
    """Optimal rotation from the covariance ``h = sum_n w_n src_n ref_n^T``."""
    s = h
    sxx, sxy, sxz = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
    syx, syy, syz = s[..., 1, 0], s[..., 1, 1], s[..., 1, 2]
    szx, szy, szz = s[..., 2, 0], s[..., 2, 1], s[..., 2, 2]
    n = torch.stack([
        sxx + syy + szz, syz - szy, szx - sxz, sxy - syx,
        syz - szy, sxx - syy - szz, sxy + syx, szx + sxz,
        szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy,
        sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz,
    ], dim=-1).reshape(h.shape[:-2] + (4, 4))
    # shift so the target eigenvalue is the dominant one in magnitude
    shift = 2.0 * torch.linalg.norm(n, dim=(-2, -1), keepdim=True) + 1e-9
    m = n + shift * torch.eye(4, dtype=h.dtype, device=h.device)
    v = torch.ones(h.shape[:-2] + (4,), dtype=h.dtype, device=h.device)
    for _ in range(num_iters):
        v = (m @ v[..., None])[..., 0]
        v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-20)
    return quaternion_to_rotation(v)


def weighted_procrustes(src_points: torch.Tensor, ref_points: torch.Tensor,
                        weights: torch.Tensor | None = None, weight_thresh: float = 0.0,
                        eps: float = 1e-5) -> torch.Tensor:
    """Weighted Kabsch/Procrustes rigid transform aligning src -> ref.

    src_points, ref_points (..., N, 3); weights (..., N) -> (..., 4, 4).
    """
    if weights is None:
        weights = torch.ones(src_points.shape[:-1], dtype=src_points.dtype,
                             device=src_points.device)
    weights = torch.where(weights < weight_thresh, torch.zeros_like(weights), weights)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + eps)
    w = weights[..., None]
    src_centroid = (src_points * w).sum(dim=-2, keepdim=True)
    ref_centroid = (ref_points * w).sum(dim=-2, keepdim=True)
    h = (src_points - src_centroid).transpose(-1, -2) @ (w * (ref_points - ref_centroid))
    r = _horn_rotation(h)
    t = ref_centroid[..., 0, :] - (r @ src_centroid[..., 0, :, None])[..., 0]
    return compose_transform(r, t)


def isotropic_transform_error(gt_transform: torch.Tensor, est_transform: torch.Tensor):
    """(RRE in degrees, RTE in metres) of (..., 4, 4) transforms; the cosine
    is clipped to [-1, 1] before ``arccos``.  No value leaves the device."""
    gt_r, est_r = gt_transform[..., :3, :3], est_transform[..., :3, :3]
    gt_t, est_t = gt_transform[..., :3, 3], est_transform[..., :3, 3]
    trace = (gt_r * est_r).sum(dim=(-2, -1))
    cos = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    rre = torch.rad2deg(torch.arccos(cos))
    rte = torch.linalg.norm(gt_t - est_t, dim=-1)
    return rre, rte
