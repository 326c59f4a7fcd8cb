r"""Fixed-shape geometry ops on tensors (port of :mod:`se3et_tpu.ops.geometry`).

Static-shape idiom of the JAX package: dynamic sets are fixed budgets plus
boolean masks, and a neighbour/patch index equal to the row count ``N`` is a
sentinel ("no entry").  A sentinel must never reach a CUDA gather
unclamped — an out-of-range index there is a device fault, not a clamp —
so every gather here clamps first and masks after.
"""

from __future__ import annotations

import torch

INF = 1e10


def pairwise_distance(x: torch.Tensor, y: torch.Tensor, normalized: bool = False,
                      clamp: bool = True) -> torch.Tensor:
    """Squared pairwise distances |x_i - y_j|^2, shape (..., N, M)."""
    xy = torch.einsum("...nc,...mc->...nm", x, y)
    if normalized:
        sq = 2.0 - 2.0 * xy
    else:
        x2 = torch.sum(x**2, dim=-1)[..., :, None]
        y2 = torch.sum(y**2, dim=-1)[..., None, :]
        sq = x2 - 2.0 * xy + y2
    if clamp:
        sq = torch.clamp_min(sq, 0.0)
    return sq


def gather_with_sentinel(values: torch.Tensor, indices: torch.Tensor,
                         pad_value: float = 0.0) -> torch.Tensor:
    """Rows of ``values`` (N, ...) at ``indices``; any index outside [0, N)
    (the sentinel N in particular) yields ``pad_value``."""
    n = values.shape[0]
    safe = indices.clamp(0, n - 1).long()
    out = values[safe]
    outside = (indices < 0) | (indices >= n)
    outside = outside.reshape(outside.shape + (1,) * (out.ndim - outside.ndim))
    # the scalar goes to the fill kernel as an argument: a tensor made from
    # it would be a copy from host memory, which waits for the card
    return out.masked_fill(outside, pad_value)


def batched_gather_rows(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Per-batch row gather with sentinel masking.

    values: (B, N, ...); indices: (B, Q, H) with sentinel N -> (B, Q, H, ...),
    zero where the index is the sentinel.
    """
    b, n = values.shape[:2]
    tail = values.shape[2:]
    safe = indices.clamp(0, n - 1).long()
    flat = values.reshape(b, n, -1)
    g = torch.gather(
        flat, 1, safe.reshape(b, -1, 1).expand(-1, -1, flat.shape[-1])
    ).reshape(indices.shape + tail)
    valid = (indices < n).reshape(indices.shape + (1,) * len(tail))
    return torch.where(valid, g, torch.zeros((), dtype=g.dtype, device=g.device))


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor | None,
                   dim: int = -1) -> torch.Tensor:
    """Softmax with ``mask`` (True = keep).  Fully-masked rows produce zeros."""
    if mask is None:
        return torch.softmax(scores, dim=dim)
    neg = torch.finfo(scores.dtype).min
    out = torch.softmax(scores.masked_fill(~mask, neg), dim=dim)
    return out.masked_fill(~mask, 0.0)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim, keepdim: bool = False,
                eps: float = 1e-9) -> torch.Tensor:
    m = mask.to(x.dtype)
    return torch.sum(x * m, dim=dim, keepdim=keepdim) / (
        torch.sum(m, dim=dim, keepdim=keepdim) + eps
    )


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim, keepdim: bool = False):
    neg = torch.finfo(x.dtype).min
    return torch.amax(x.masked_fill(~mask, neg), dim=dim, keepdim=keepdim)
