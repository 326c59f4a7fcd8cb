r"""Geometric-structure embedding kernel (K3).

Counterpart of ``se3et_tpu/ops/pallas/embedding.py``
(``geometric_embedding_pallas``).  The map ``x -> [sin(x div) | cos(x div)]
@ W + b`` is a smooth function of one scalar, so it is evaluated as a
Chebyshev expansion ``T(t(x)) @ G + b`` with ``G = A @ W`` folded per call
from the static fit table ``A`` — 40 (distance) and 16 (angle) basis terms
in place of 128 sin/cos pairs per element, at a fit error below 1e-5 per
sinusoid feature.  The kernel (``csrc/geometric_embedding.cu``) writes the
(B, N, N, C) embedding straight from coordinates; the projections run in
its body, as they do inside the TPU kernel.

Differences from the TPU kernel, both towards the reference: the angle is
an exact ``atan2`` (the TPU kernel uses a polynomial), and the distance is
the reference's expanded ``|q|^2 - 2 q.p + |p|^2`` form.

The projection parameters are differentiable (training): the backward is
kernel K10 (:func:`geometric_embedding_bwd`, in the same source; replaces
the TPU ``_emb_bwd_call``), which accumulates the gradient in basis space
with the angle max routed to its first argmax, on the form
:func:`geometric_embedding_bwd_form` names.  Points take no gradient.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from se3et_tpu_torch.ops.geometry import pairwise_distance
from se3et_tpu_torch.ops.kernels import _build

DEG = 64  # largest Chebyshev basis considered by pick_deg
D_INDEX_MAX = 48.0  # distance-index range of the fit (indices = dist / sigma_d)
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# K10's tc form: the embedding widths it is built for, and its (distance,
# angle) basis sizes and angle neighbours (csrc/embedding_bwd_tc.cuh)
BWD_TC_WIDTHS = (64, 128, 256)
BWD_TC_KEYS = 64  # keys a tile of the tc form
BWD_BASES = (40, 16, 3)
BWD_PARTS = 57  # partial rows of a block or query row: dGd (40), dGa (16), db


@functools.lru_cache(maxsize=None)
def chebyshev_sinusoid_table(c: int, x_max: float, deg: int = DEG) -> np.ndarray:
    """(deg, 2*(c//2)) Chebyshev coefficients, on ``t = 2x/x_max - 1``, of
    the sinusoid features ``[sin(x*div_j) | cos(x*div_j)]`` for x in
    [0, x_max], ``div_j = 10000^(-2j/c)``."""
    div = np.exp(np.arange(0, c, 2) * (-np.log(10000.0) / c))
    npts = 8 * deg
    t = np.cos(np.pi * (np.arange(npts) + 0.5) / npts)
    x = 0.5 * (t + 1.0) * x_max
    feats = np.concatenate(
        [np.sin(x[:, None] * div[None, :]), np.cos(x[:, None] * div[None, :])],
        axis=1,
    )
    return np.polynomial.chebyshev.chebfit(t, feats, deg - 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def pick_deg(c: int, x_max: float, tol: float = 1e-5, max_deg: int = DEG) -> int:
    """Smallest basis size (multiple of 8, from 16) whose fit error over
    [0, x_max] is below ``tol``."""
    x = np.linspace(0.0, x_max, 4001)
    t = 2.0 * x / x_max - 1.0
    div = np.exp(np.arange(0, c, 2) * (-np.log(10000.0) / c))
    feats = np.concatenate(
        [np.sin(x[:, None] * div[None, :]), np.cos(x[:, None] * div[None, :])],
        axis=1,
    )
    for deg in range(16, max_deg + 1, 8):
        a = chebyshev_sinusoid_table(c, x_max, deg)
        if np.abs(np.polynomial.chebyshev.chebval(t, a).T - feats).max() < tol:
            return deg
    return max_deg


@functools.lru_cache(maxsize=None)
def _fit_table(c: int, x_max: float, deg: int, device: torch.device) -> torch.Tensor:
    """:func:`chebyshev_sinusoid_table` as a tensor on ``device``, copied there
    once: a copy from host memory per call would wait for the card."""
    return torch.as_tensor(chebyshev_sinusoid_table(c, x_max, deg), device=device)


def _folded_projections(wd, wa, sigma_a):
    """(deg_d, deg_a, Gd = A_d @ wd, Ga = A_a @ wa) in float32."""
    c = wd.shape[1]
    x_max_a = math.pi * (180.0 / (sigma_a * math.pi))
    deg_d = pick_deg(c, D_INDEX_MAX)
    deg_a = pick_deg(c, float(x_max_a))
    a_d = _fit_table(c, D_INDEX_MAX, deg_d, wd.device)
    a_a = _fit_table(c, float(x_max_a), deg_a, wa.device)
    return deg_d, deg_a, a_d @ wd.float(), a_a @ wa.float()


def _cheb_basis(x, inv_half_range, deg):
    """T(clip(x * inv_half_range - 1)) for an index tensor x (...) -> (..., deg)."""
    t = torch.clamp(x * inv_half_range - 1.0, -1.0, 1.0)
    rows = [torch.ones_like(t), t]
    while len(rows) < deg:
        rows.append(2.0 * t * rows[-1] - rows[-2])
    return torch.stack(rows[:deg], dim=-1)


def _cheb_project(x, inv_half_range, g, bias, dtype=torch.float32):
    """T(clip(x * inv_half_range - 1)) @ G + b for an index tensor x (...),
    the basis and G rounded to ``dtype`` (bf16: the TPU kernel's chain),
    products summed in float32."""
    return _rnd(_cheb_basis(x, inv_half_range, g.shape[0]), dtype) @ _rnd(g, dtype) + bias


def _rnd(t, dtype):
    """``t`` rounded to ``dtype``, held in float32."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def tc_table(gd, ga):
    """The folded projections as the tensor-core tile projection reads them
    (``csrc/embedding_tc.cuh``): (C, 64) bf16 rows ``[Gd (40) | 0 (8) | Ga
    (16)]``, G transposed."""
    if (gd.shape[0], ga.shape[0]) != (40, 16):
        raise ValueError(f"the tensor-core projection takes 40 distance and 16 angle basis "
                         f"terms, got {gd.shape[0]} and {ga.shape[0]}")
    gt = torch.zeros((gd.shape[1], 64), dtype=torch.bfloat16, device=gd.device)
    gt[:, :40] = gd.t()
    gt[:, 48:] = ga.t()
    return gt


def _pair_geometry(points, knn_points, r0, r1):
    """Triplet angles (B, R, N, k) of query rows r0:r1, float32."""
    ref = knn_points[:, r0:r1].float() - points[:, r0:r1, None, :]  # (B, R, k, 3)
    anc = points[:, None, :, :] - points[:, r0:r1, None, :]  # (B, R, N, 3)
    ref_b, anc_b = torch.broadcast_tensors(ref[:, :, None, :, :], anc[:, :, :, None, :])
    sin_v = torch.linalg.norm(torch.cross(ref_b, anc_b, dim=-1), dim=-1)
    # + 0.0 folds a -0 dot product of a self-pair to +0: atan2(0, 0) = 0
    cos_v = torch.sum(ref_b * anc_b, dim=-1) + 0.0
    return torch.atan2(sin_v, cos_v)


def geometric_embedding_plain(points, knn_points, wd, bd, wa, ba, sigma_d, sigma_a,
                              out_dtype=torch.bfloat16, row_block=128):
    """Plain version of K3.

    points: (B, N, 3) f32; knn_points: (B, N, k, 3) f32; wd/wa: (C, C)
    projection kernels stored (in, out); bd/ba: (C,).  Returns (B, N, N, C)
    in ``out_dtype``.  For a bf16 output the TPU kernel's chain: the bases
    and G rounded to bf16, products summed in float32, the biases and the
    angle max in float32, the row rounded to bf16; in float32 nothing is
    rounded.  Query rows are processed ``row_block`` at a time to bound the
    (rows, N, k, C) angle temporaries.
    """
    b, n, _ = points.shape
    _, _, gd, ga = _folded_projections(wd, wa, sigma_a)
    inv_d = 2.0 / (D_INDEX_MAX * sigma_d)
    inv_a = 2.0 / math.pi
    points = points.float()
    dist = torch.sqrt(pairwise_distance(points, points))  # (B, N, N)
    out = torch.empty((b, n, n, wd.shape[1]), dtype=out_dtype, device=points.device)
    for r0 in range(0, n, row_block):
        r1 = min(n, r0 + row_block)
        ang = _pair_geometry(points, knn_points, r0, r1)  # (B, R, N, k)
        a_emb = _cheb_project(ang, inv_a, ga, ba.float(), out_dtype).amax(dim=3)
        d_emb = _cheb_project(dist[:, r0:r1], inv_d, gd, bd.float(), out_dtype)
        out[:, r0:r1] = (d_emb + a_emb).to(out_dtype)
    return out


def geometric_embedding_bwd_plain(d_emb, points, knn_points, wd, bd, wa, ba, sigma_d,
                                  sigma_a, row_block=128):
    """Plain version of K10: the gradient of :func:`geometric_embedding_plain`
    with respect to (wd, bd, wa, ba) for the cotangent d_emb (B, N, N, C).

    Accumulated in basis space, ``dGd = sum T_d^T d_emb``, ``dGa = sum_k
    T_a(k)^T (d_emb * first_argmax_k)``, ``db = sum d_emb``, then ``d_wd =
    A_d^T dGd``, ``d_wa = A_a^T dGa`` and ``d_bd = d_ba = db``.  The angle
    max is routed to the FIRST k attaining it, as the JAX package's VJP
    routes it; ``torch.amax``'s own backward would split ties instead.

    bf16 d_emb: the TPU kernel's chain, which the tc form runs: the
    projections recomputed as the forward's bf16 chain and compared before
    the bias (the forward adds it after the max), the bases rounded to bf16
    before the products, float32 sums.  float32: the first design's, nothing
    rounded, the projections compared with the bias added.
    Returns float32 (d_wd, d_bd, d_wa, d_ba)."""
    b, n, _ = points.shape
    deg_d, deg_a, _, ga = _folded_projections(wd, wa, sigma_a)
    inv_d = 2.0 / (D_INDEX_MAX * sigma_d)
    inv_a = 2.0 / math.pi
    dtype = d_emb.dtype
    bias = 0.0 if dtype == torch.bfloat16 else ba.float()
    points = points.float()
    dist = torch.sqrt(pairwise_distance(points, points))
    c = wd.shape[1]
    dgd = torch.zeros((deg_d, c), dtype=torch.float32, device=points.device)
    dga = torch.zeros((deg_a, c), dtype=torch.float32, device=points.device)
    db = torch.zeros((c,), dtype=torch.float32, device=points.device)
    for r0 in range(0, n, row_block):
        r1 = min(n, r0 + row_block)
        g = d_emb[:, r0:r1].float()  # (B, R, N, C)
        ang = _pair_geometry(points, knn_points, r0, r1)
        first = torch.argmax(_cheb_project(ang, inv_a, ga, bias, dtype), dim=3)  # (B, R, N, C)
        basis_a = _rnd(_cheb_basis(ang, inv_a, deg_a), dtype)  # (B, R, N, k, deg_a)
        basis_d = _rnd(_cheb_basis(dist[:, r0:r1], inv_d, deg_d), dtype)
        dgd += torch.einsum("brnj,brnc->jc", basis_d, g)
        for kk in range(ang.shape[3]):
            dga += torch.einsum("brnj,brnc->jc", basis_a[:, :, :, kk], g * (first == kk))
        db += g.sum(dim=(0, 1, 2))
    return _basis_to_weights(dgd, dga, db, wd, sigma_a)


def _basis_to_weights(dgd, dga, db, wd, sigma_a):
    """Basis-space gradients -> (d_wd, d_bd, d_wa, d_ba)."""
    c = wd.shape[1]
    x_max_a = math.pi * (180.0 / (sigma_a * math.pi))
    a_d = _fit_table(c, D_INDEX_MAX, dgd.shape[0], dgd.device)
    a_a = _fit_table(c, float(x_max_a), dga.shape[0], dga.device)
    # d_ba is a copy: two parameters' .grad must not share storage
    return a_d.T @ dgd, db, a_a.T @ dga, db.clone()


def _geometric_embedding_forward(points, knn_points, wd, bd, wa, ba, sigma_d, sigma_a,
                                 out_dtype):
    if points.device.type == "cpu":
        return geometric_embedding_plain(points, knn_points, wd, bd, wa, ba,
                                         sigma_d, sigma_a, out_dtype=out_dtype)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"unsupported output dtype {out_dtype}")
    b, n, _ = points.shape
    k = knn_points.shape[2]
    c = wd.shape[1]
    if knn_points.shape != (b, n, k, 3) or wd.shape != (c, c) or wa.shape != (c, c):
        raise ValueError("bad embedding input shapes")
    deg_d, deg_a, gd, ga = _folded_projections(wd, wa, sigma_a)
    points = points.float().contiguous()
    knn_points = knn_points.float().contiguous()
    bd, ba = bd.float().contiguous(), ba.float().contiguous()
    out = torch.empty((b, n, n, c), dtype=out_dtype, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    scalars = (b, n, c, deg_d, deg_a, k, 2.0 / (D_INDEX_MAX * sigma_d), 2.0 / math.pi, stream)
    if out_dtype == torch.bfloat16:
        gt = tc_table(gd, ga)
        fn = _build.function("geometric_embedding", "se3et_geometric_embedding_bf16", 6, 6, 2)
        status = fn(points.data_ptr(), knn_points.data_ptr(), gt.data_ptr(), bd.data_ptr(),
                    ba.data_ptr(), out.data_ptr(), *scalars)
    else:
        gd, ga = gd.contiguous(), ga.contiguous()
        fn = _build.function("geometric_embedding", "se3et_geometric_embedding_f32", 7, 6, 2)
        status = fn(points.data_ptr(), knn_points.data_ptr(), gd.data_ptr(), bd.data_ptr(),
                    ga.data_ptr(), ba.data_ptr(), out.data_ptr(), *scalars)
    _build.check(status, "geometric_embedding launch")
    geometric_embedding.launches += 1
    return out


class _GeometricEmbedding(torch.autograd.Function):
    """K3 forward, K10 backward (projection parameters only)."""

    @staticmethod
    def forward(ctx, points, knn_points, wd, bd, wa, ba, sigma_d, sigma_a, out_dtype):
        ctx.save_for_backward(points, knn_points, wd, bd, wa, ba)
        ctx.sigmas = (sigma_d, sigma_a)
        return _geometric_embedding_forward(points, knn_points, wd, bd, wa, ba, sigma_d,
                                            sigma_a, out_dtype)

    @staticmethod
    def backward(ctx, d_emb):
        grads = geometric_embedding_bwd(d_emb, *ctx.saved_tensors, *ctx.sigmas)
        return (None, None, *grads, None, None, None)


def geometric_embedding(points, knn_points, wd, bd, wa, ba, sigma_d, sigma_a,
                        out_dtype=torch.bfloat16):
    """K3 (``csrc/geometric_embedding.cu``, replaces the TPU
    ``geometric_embedding_pallas``): see :func:`geometric_embedding_plain`.
    bf16: the projections on the tensor cores, bound by the output's write;
    float32: on the CUDA cores, bound by their FMA rate.  The source notes
    the design.
    Differentiable in (wd, bd, wa, ba), backward K10
    (:func:`geometric_embedding_bwd`)."""
    if points.requires_grad or knn_points.requires_grad:
        raise ValueError("geometric_embedding: points are geometry and take no gradient")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (wd, bd, wa, ba)):
        return _GeometricEmbedding.apply(points, knn_points, wd, bd, wa, ba, sigma_d,
                                         sigma_a, out_dtype)
    return _geometric_embedding_forward(points, knn_points, wd, bd, wa, ba, sigma_d,
                                        sigma_a, out_dtype)


geometric_embedding.launches = 0


def geometric_embedding_bwd_form(c: int, dtype, deg_d: int = 40, deg_a: int = 16,
                                 k: int = 3) -> str:
    """Which hand-written kernel takes K10 at embedding width ``c`` for a
    cotangent of ``dtype`` with (deg_d, deg_a) basis terms and ``k`` angle
    neighbours:

    * "tc": bf16 at C in :data:`BWD_TC_WIDTHS` (training's embedding), the
      tensor-core form (``csrc/embedding_bwd_tc.cuh``);
    * "cuda": the first design (float32, and bf16 at other widths).

    Chosen by shape alone, as the C entry points check; neither is a
    fallback of the other.  Raises ``ValueError`` where no kernel takes the
    shape."""
    if (dtype not in _DTYPES or (deg_d, deg_a, k) != BWD_BASES or not 1 <= c <= 1024
            or (dtype == torch.bfloat16 and c % 16)):
        raise ValueError(f"no K10 kernel for C={c}, {dtype}, bases ({deg_d}, {deg_a}), "
                         f"k={k}: built for bases {BWD_BASES[:2]}, k={BWD_BASES[2]}, C <= 1024 "
                         f"(bf16: C % 16 == 0), bf16 or float32")
    return "tc" if dtype == torch.bfloat16 and c in BWD_TC_WIDTHS else "cuda"


def geometric_embedding_bwd(d_emb, points, knn_points, wd, bd, wa, ba, sigma_d, sigma_a):
    """K10 (``csrc/geometric_embedding.cu``, replaces the TPU
    ``_emb_bwd_call``): see :func:`geometric_embedding_bwd_plain`; d_emb in
    bf16 or float32, on the form :func:`geometric_embedding_bwd_form` names.
    The kernel's partial sums (per persistent block in the tc form, per
    query row in the first design) are added by ``torch.sum`` in a fixed
    order; ``d_W = A^T dG`` stays a matmul, as in the JAX package.  Bound
    by one read of d_emb; the sources note the designs."""
    return _geometric_embedding_bwd(d_emb, points, knn_points, wd, bd, wa, ba, sigma_d,
                                    sigma_a)


def _geometric_embedding_bwd(d_emb, points, knn_points, wd, bd, wa, ba, sigma_d, sigma_a,
                             form=None):
    """K10 on the form :func:`geometric_embedding_bwd_form` names, or on
    ``form`` where the caller asks for one ("cuda" takes every shape the
    form check lets through)."""
    if points.device.type == "cpu":
        return geometric_embedding_bwd_plain(d_emb, points, knn_points, wd, bd, wa, ba,
                                             sigma_d, sigma_a)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if d_emb.dtype not in _DTYPES:
        raise TypeError(f"unsupported gradient dtype {d_emb.dtype}")
    b, n, _ = points.shape
    k = knn_points.shape[2]
    c = wd.shape[1]
    if d_emb.shape != (b, n, n, c) or knn_points.shape != (b, n, k, 3):
        raise ValueError("bad embedding backward input shapes")
    deg_d, deg_a, gd, ga = _folded_projections(wd, wa, sigma_a)
    chosen = geometric_embedding_bwd_form(c, d_emb.dtype, deg_d, deg_a, k)
    form = form or chosen
    if form == "tc" and chosen != "tc":
        raise ValueError(f"K10's tc form does not take C={c} in {d_emb.dtype}")
    points = points.float().contiguous()
    knn_points = knn_points.float().contiguous()
    d_emb = d_emb.contiguous()
    inv = (2.0 / (D_INDEX_MAX * sigma_d), 2.0 / math.pi)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    if form == "tc":
        if d_emb.data_ptr() % 16:
            raise ValueError("K10's tc form reads d_emb in 16-byte units: misaligned tensor")
        # one persistent block an SM over the (query row, key tile) tiles
        blocks = min(torch.cuda.get_device_properties(points.device).multi_processor_count,
                     b * n * -(-n // BWD_TC_KEYS))
        part = torch.empty((blocks, BWD_PARTS, c), dtype=torch.float32, device=points.device)
        gt = tc_table(gd, ga)
        fn = _build.function("geometric_embedding", "se3et_geometric_embedding_bwd_tc", 5, 7, 2)
        status = fn(points.data_ptr(), knn_points.data_ptr(), gt.data_ptr(), d_emb.data_ptr(),
                    part.data_ptr(), b, n, c, blocks, deg_d, deg_a, k, *inv, stream)
    else:
        ga, ba = ga.contiguous(), ba.float().contiguous()
        part = torch.empty((b * n, BWD_PARTS, c), dtype=torch.float32, device=points.device)
        scalars = (b, n, c, deg_d, deg_a, k, *inv, stream)
        if d_emb.dtype == torch.bfloat16:
            # the argmax over the forward's tensor-core projections
            gt = tc_table(gd, ga)
            fn = _build.function("geometric_embedding", "se3et_geometric_embedding_bwd_bf16",
                                 7, 6, 2)
            status = fn(points.data_ptr(), knn_points.data_ptr(), ga.data_ptr(), ba.data_ptr(),
                        gt.data_ptr(), d_emb.data_ptr(), part.data_ptr(), *scalars)
        else:
            fn = _build.function("geometric_embedding", "se3et_geometric_embedding_bwd_f32", 6,
                                 6, 2)
            status = fn(points.data_ptr(), knn_points.data_ptr(), ga.data_ptr(), ba.data_ptr(),
                        d_emb.data_ptr(), part.data_ptr(), *scalars)
    _build.check(status, f"geometric_embedding_bwd launch ({form})")
    geometric_embedding_bwd.launches += 1
    tot = part.sum(dim=0)
    return _basis_to_weights(tot[:deg_d], tot[deg_d:deg_d + deg_a], tot[deg_d + deg_a], wd,
                             sigma_a)


geometric_embedding_bwd.launches = 0
