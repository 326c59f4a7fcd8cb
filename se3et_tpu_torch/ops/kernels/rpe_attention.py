r"""Flash RPE self-attention kernel (K5).

Counterpart of ``se3et_tpu/ops/pallas/rpe_attention.py``
(``rpe_self_attention`` -> ``_rpe_fwd``).  One softmax attention over the
coarse stage with the geometric embedding's positional term and,
optionally, the degree-1 spherical-harmonics term of the equivariant
layers, without materialising the (B, AH, N, M) scores:

    s[b, ah, n, m] = scale * (q[b,ah,n] . k[b,ah,m]
                              + qp[b,n,ah] . emb[b,n,m]
                              + rinv(n, m) * qw[b,:,ah,n] . (p_n - p_m)_yzx)
    out[b, ah, n]  = sum_m softmax_m(s) v[b, ah, m]

Every projection is folded into the query outside (``qp = q @ Wp^T``; the
anchors' Wigner-D blocks into ``qw``, :func:`fold_equivariant_query`), and
row-constant terms (projection biases, the degree-0 SH term) are left out:
a per-query constant is a softmax no-op.  ``rinv = sqrt(3/4pi) / (r +
1e-12)`` with ``r = |p_n - p_m|``, set to 0 where ``n == m`` by index.
Keys with ``k_masks`` False are masked before the exp, and the softmax
weights are cast to ``v``'s dtype before the value product, as the TPU
kernel does.  The kernel (``csrc/rpe_attention.cu``) reads each embedding
row once for all anchor-heads; its source notes the design.
"""

from __future__ import annotations

import math

import torch

from se3et_tpu_torch.ops.kernels import _build

_NEG = -1e9
SH1_C = math.sqrt(3.0 / (4.0 * math.pi))  # real_sh degree-1 coefficient
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
KERNEL_AH = (4, 24)  # anchor-heads per launch the kernel is built for
KERNEL_HEAD_DIMS = (16, 64)


def fold_equivariant_query(qe: torch.Tensor, wigner_d1: torch.Tensor) -> torch.Tensor:
    """Fold the anchors' Wigner-D degree-1 blocks into the SH query.

    qe: (B, A, H, N, 4) -- ``q @ We^T`` for n_level_equiv=2 (column 0, the
    degree-0 coefficient, is dropped as row-constant); wigner_d1 (A, 3, 3).
    Returns (B, 3, A*H, N) float32, component rows in the (y, z, x) order of
    the degree-1 ``real_sh`` layout."""
    b, a, h, n, _ = qe.shape
    qw = torch.einsum("acd,bahnc->bdahn", wigner_d1.float(), qe[..., 1:4].float())
    return qw.reshape(b, 3, a * h, n)


def point_rows(points: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points -> the (B, 3, N) float32 coordinate rows (x, y, z)
    the kernel reads."""
    return points.float().transpose(1, 2).contiguous()


def sh_term(qw, points, n0, n1):
    """rinv(n, m) * qw . (p_n - p_m)_yzx for query rows n0:n1: (B, AH, R, N)."""
    p = points[:, :3].float()  # (B, 3, N) rows x, y, z
    d = p[:, :, n0:n1, None] - p[:, :, None, :]  # (B, 3, R, N): p_n - p_m
    r = torch.sqrt((d * d).sum(dim=1))  # (B, R, N)
    rinv = SH1_C / (r + 1e-12)
    idx = torch.arange(n0, n1, device=p.device)
    rinv[:, idx - n0, idx] = 0.0
    dyzx = d[:, (1, 2, 0)]
    pre = torch.einsum("bdan,bdnm->banm", qw[..., n0:n1].float(), dyzx)
    return rinv[:, None] * pre


def rpe_self_attention_plain(q, k, v, qp, emb, k_masks, qw=None, points=None, *,
                             scale, row_block=128):
    """Plain version of K5, in float32 from the given inputs.

    q, k, v: (B, AH, N, c); qp: (B, N, AH, C); emb: (B, N, N, C);
    k_masks: (B, N) bool (True = valid key); qw: (B, 3, AH, N) or None;
    points: (B, 3|4, N) coordinate rows, needed with ``qw``.
    Returns (B, AH, N, c) float32.  Query rows are taken ``row_block`` at a
    time to bound the float32 copies of the embedding.
    """
    b, ah, n, c = q.shape
    kf, vf = k.float(), v.float()
    km = k_masks[:, None, None, :]
    out = torch.empty((b, ah, n, c), dtype=torch.float32, device=q.device)
    for n0 in range(0, n, row_block):
        n1 = min(n, n0 + row_block)
        s = torch.einsum("banc,bamc->banm", q[:, :, n0:n1].float(), kf)
        s = s + torch.einsum("bnad,bnmd->banm", qp[:, n0:n1].float(),
                             emb[:, n0:n1].float())
        if qw is not None:
            s = s + sh_term(qw, points, n0, n1)
        s = torch.where(km, s * scale, _NEG)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * km
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        pv = torch.einsum("banm,bamc->banc", p.to(v.dtype).float(), vf)
        out[:, :, n0:n1] = pv / denom
    return out


def rpe_self_attention(q, k, v, qp, emb, k_masks, qw=None, points=None, *, scale):
    """K5 (``csrc/rpe_attention.cu``, replaces the TPU ``rpe_self_attention``):
    see :func:`rpe_self_attention_plain`.  Bound by the embedding's bytes;
    the source notes the design."""
    if q.device.type == "cpu":
        return rpe_self_attention_plain(q, k, v, qp, emb, k_masks, qw, points, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, ah, n, c = q.shape
    cc = emb.shape[-1]
    dtype = q.dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in (k, v, qp, emb)):
        raise TypeError("q, k, v, qp and emb must share one dtype, bf16 or float32")
    if (k.shape != q.shape or v.shape != q.shape or qp.shape != (b, n, ah, cc)
            or emb.shape != (b, n, n, cc) or k_masks.shape != (b, n)):
        raise ValueError("bad rpe_self_attention input shapes")
    if ah not in KERNEL_AH or c not in KERNEL_HEAD_DIMS or cc % 16:
        raise ValueError(f"K5 is built for AH in {KERNEL_AH}, head width in "
                         f"{KERNEL_HEAD_DIMS} and C % 16 == 0, got {ah}, {c}, {cc}")
    with_sh = qw is not None
    if with_sh:
        if qw.shape != (b, 3, ah, n) or points is None or points.shape[:1] != (b,) \
                or points.shape[1] not in (3, 4) or points.shape[2] != n:
            raise ValueError("qw must be (B, 3, AH, N) with points (B, 3|4, N)")
        qw = qw.float().contiguous()
        points = points.float().contiguous()
    q, k, v, qp, emb = (t.contiguous() for t in (q, k, v, qp, emb))
    km = k_masks.to(torch.uint8).contiguous()
    out = torch.empty((b, ah, n, c), dtype=torch.float32, device=q.device)
    fn = _build.function("rpe_attention", f"se3et_rpe_attention_{_DTYPES[dtype]}", 9, 6, 1)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), emb.data_ptr(),
                    km.data_ptr(), qw.data_ptr() if with_sh else None,
                    points.data_ptr() if with_sh else None, out.data_ptr(),
                    b, ah, n, c, cc, points.shape[1] if with_sh else 0, float(scale),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "rpe_self_attention launch")
    rpe_self_attention.launches += 1
    return out


rpe_self_attention.launches = 0
