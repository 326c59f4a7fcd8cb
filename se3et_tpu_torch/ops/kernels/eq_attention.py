r"""Flash equivariant cross-attention kernels (K6 stats, K7 apply).

Counterparts of ``se3et_tpu/ops/pallas/eq_attention.py``
(``eq_attention_stats``, ``eq_attention_apply``).  The EQ cross attention
scores every (query anchor a, key anchor e) pair, ``s_ae = scale q_a . k_e``
of shape (A, E, H, N, M); these two passes never materialise it:

* **stats** (K6): per (a, e, h, n) the softmax row max and sum-exp of the
  key-masked scores, the masked mean over valid (n, m) of
  ``_positive(head-mean s)`` -> ``attn_ae (A, E)``, and optionally the
  masked max of the head-mean of ``s * sup_q[a,h] * sup_k[e,h]`` (the
  rotation-supervision matrix);
* the tiny (A, E) weight math stays in plain torch (``nn/attention.py``);
* **apply** (K7): ``hidden[a] = sum_e w[a,e] softmax_m(s_ae) @ v_e`` with
  the stats of K6, the scores recomputed.

Both kernels live in ``csrc/eq_attention.cu``; its source notes the design.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from se3et_tpu_torch.ops.kernels import _build

_NEG = -1e9
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
POSITIVE_MODES = (None, "sq", "abs", "relu", "sigmoid", "leakyrelu", "softplus", "minus")
KERNEL_HEADS = (4,)
KERNEL_HEAD_DIMS = (16, 64)
# K6 writes one pooled partial per block; slots are sized for the smallest
# block (8 query rows, the CUDA-core kernels), the tensor-core kernel
# (64 rows) fills the first of them
ROWS_PER_BLOCK = 8


def _positive(x, mode: Optional[str]):
    """Non-negativity transforms of the global anchor/rotation attention."""
    if mode is None:
        return x
    if mode == "sq":
        return x * x
    if mode == "abs":
        return x.abs()
    if mode == "relu":
        return F.relu(x)
    if mode == "sigmoid":
        return torch.sigmoid(x)
    if mode == "leakyrelu":
        return F.leaky_relu(x, 0.1)
    if mode == "softplus":
        return F.softplus(x)
    if mode == "minus":
        return (x + 1.0) / 2.0
    raise ValueError(mode)


def _scores(q, k):
    """scale * q_a . k_e in float32: (A, E, H, N, M)."""
    return torch.einsum("ahnc,ehmc->aehnm", q.float(), k.float()) / math.sqrt(q.shape[-1])


def eq_attention_stats_plain(q, k, q_masks, k_masks, sup_q=None, sup_k=None, *,
                             positive="sq"):
    """Plain version of K6.

    q: (A, H, N, c); k: (E, H, M, c); masks (N,), (M,) bool (True = valid);
    sup_q (A, H), sup_k (E, H) float32 or None.  Returns (rowmax (A,E,H,N),
    rowsum (A,E,H,N), attn_ae (A,E)[, sup (A,E)]), all float32.
    """
    s = _scores(q, k)
    km = k_masks[None, None, None, None, :]
    sm = s.masked_fill(~km, _NEG)
    rowmax = sm.amax(dim=-1)
    rowsum = (torch.exp(sm - rowmax[..., None]) * km).sum(dim=-1)
    h = q.shape[1]
    pair = (q_masks[:, None] & k_masks[None, :])  # (N, M)
    g = _positive(s.sum(dim=2) * (1.0 / h), positive) * pair
    counts = q_masks.sum().float() * k_masks.sum().float()
    attn_ae = g.sum(dim=(-2, -1)) / (counts + 1e-9)
    if sup_q is None:
        return rowmax, rowsum, attn_ae
    w = sup_q.float().reshape(sup_q.shape[0], 1, h, 1, 1) * sup_k.float().reshape(
        1, sup_k.shape[0], h, 1, 1)
    sup = ((s * w).sum(dim=2) * (1.0 / h)).masked_fill(~pair, _NEG)
    return rowmax, rowsum, attn_ae, sup.amax(dim=(-2, -1))


def eq_attention_apply_plain(q, k, v, w_ae, rowmax, rowsum, k_masks):
    """Plain version of K7: ``hidden[a] = sum_e w_ae[a,e] softmax_m(s_ae) @
    v[e]`` with the row statistics of :func:`eq_attention_stats_plain`.
    q: (A, H, N, c); k, v: (E, H, M, c); w_ae (A, E).  Returns (A, H, N, c)
    float32."""
    km = k_masks[None, None, None, None, :]
    s = _scores(q, k).masked_fill(~km, _NEG)
    p = (torch.exp(s - rowmax[..., None]) * km).to(v.dtype).float()
    o = torch.einsum("aehnm,ehmc->aehnc", p, v.float())
    wi = w_ae.float()[:, :, None, None] / rowsum.clamp_min(1e-30)  # (A, E, H, N)
    return torch.einsum("aehn,aehnc->ahnc", wi, o)


def _check_qk(q, k):
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise TypeError("q and k must share one dtype, bf16 or float32")
    a, h, n, c = q.shape
    if k.ndim != 4 or k.shape[1] != h or k.shape[3] != c:
        raise ValueError("bad q/k shapes")
    if h not in KERNEL_HEADS or c not in KERNEL_HEAD_DIMS:
        raise ValueError(f"K6/K7 are built for H in {KERNEL_HEADS} and head width in "
                         f"{KERNEL_HEAD_DIMS}, got {h}, {c}")


def eq_attention_stats(q, k, q_masks, k_masks, sup_q=None, sup_k=None, *,
                       positive="sq"):
    """K6 (``csrc/eq_attention.cu``, replaces the TPU ``eq_attention_stats``):
    see :func:`eq_attention_stats_plain`.  Per-block partial sums are
    reduced here, in a fixed order (no atomics)."""
    if q.device.type == "cpu":
        return eq_attention_stats_plain(q, k, q_masks, k_masks, sup_q, sup_k,
                                        positive=positive)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_qk(q, k)
    if positive not in POSITIVE_MODES:
        raise ValueError(positive)
    a, h, n, c = q.shape
    e, _, m, _ = k.shape
    with_sup = sup_q is not None
    if with_sup:
        sup_q = sup_q.float().reshape(a, h).contiguous()
        sup_k = sup_k.float().reshape(e, h).contiguous()
    q, k = q.contiguous(), k.contiguous()
    qm = q_masks.to(torch.uint8).contiguous()
    km = k_masks.to(torch.uint8).contiguous()
    nblk = -(-n // ROWS_PER_BLOCK)
    dev = q.device
    rowmax = torch.empty((a, e, h, n), dtype=torch.float32, device=dev)
    rowsum = torch.empty_like(rowmax)
    # per-block partials; a kernel with larger blocks fills fewer slots
    gpart = torch.zeros((a, e, nblk), dtype=torch.float32, device=dev)
    spart = torch.full_like(gpart, _NEG)
    fn = _build.function("eq_attention", f"se3et_eq_attention_stats_{_DTYPES[q.dtype]}",
                         10, 7)
    _build.check(fn(q.data_ptr(), k.data_ptr(), qm.data_ptr(), km.data_ptr(),
                    sup_q.data_ptr() if with_sup else None,
                    sup_k.data_ptr() if with_sup else None, rowmax.data_ptr(),
                    rowsum.data_ptr(), gpart.data_ptr(), spart.data_ptr(),
                    a, e, h, n, m, c, POSITIVE_MODES.index(positive),
                    torch.cuda.current_stream(dev).cuda_stream),
                 "eq_attention_stats launch")
    eq_attention_stats.launches += 1
    counts = q_masks.sum().float() * k_masks.sum().float()
    attn_ae = gpart.sum(dim=-1) / (counts + 1e-9)
    if with_sup:
        return rowmax, rowsum, attn_ae, spart.amax(dim=-1)
    return rowmax, rowsum, attn_ae


def eq_attention_apply(q, k, v, w_ae, rowmax, rowsum, k_masks):
    """K7 (``csrc/eq_attention.cu``, replaces the TPU ``eq_attention_apply``):
    see :func:`eq_attention_apply_plain`."""
    if q.device.type == "cpu":
        return eq_attention_apply_plain(q, k, v, w_ae, rowmax, rowsum, k_masks)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_qk(q, k)
    a, h, n, c = q.shape
    e, _, m, _ = k.shape
    if v.shape != k.shape or v.dtype != q.dtype:
        raise ValueError("v must match k in shape and q in dtype")
    if w_ae.shape != (a, e) or rowmax.shape != (a, e, h, n) or rowsum.shape != (a, e, h, n):
        raise ValueError("bad weight or row-statistics shapes")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    w = w_ae.float().contiguous()
    rowmax, rowsum = rowmax.float().contiguous(), rowsum.float().contiguous()
    km = k_masks.to(torch.uint8).contiguous()
    out = torch.empty((a, h, n, c), dtype=torch.float32, device=q.device)
    fn = _build.function("eq_attention", f"se3et_eq_attention_apply_{_DTYPES[q.dtype]}",
                         8, 6)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    rowmax.data_ptr(), rowsum.data_ptr(), km.data_ptr(), out.data_ptr(),
                    a, e, h, n, m, c, torch.cuda.current_stream(q.device).cuda_stream),
                 "eq_attention_apply launch")
    eq_attention_apply.launches += 1
    return out


eq_attention_stats.launches = 0
eq_attention_apply.launches = 0
